"""The comparison that decides a training cell's ``correct``.

Both sides hand in a record of the same first steps (see
:mod:`bench.reference.train`): the batches, each step's loss, the first
gradient's norm and the parameters' change after the last step, each per
leaf, and the bytes handed to the network.  The numbers compared:

* ``token_mismatches``: tokens and labels that differ, over every step
  (exact);
* ``sent_bytes_gap``: the difference of the bytes handed to the network
  (exact);
* ``loss_gap``: the largest ``|loss - loss_ref| / loss_ref`` over the steps;
* ``grad_norm_gap`` and ``change_norm_gap``: over the leaves, the largest
  ``| ||a|| - ||a_ref|| |``, over the larger of the leaf's ``||a_ref||`` and
  the median leaf's.  The change leaves out a leaf whose reference gradient
  is under a thousandth of the median leaf's: such a leaf moves by rounding
  alone.

A number is met when it is at most its limit; ``correct`` when all are.
"""
from __future__ import annotations

import statistics

NUMBERS = ("token_mismatches", "sent_bytes_gap", "loss_gap", "grad_norm_gap",
           "change_norm_gap")
FLAT_GRADIENT = 1e-3


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """``{leaf: | ||a|| - ||a_ref|| | / max(||a_ref||, median leaf's)}``."""
    floor = statistics.median(want[p] for p in want)
    return {p: abs(got[p] - want[p]) / max(want[p], floor)
            for p in want if keep is None or p in keep}


def moving_leaves(want: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    grads = want["grad_norms"]
    floor = statistics.median(grads.values())
    return {p for p, g in grads.items() if g >= FLAT_GRADIENT * floor}


def numbers(got: dict, want: dict) -> dict:
    """Each compared number of the record ``got`` against ``want``."""
    mismatches = sum(int((a != b).sum()) for key in ("tokens", "labels")
                     for a, b in zip(got[key], want[key]))
    if len(got["tokens"]) != len(want["tokens"]):
        mismatches += 1
    return {
        "token_mismatches": mismatches,
        "sent_bytes_gap": abs(int(got["sent_bytes"]) - int(want["sent_bytes"])),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "grad_norm_gap": max(leaf_gaps(got["grad_norms"], want["grad_norms"]).values()),
        "change_norm_gap": max(leaf_gaps(got["change_norms"], want["change_norms"],
                                         moving_leaves(want)).values()),
    }


def verdict(found: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``; a number that is not finite
    fails."""
    checks = {k: {"value": found[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
