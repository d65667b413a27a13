"""Faults planted under the timed path, to show that the comparison fails
them: each is a context manager that breaks one layer of the program for
the runs made inside it.

* ``unchanged``: the step returns its state as it found it (losses still
  computed);
* ``half_batch``: each node's loss over half of its batch (the first half of
  its rows, or of its positions where it holds one row), the mean taken
  over that half;
* ``no_exchange``: the gossip exchange hands every node its own payload
  instead of its neighbours';
* ``token_altered``: one token of each batch changed where the data
  pipeline makes it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import transport
from repro_torch.models import lm
from repro_torch.tree import leaf_items, tree_from_items

from bench import harness


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged():
    real = harness.make_dist_train_step

    def make(loss_fn, *args, **kwargs):
        inner = real(loss_fn, *args, **kwargs)

        def step(state, batch):
            with torch.no_grad():
                items = leaf_items(state.params)
                losses = [loss_fn(tree_from_items([(p, leaf[i]) for p, leaf in items]),
                                  {k: v[i] for k, v in batch.items()})[0]
                          for i in range(batch["tokens"].shape[0])]
            return state, {"loss": torch.stack(losses).mean()}

        step.transport = inner.transport
        return step

    return _patched(harness, "make_dist_train_step", make)


def half_batch():
    real = lm.lm_loss

    def loss(cfg, params, batch, remat=False):
        rows = batch["tokens"].shape[0]
        if rows > 1:
            half = {k: v[: rows // 2] for k, v in batch.items()}
        else:
            cols = batch["tokens"].shape[1] // 2
            half = {k: v[:, :cols] for k, v in batch.items()}
        return real(cfg, params, half, remat)

    return _patched(lm, "lm_loss", loss)


@contextlib.contextmanager
def no_exchange():
    real = transport.StackedTransport.exchange

    def stacked(self, payload, shifts, masks=None, *, label="wire", refuse=frozenset()):
        real(self, payload, shifts, masks, label=label, refuse=refuse)
        return transport.Lazy(lambda s: payload)

    def ranks(self, payload, shifts, masks=None, *, label="wire", refuse=frozenset()):
        return {s: payload for s in shifts}

    with _patched(transport.StackedTransport, "exchange", stacked), \
            _patched(transport.RankTransport, "exchange", ranks):
        yield


@contextlib.contextmanager
def token_altered():
    stacked, one = harness.stacked_node_batches, harness.sample_batch

    def alter(out, vocab):
        tokens = out["tokens"]
        tokens.view(-1)[0] = (tokens.view(-1)[0] + 1) % vocab
        return out

    def batches(dc, step, arch=None, *, device="cuda"):
        return alter(stacked(dc, step, arch, device=device), dc.vocab)

    def batch(dc, step, shard, arch=None, *, device="cuda"):
        return alter(one(dc, step, shard, arch, device=device), dc.vocab)

    with _patched(harness, "stacked_node_batches", batches), \
            _patched(harness, "sample_batch", batch):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange,
          "token_altered": token_altered}
