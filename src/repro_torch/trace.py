"""Named spans inside the training step, on the profiler's clock.

``span(name)`` marks where a layer of the step does its work: the data
pipeline, the model's forward and backward, inside the forward latent
attention (MLA), the dropless MoE's routing and held experts and each
Mamba2 mixer, the
optimizer, the gossip rounds (mix, encode, decode), each transport call and
the step's metrics.
Tracing is off by default, and then a span costs one read of a module flag
and returns a shared no-op context.  With ``enable(True)`` a span:

* enters ``torch.profiler.record_function(name)``, so an active
  ``torch.profiler`` records it among its host events, on the clock of the
  device events, and the launches made inside it can be attributed to it;
* appends ``(name, step, parent, t0_ns, t1_ns)`` to a list in memory:
  ``time.perf_counter_ns()`` at entry and exit, the step it belongs to and
  the index in that list of the enclosing span (``None`` at a root).

A span never synchronizes and never reads a device tensor on the host; it
writes nothing to disk.  ``collect()`` hands the recorded spans over and
clears them.  Spans open and close on one thread (the training loop's);
launches the autograd engine makes on its own thread during
``model.backward`` fall inside that span's time.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

TRANSPORT_LABELS = ("wire", "dense", "resync", "allreduce", "metric", "checkpoint")
NAMES = ("data.batch", "step", "model.forward", "model.backward", "optim.update",
         "gossip.mix", "gossip.encode", "gossip.decode", "step.metrics", "model.mla",
         "model.moe.route", "model.moe.experts", "model.ssm") + tuple(
    f"transport.{label}" for label in TRANSPORT_LABELS)

Span = Tuple[str, Optional[int], Optional[int], int, int]

_on = False
_spans: List[list] = []     # [name, step, parent, t0_ns, t1_ns]; t1 None while open
_open: List[int] = []       # indices of the open spans, innermost last
_step: Optional[int] = None
_OFF = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn tracing on or off (off by default)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "step", "index", "rf")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step

    def __enter__(self):
        global _step
        if self.step is not None:
            _step = self.step
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.index = len(_spans)
        _spans.append([self.name, _step, _open[-1] if _open else None,
                       time.perf_counter_ns(), None])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _spans[self.index][4] = time.perf_counter_ns()
        _open.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None):
    """The span ``name``; ``step`` (the step counter) is recorded for it and
    every later span until another span gives one."""
    if not _on:
        return _OFF
    return _Span(name, step)


def collect() -> List[Span]:
    """The closed spans recorded so far, in the order they opened, and
    clear them; the indices of parents refer to this list."""
    global _spans
    if _open:
        raise RuntimeError(f"collect() inside the open span {_spans[_open[-1]][0]!r}")
    out = [tuple(s) for s in _spans]
    _spans = []
    return out


def seconds_by_name(spans: List[Span], prefix: str = "") -> Dict[str, float]:
    """Host seconds of the spans whose name starts with ``prefix``, summed by
    name with ``prefix`` dropped (no span opens inside one of its own name)."""
    out: Dict[str, float] = {}
    for name, _, _, t0, t1 in spans:
        if name.startswith(prefix):
            key = name[len(prefix):]
            out[key] = out.get(key, 0.0) + (t1 - t0) / 1e9
    return out
