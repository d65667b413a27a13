"""Serving example: batched prefill and decode with KV caches.

The port of the JAX package's ``examples/serve_lm.py``: a reduced granite
model prefills a batch of prompts one position a step through
``Model.decode_step``, then decodes continuations at temperature 0.8 from
the cache, once with the full cache and once with a sliding-window ring
buffer.  Sampling draws from a ``torch.Generator``, so the tokens differ
from the JAX package's.  On the GPU unless ``--device cpu``:

    python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import _categorical
from repro_torch.models.api import build_model


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, steps: int, gen: torch.Generator,
             window: Optional[int] = None) -> torch.Tensor:
    """Prefill ``prompts`` (B, P) through the decode step, then ``steps``
    tokens: the greedy first, the rest sampled.  Returns (B, steps)."""
    B, P = prompts.shape
    caches = model.init_cache(B, P + steps, window=window, device=prompts.device)
    logits = None
    for t in range(P):      # prefill by teacher forcing the prompt
        logits, caches = model.decode_step(params, caches, prompts[:, t:t + 1])
    cur = torch.argmax(logits, dim=-1)
    toks = []
    for _ in range(steps):
        toks.append(cur)
        logits, caches = model.decode_step(params, caches, cur)
        cur = _categorical(gen, logits[:, 0] / 0.8)[:, None]
    return torch.cat(toks, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device=device)
    prompts = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(1)
                            ).to(device)

    def sampler():
        return torch.Generator(device=device).manual_seed(2)

    out_full = generate(model, params, prompts, steps=16, gen=sampler())
    print("full-cache decode:", tuple(out_full.shape), "first row:", out_full[0][:8].tolist())
    out_win = generate(model, params, prompts, steps=16, gen=sampler(), window=16)
    print("ring-buffer decode:", tuple(out_win.shape), "first row:", out_win[0][:8].tolist())
    if not (out_full.shape == out_win.shape == (4, 16)
            and bool(((out_full >= 0) & (out_full < cfg.vocab)).all())):
        raise SystemExit("serving produced tokens of the wrong shape or range")
    print("OK: batched serving with full and sliding-window caches")
    return out_full, out_win


if __name__ == "__main__":
    main()
