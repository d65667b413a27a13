"""Serving driver: a batched request loop over the decode path.

The port of the JAX package's ``launch/serve.py``: request queue -> batch
assembly -> prefill (through the decode step, one prompt position a step) ->
decode until EOS or ``max_new`` tokens -> finished rows emit EOS.  Sampling
runs at temperature 0.8 by Gumbel-max (``jax.random.categorical``'s method)
on an explicit ``torch.Generator``, so the sampled tokens differ from the JAX
package's, which draws from keys.  ``main`` serves the reduced config, as the
JAX driver does, on the GPU unless ``--device cpu``:

    python -m repro_torch.launch.serve --arch granite-3-2b --requests 6
    python -m repro_torch.launch.serve --arch mamba2-370m --device cpu

For an encoder-decoder (whisper) the loop never runs the encoder, so the
cross-attention caches stay zero, as in the JAX driver.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical``: argmax of the logits plus Gumbel noise of
    the logits' dtype, the noise drawn from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(gumbel.to(logits.dtype) + logits, dim=-1)


@torch.no_grad()
def serve_batch(model, params, prompts: torch.Tensor, max_new: int, gen: torch.Generator,
                window: Optional[int] = None, eos: int = 1) -> torch.Tensor:
    """Serve one batch: prompts (B, P) int64 on the params' device -> the
    generated tokens (B, n <= max_new), EOS after a row's first EOS."""
    B, P = prompts.shape
    caches = model.init_cache(B, P + max_new, window=window, device=prompts.device)
    logits = None
    for t in range(P):
        logits, caches = model.decode_step(params, caches, prompts[:, t:t + 1])
    done = torch.zeros((B,), dtype=torch.bool, device=prompts.device)
    cur = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(max_new):
        out.append(torch.where(done[:, None], torch.full_like(cur, eos), cur))
        done = done | (cur[:, 0] == eos)
        logits, caches = model.decode_step(params, caches, cur)
        cur = _categorical(gen, logits[:, 0] / 0.8)[:, None]
        if bool(done.all()):
            break
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    pending = [torch.randint(2, cfg.vocab, (args.prompt_len,), generator=gen, device=device)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    served = 0
    outs = []
    while pending:
        batch = pending[: args.batch]
        pending = pending[args.batch:]
        prompts = torch.stack(batch)
        sampler = torch.Generator(device=device)
        sampler.manual_seed(1)
        out = serve_batch(model, params, prompts, args.max_new, sampler, window=args.window)
        served += len(batch)
        outs.append(out)
        print(f"served batch of {len(batch)}: out shape {tuple(out.shape)}")
    dt = time.perf_counter() - t0
    print(f"{served} requests in {dt:.1f}s "
          f"({served * (args.prompt_len + args.max_new) / dt:.0f} tok/s)")
    return outs


if __name__ == "__main__":
    main()
