"""End-to-end driver: decentralized training of a small LM.

The port of the JAX package's ``examples/train_lm.py``: a granite-family
model (``--big``: 8 layers, d 768, ~100M parameters; default 4 layers, d
256, ~10M) trained with DCD-PSGD over ``quant:8`` on 8 gossip nodes,
synthetic Markov data, AdamW, through ``run_training``.  From 150 steps on,
the final loss must fall below 0.9 of the uniform-vocab entropy.  On the GPU
unless ``--device cpu``:

    python -m repro_torch.examples.train_lm [--steps 300] [--algo dcd] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch.configs import get_config
from repro_torch.launch.train import TrainConfig, run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--algo", default="dcd", choices=["cpsgd", "dpsgd", "naive", "dcd", "ecd"])
    ap.add_argument("--wire", default="quant:8",
                    help="gossip wire-format spec, e.g. quant:4, sparse:0.25:topk, fp16")
    ap.add_argument("--topology", default="ring",
                    help="gossip plan name: ring, chain, torus, torus2d, star, full")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (default: ~10M for a fast CPU run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("granite-3-2b")
    if args.big:
        cfg = dataclasses.replace(base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
                                  d_ff=3072, vocab=32000, head_dim=64)
    else:
        cfg = dataclasses.replace(base, n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                                  d_ff=1024, vocab=512, head_dim=32)
    tc = TrainConfig(algo=args.algo, wire=args.wire, topology=args.topology,
                     n_nodes=args.nodes, seq_len=128, global_batch=args.nodes * 4,
                     steps=args.steps, lr=1e-3, warmup=20, optimizer="adamw",
                     ckpt_dir=args.ckpt_dir, reduced=False)
    hist = run_training(cfg, tc, device=args.device)
    uniform = math.log(cfg.vocab)
    print(f"\nfinal loss {hist['final_loss']:.3f} vs uniform {uniform:.3f} "
          f"({hist['wall_s']:.0f}s)")
    if args.steps >= 150 and not hist["final_loss"] < 0.9 * uniform:   # short runs: smoke
        raise SystemExit("LM failed to learn")
    return hist


if __name__ == "__main__":
    main()
