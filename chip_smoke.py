#!/usr/bin/env python3
"""The port's table of kernels on one GPU, and the card checks that no card
test and no benchmark cell makes.

    python3 chip_smoke.py

The card tests (``python -m pytest -m cuda tests/test_torch_cuda.py``) hold
each kernel to its plain version at its edges and run the step analyzer's
grid, reduced ranks, the dryrun's smoke and the decode paths on the card;
the benchmark's cells (``bench/run.py``) hold the main path to their
reference.  This script makes the rest in one process, phase by phase (each
phase's docstring says what it asserts); any failure exits non-zero.

1. build: every ``src/repro_torch/kernels/csrc/*.cu`` into
   ``build/repro_torch/``, registers and local bytes logged.
2. kernels: each kernel at the training path's largest fold (``lm_head``;
   receives into f32 and bf16 accumulators), the data's walk at the cells'
   batches and AdamW at granite's largest leaf, checked once against its
   plain version, then timed with CUDA events beside it, its bound
   (``bench.yardstick``; ``markov_bound``), the nearest library call and,
   for a receive, the same-bytes ``torch.mul``.  ``--only
   kernels_sparse,kernels_lowrank`` (any of ``KERNEL_PHASES``) runs just
   those and prints no result: to time two trees' kernels, a process each.
3. train: ``TRAIN_RUNS``, granite-3-2b at full width, depth 1, 8 nodes.
4. stacked: the paper-facing ``repro_torch.core`` path (``stacked_runs``).
5. quickstart: the paper's Fig. 1 at the JAX package's test thresholds.
6. gossip_reference: the runtime against ``GossipReference``, then
   ``compare_compression``'s gated modes; ``--only gossip_reference``.
7. analysis: the step analyzer at full width (``ANALYSIS_FULL_WIDTH``).
8. plans: ``PLAN_RUNS`` R1-R6 at full width; R7 resumes a checkpoint.
9. train_families: mamba2-370m and deepseek-v2-lite-16b at their widths.
10. reference: reduced runs on the card against the same runs on the CPU.
11. ranks: ``RANK_RUNS`` on ``RANKS`` processes over gloo, full width.
12. dryrun: mistral-large-123b's plan executed at its widths, depth 1
   (``EXEC_RUNS``), beside the meta records a CPU process builds.
13. serve: every arch of ``ARCH_IDS`` at its published widths.
14. chunked: granite's S 4096 prefill, chunked against unchunked.

Every run of phases 3, 4, 7, 8, 9 and 11 goes through ``took_the_kernels``:
each wrapper launched its kernel as often as it was called (no plain
version ran on the card), the data's walk (and AdamW, but in phase 4)
launched, and exactly the wire's kernels launched, as often as the run's
table says where it gives launches.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` record, and before that the card's name and power
limit from nvidia-smi.  Without a CUDA device, or without the repository's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

from bench.yardstick import bound_seconds

ROOT = pathlib.Path(__file__).resolve().parent
INVARIANT_LIMIT = 0.0           # the shared-state invariants hold exactly


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def phase_build(build) -> None:
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert names == sorted(build.SIGNATURES), (names, sorted(build.SIGNATURES))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(build.compile_library, names)))
    for name, text in logs.items():
        build.load(name)
        lines = [l.strip() for l in (text or "cached").splitlines()
                 if "registers" in l or "Compiling entry" in l or l == "cached"]
        log(f"build {name}.cu: " + " | ".join(lines))
    log(f"build: {len(names)} libraries in {time.perf_counter() - t0:.1f} s")
    for name in ("sparse", "lowrank"):
        for inst, regs, local in build.kernel_attrs(name):
            log(f"build {name}.cu {inst}: {regs} registers, {local} local bytes")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


SM_CLOCK_HZ = 1.98e9             # H100 SXM boost clock
DISPATCH_PER_CLOCK = 128         # an SM's 4 schedulers, a warp instruction a clock each
# The operations one candidate of the Markov walk needs, by the SM unit that
# runs them: unit -> (operations a candidate, operations a clock an SM; CUDA
# C Programming Guide, arithmetic instruction throughput, compute capability
# 9.0).  A transcendental counts as the one MUFU operation a fast-math build
# would run, so the bound is a lower one: the exact walk needs the accurate
# logf and cosf, which are longer.
MARKOV_UNIT_OPS = {
    # 3 PCG hashes of 3 shifts, an add and 2 xors; the xors into them; the
    # uniforms' shifts; the argmax's compare and 2 selects; the loop's add
    # and compare
    "alu": (29, 64),
    # the hashes' 6 multiply-adds; the uniforms' adds and products (6); the
    # log2-to-ln scales (3), -2 ln u, 2 pi u, the cos's range scale, the
    # sqrt's product, r cos, over the concentration and + gumbel
    "fma": (22, 128),
    "mufu": (5, 16),             # 3 log2, a cos, a reciprocal square root
    "convert": (3, 16),          # the uniforms' integer to float
}


def markov_bound(sms: int, rows: int, vocab: int, length: int):
    """(ms, unit) of the walk's lower bound: ``rows * length * vocab``
    candidates spread over ``sms`` SMs at the boost clock, each taking the
    clocks of its busiest unit (or of its instruction dispatch) in
    ``MARKOV_UNIT_OPS``; the walk's barriers and reductions not counted."""
    clocks = {unit: ops / rate for unit, (ops, rate) in MARKOV_UNIT_OPS.items()}
    clocks["dispatch"] = sum(ops for ops, _ in MARKOV_UNIT_OPS.values()) / DISPATCH_PER_CLOCK
    unit = max(clocks, key=clocks.get)
    return rows * length * vocab * clocks[unit] / (sms * SM_CLOCK_HZ) * 1e3, unit


CSRC, TPU = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
# kernel name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "quantize_pack_2d": (CSRC + "quant.cu", TPU + "quant.py:284"),
    "unpack_dequant_axpy_2d": (CSRC + "quant.cu", TPU + "quant.py:367"),
    "quantize_2d": (CSRC + "quant.cu", TPU + "quant.py:253"),
    "dequantize_2d": (CSRC + "quant.cu", TPU + "quant.py:323"),
    "unpack_dequant_2d": (CSRC + "quant.cu", TPU + "quant.py:343"),
    "sign_pack_2d": (CSRC + "sign.cu", TPU + "quant.py:612"),
    "unpack_sign_axpy_2d": (CSRC + "sign.cu", TPU + "quant.py:648"),
    "sparse_select_pack_2d": (CSRC + "sparse.cu", TPU + "quant.py:503"),
    "sparse_unpack_scatter_2d": (CSRC + "sparse.cu", TPU + "quant.py:544"),
    "sparse_scatter_axpy_2d": (CSRC + "sparse.cu", TPU + "quant.py:684"),
    "lowrank_project_2d": (CSRC + "lowrank.cu", TPU + "lowrank.py:67"),
    "lowrank_axpy_2d": (CSRC + "lowrank.cu", TPU + "lowrank.py:92"),
    # the bf16-accumulator variants of the four receives (bf16 replicas and
    # estimates); the JAX package widens the accumulator and runs the same
    # TPU kernel
    "unpack_dequant_axpy_2d_bf16": (CSRC + "quant.cu", TPU + "quant.py:367"),
    "unpack_sign_axpy_2d_bf16": (CSRC + "sign.cu", TPU + "quant.py:648"),
    "sparse_scatter_axpy_2d_bf16": (CSRC + "sparse.cu", TPU + "quant.py:684"),
    "lowrank_axpy_2d_bf16": (CSRC + "lowrank.cu", TPU + "lowrank.py:92"),
    # the data layer's Markov walk; the JAX package samples its walk with
    # threefry keys and no TPU kernel
    "markov_walk": (CSRC + "markov.cu", "none"),
    # the optim layer's AdamW update; the JAX package's AdamW is jnp that XLA
    # fuses
    "adamw_update": (CSRC + "adamw.cu", "none"),
}


def max_abs_err(a, b) -> float:
    """max |a - b| where neither is NaN (equal infinities differ by 0)."""
    ok = ~(a.isnan() | b.isnan())
    af, bf = a.float(), b.float()
    d = (af - bf).abs().masked_fill(af == bf, 0.0)[ok]
    return d.max().item() if d.numel() else 0.0


def check(ref, rec: dict, name: str, label: str, got, want, what: str) -> None:
    """Kernel outputs against their plain version's: bit-equal
    (``ref.same_bits``), or fail."""
    ok = all(ref.same_bits(g, w) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want) if g.is_floating_point()) \
        if any(g.is_floating_point() for g in got) else 0.0
    rec[name]["err"] = max(rec[name]["err"], err)
    log(f"kernel {name} {label} ({what}): bit_equal={ok} max_abs_err={err}")
    assert ok, f"{name} disagrees with its plain version at {label} ({what})"


def measure(torch, ref, rec: dict, name: str, kernel, plain, nbytes: int, f32_ops: int,
            what: str, label: str = "lm_head", library=None, yardstick=None) -> dict:
    """``kernel()`` checked once against ``plain()`` (bit-equal, or fail),
    then both timed with CUDA events beside the bound of ``nbytes`` and
    ``f32_ops`` (the least time at the benchmark's H100 peaks,
    ``bench.yardstick.bound_seconds``) and, where given, beside
    ``library()`` (the PyTorch call nearest the kernel's function) and
    ``yardstick()`` (for a receive ``torch.mul(acc, 1.0, out=out)``: it
    moves the accumulator's bytes, not the same function).  Logs the times
    and returns them as ``rec``'s entries hold them."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(ref, rec, name, label, *(t if isinstance(t, tuple) else (t,) for t in (got, want)),
          what)
    del got, want
    by = "bytes" if bound_seconds(nbytes) >= bound_seconds(0, f32_ops) else "operations"
    r = {"ms": time_ms(torch, kernel, 10), "plain_ms": time_ms(torch, plain, 2, 1),
         "bound": (bound_seconds(nbytes, f32_ops) * 1e3, by),
         "library_ms": time_ms(torch, library, 10) if library else None}
    if yardstick:
        r["yardstick_ms"] = time_ms(torch, yardstick, 10)
    lib = f", library {r['library_ms']:.4f} ms" if library else ""
    yard = f", yardstick torch.mul {r['yardstick_ms']:.4f} ms" if yardstick else ""
    log(f"time {name} {label}: kernel {r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it), plain "
        f"{r['plain_ms']:.2f} ms{lib}{yard}")
    return r


def measure_receives(torch, ref, rec: dict, name: str, acc, kernel, plain, payload_bytes: int,
                     f32_ops: int, library=None) -> None:
    """A receive into the f32 accumulator ``acc`` (kernel ``name``) and into
    its bf16 copy (``name`` + ``_bf16``): ``kernel(acc, out)`` against
    ``plain(acc)``, each beside the same-bytes yardstick and its bound (the
    payload's bytes, the accumulator read and ``out`` written); ``library``
    times the f32 receive's PyTorch equivalent."""
    for suffix, a in (("", acc), ("_bf16", acc.bfloat16())):
        out = torch.empty_like(a)
        rec[name + suffix].update(measure(
            torch, ref, rec, name + suffix, lambda: kernel(a, out), lambda: plain(a),
            payload_bytes + 2 * a.numel() * a.element_size(), f32_ops, f"{a.dtype} acc",
            library=None if suffix else library,
            yardstick=lambda: torch.mul(a, 1.0, out=out)))
        del a, out


def fold(torch, seed: int, rows: int, cols: int):
    """(x, acc) at a fold: a leaf's values, N(0, 0.02^2), and an
    accumulator, N(0, 1), from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((rows, cols), generator=gen, device="cuda") * 0.02
    return x, torch.randn((rows, cols), generator=gen, device="cuda")


def phase_kernels(torch, q, ref, rec: dict, bits: int = 4) -> None:
    """K1 and K2 at the ``quant:4`` path's ``lm_head`` fold."""
    rows, cols = 802816, 1024
    x, acc = fold(torch, 1234, rows, cols)
    n, seed = rows * cols, 0x9E3779B9 ^ rows
    words, scale = q.quantize_pack_2d(x, seed, bits=bits)
    W = words.shape[1]
    rec["quantize_pack_2d"].update(measure(
        torch, ref, rec, "quantize_pack_2d", lambda: q.quantize_pack_2d(x, seed, bits=bits),
        lambda: ref.quantize_pack_2d_ref(x, seed, bits=bits),
        n * 4 + rows * W * 4 + rows * 4, 8 * n, f"{rows}x{cols}, {bits}-bit"))
    measure_receives(
        torch, ref, rec, "unpack_dequant_axpy_2d", acc,
        lambda a, out: q.unpack_dequant_axpy_2d(words, scale, a, bits=bits, weight=1.0,
                                                acc_weight=1.0, out=out),
        lambda a: ref.unpack_dequant_axpy_2d_ref(words, scale, a, bits=bits, weight=1.0,
                                                 acc_weight=1.0),
        rows * W * 4 + rows * 4, 3 * n)
    del x, acc, words, scale
    torch.cuda.empty_cache()


def phase_kernels_sign(torch, q, ref, rec: dict) -> None:
    """K5a (mean scale) and K5b at the ``sign`` path's ``lm_head`` fold."""
    rows, cols = 802816, 1024
    x, acc = fold(torch, 4321, rows, cols)
    n = rows * cols
    words, scale = q.sign_pack_2d(x)
    W = words.shape[1]
    rec["sign_pack_2d"].update(measure(
        torch, ref, rec, "sign_pack_2d", lambda: q.sign_pack_2d(x),
        lambda: ref.sign_pack_2d_ref(x), n * 4 + rows * W * 4 + rows * 4, 3 * n,
        f"{rows}x{cols}, mean"))
    measure_receives(
        torch, ref, rec, "unpack_sign_axpy_2d", acc,
        lambda a, out: q.unpack_sign_axpy_2d(words, scale, a, weight=1.0, acc_weight=1.0,
                                             out=out),
        lambda a: ref.unpack_sign_axpy_2d_ref(words, scale, a, weight=1.0, acc_weight=1.0),
        rows * W * 4 + rows * 4, 3 * n)
    del x, acc, words, scale
    torch.cuda.empty_cache()


def phase_kernels_sparse(torch, q, ref, rec: dict) -> None:
    """K6 at p 0.05 topk (beside ``torch.topk``, selection only: it neither
    orders ties canonically nor packs; the table's time) and at p 0.25
    randk, and K6c on K6's p 0.05 payload, at the ``sparse`` path's
    ``lm_head`` fold."""
    rows, cols = 6324224, 128
    x, acc = fold(torch, 2468, rows, cols)
    n, seed = rows * cols, 0x51A7E
    for p, mode in ((0.05, "topk"), (0.25, "randk")):
        k, _, _, W = ref.sparse_geometry(cols, p)
        r = measure(
            torch, ref, rec, "sparse_select_pack_2d",
            lambda: q.sparse_select_pack_2d(x, seed, p=p, mode=mode),
            lambda: ref.sparse_select_pack_2d_ref(x, seed, p=p, mode=mode),
            # the selection: one key a lane, then k passes of cols comparisons
            n * 4 + rows * k * 4 + rows * W * 4, rows * cols * (k + 1),
            f"{rows}x{cols}, {mode}, p={p}", label=f"lm_head p={p} {mode}",
            library=(lambda: torch.topk(x.abs(), k, dim=1)) if mode == "topk" else None)
        if mode == "topk":
            rec["sparse_select_pack_2d"].update(r)
    vals, idx = q.sparse_select_pack_2d(x, seed, p=0.05, mode="topk")
    measure_receives(
        torch, ref, rec, "sparse_scatter_axpy_2d", acc,
        lambda a, out: q.sparse_scatter_axpy_2d(vals, idx, a, weight=1.0, acc_weight=1.0,
                                                out=out),
        lambda a: ref.sparse_scatter_axpy_2d_ref(vals, idx, a, weight=1.0, acc_weight=1.0),
        rows * vals.shape[1] * 4 + rows * idx.shape[1] * 4, 3 * n)
    del x, acc, vals, idx
    torch.cuda.empty_cache()


def phase_kernels_decode(torch, q, ref, rec: dict) -> None:
    """K3 (8 bits), K4a and K4b (4 bits) at the ``quant`` path's ``lm_head``
    fold; K4a beside its body as one PyTorch call, ``torch.mul`` of the int8
    codes and the per-row float32 factor (type promotion makes it float32)."""
    rows, cols = 802816, 1024
    x, _ = fold(torch, 8642, rows, cols)
    n, seed = rows * cols, 0x5EED8 ^ rows
    codes, scale = q.quantize_2d(x, seed, bits=8)
    words, s4 = q.quantize_pack_2d(x, seed, bits=4)
    rec["quantize_2d"].update(measure(
        torch, ref, rec, "quantize_2d", lambda: q.quantize_2d(x, seed, bits=8),
        lambda: ref.quantize_2d_ref(x, seed, bits=8), n * 4 + n + rows * 4, 8 * n,
        f"{rows}x{cols}, 8-bit"))
    factor = scale * ref.inv_levels(8)
    rec["dequantize_2d"].update(measure(
        torch, ref, rec, "dequantize_2d", lambda: q.dequantize_2d(codes, scale, bits=8),
        lambda: ref.dequantize_2d_ref(codes, scale, bits=8), n + rows * 4 + n * 4, n + rows,
        f"{rows}x{cols}, 8-bit", library=lambda: torch.mul(codes, factor)))
    rec["unpack_dequant_2d"].update(measure(
        torch, ref, rec, "unpack_dequant_2d", lambda: q.unpack_dequant_2d(words, s4, bits=4),
        lambda: ref.unpack_dequant_2d_ref(words, s4, bits=4),
        rows * words.shape[1] * 4 + rows * 4 + n * 4, 2 * n + rows, f"{rows}x{cols}, 4-bit"))
    del x, codes, scale, factor, words, s4
    torch.cuda.empty_cache()


def phase_kernels_sparse_decode(torch, q, ref, rec: dict) -> None:
    """K6b on K6's p 0.25 randk payload (k = 32) at the ``sparse`` path's
    ``lm_head`` fold."""
    rows, cols = 6324224, 128
    x, _ = fold(torch, 9753, rows, cols)
    vals, idx = q.sparse_select_pack_2d(x, 0xB10C, p=0.25, mode="randk")
    k, W = vals.shape[1], idx.shape[1]
    rec["sparse_unpack_scatter_2d"].update(measure(
        torch, ref, rec, "sparse_unpack_scatter_2d",
        lambda: q.sparse_unpack_scatter_2d(vals, idx, cols=cols),
        lambda: ref.sparse_unpack_scatter_2d_ref(vals, idx, cols=cols),
        rows * k * 4 + rows * W * 4 + rows * cols * 4, rows * k,
        f"{rows}x{cols}, randk, p=0.25"))
    del x, vals, idx
    torch.cuda.empty_cache()


def phase_kernels_lowrank(torch, lk, ref, rec: dict) -> None:
    """K7a and K7b on the whole ``lm_head`` leaf with its 8-slab lead batch
    (8 x 2048 x 49,408) at the main path's rank 2, with warm factors (one a
    slab): K7a beside ``torch.bmm`` and K7b beside ``torch.baddbmm``, the
    PyTorch calls that compute the same functions; the bf16-accumulator K7b
    beside ``baddbmm`` on bf16 factors, the nearest library call, not the
    same function (its factors are rounded to bf16)."""
    batch, rows, n, r = 8, 2048, 49408, 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    m = torch.randn((batch, rows, n), generator=gen, device="cuda") * 0.02
    acc = torch.randn((batch, rows, n), generator=gen, device="cuda")
    v = torch.rand((batch, n, r), generator=gen, device="cuda") - 0.5
    el, v_bytes = batch * rows * n, batch * n * r * 4
    what = f"{batch}x{rows}x{n}, rank {r}, warm"
    rec["lowrank_project_2d"].update(measure(
        torch, ref, rec, "lowrank_project_2d", lambda: lk.lowrank_project_2d(m, v),
        lambda: ref.lowrank_project_2d_ref(m, v), el * 4 + v_bytes + batch * rows * r * 4,
        2 * el * r, what, library=lambda: torch.bmm(m, v)))
    p = lk.lowrank_project_2d(m, v)
    del m
    measure_receives(
        torch, ref, rec, "lowrank_axpy_2d", acc,
        lambda a, out: lk.lowrank_axpy_2d(p, v, a, weight=1.0, acc_weight=1.0, out=out),
        lambda a: ref.lowrank_axpy_2d_ref(p, v, a, weight=1.0, acc_weight=1.0),
        batch * rows * r * 4 + v_bytes, (2 * r + 2) * el,
        library=lambda: torch.baddbmm(acc, p, v.mT, beta=1.0, alpha=1.0))
    accb, pb, vtb = acc.bfloat16(), p.bfloat16(), v.mT.bfloat16()
    log(f"time lowrank_axpy_2d_bf16 lm_head: torch.baddbmm on bf16 factors (not the same "
        f"function) {time_ms(torch, lambda: torch.baddbmm(accb, pb, vtb), 10):.4f} ms")
    del acc, v, p, accb, pb, vtb
    torch.cuda.empty_cache()


# (rows, vocab, length) of the Markov walks: the granite cells' batch (the
# kernels record's shape) and the mamba cell's
MARKOV_SHAPES = ((32, 49155, 256), (8, 50280, 1024))
MARKOV_SEED = 3_000_000_019     # the data's seed, of the benchmark's size (past 2^31)


def phase_kernels_markov(torch, mk, ref, rec: dict) -> None:
    """The data layer's Markov walk against its plain version (the eager
    walk, ``ref.markov_walk_ref``) on the card at ``MARKOV_SHAPES``, token
    for token, on the row keys the pipeline makes.  Timed beside: the plain
    version, the same walk at one CTA a row (``cluster_size`` held at 1, its
    tokens checked too: no card test takes that path), the walk's fixed
    cost (a vocab of one candidate a CTA: what every position's reductions
    and cluster barrier take), and the lower bound (``markov_bound``)."""
    from repro_torch.data import DataConfig
    from repro_torch.data import pipeline

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, vocab, length in MARKOV_SHAPES:
        label, nodes = f"{rows}x{vocab}x{length}", math.gcd(rows, 8)
        csize = mk.cluster_size(rows, sms)
        dc = DataConfig(vocab=vocab, seq_len=length, global_batch=rows, n_shards=nodes,
                        seed=MARKOV_SEED)
        key = pipeline._row_keys(dc, 1, range(nodes), dev)
        kw = dict(vocab=vocab, length=length, seed=MARKOV_SEED,
                  concentration=dc.markov_concentration)
        got = mk.markov_walk(key, **kw)
        want = ref.markov_walk_ref(key, **kw)
        torch.cuda.synchronize()
        check(ref, rec, "markov_walk", label, (got,), (want,),
              f"seed {MARKOV_SEED}, {rows} clusters of {csize} CTAs")
        ms = time_ms(torch, lambda: mk.markov_walk(key, **kw), 5)
        plain_ms = time_ms(torch, lambda: ref.markov_walk_ref(key, **kw), 1, 1)
        fixed_ms = time_ms(torch, lambda: mk.markov_walk(key, **dict(kw, vocab=csize)), 5)
        real = mk.cluster_size
        mk.cluster_size = lambda rows, sms: 1
        try:
            one = mk.markov_walk(key, **kw)
            one_ms = time_ms(torch, lambda: mk.markov_walk(key, **kw), 3)
        finally:
            mk.cluster_size = real
        torch.cuda.synchronize()
        check(ref, rec, "markov_walk", label, (one,), (want,), "one CTA a row")
        lower, unit = markov_bound(sms, rows, vocab, length)
        log(f"time markov_walk {label}: kernel {ms:.4f} ms, lower bound {lower:.4f} ms "
            f"({unit}, {lower / ms:.1%} of it), fixed cost {fixed_ms:.4f} ms (vocab {csize}), "
            f"one CTA a row {one_ms:.4f} ms, plain {plain_ms:.2f} ms")
        if (rows, vocab, length) == MARKOV_SHAPES[0]:
            rec["markov_walk"].update(ms=ms, plain_ms=plain_ms, bound=(lower, "operations"))
        del got, want, one, key
    torch.cuda.empty_cache()


# granite's largest stacked leaf (embed, and lm_head: 8 nodes x 49,155 x 2,048)
ADAMW_SHAPE = (8, 49155, 2048)
# the cells' AdamW, lr 3e-3 past the warm-up
ADAMW_KW = dict(lr=3e-3, t=1, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
ADAMW_OPS = 15                  # f32 operations an element (products, sums, sqrt, division)


def phase_kernels_adamw(torch, ak, ref, rec: dict) -> None:
    """The optim layer's AdamW update at ``ADAMW_SHAPE`` in f32: the update,
    ``m`` and ``v`` against the plain version (the eager body,
    ``ref.adamw_update_ref``), timed beside its bound (28 B an element) and
    the library's fused AdamW (``torch._fused_adamw_``, the same bytes;
    timed only, the port never calls it)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    g = torch.randn(ADAMW_SHAPE, generator=gen, device="cuda").mul_(1e-2)
    p = torch.randn(ADAMW_SHAPE, generator=gen, device="cuda")
    m = torch.randn(ADAMW_SHAPE, generator=gen, device="cuda").mul_(1e-3)
    v = torch.rand(ADAMW_SHAPE, generator=gen, device="cuda").mul_(1e-4)
    mr, vr, n = m.clone(), v.clone(), g.numel()
    steps = [torch.ones((), device="cuda")]
    rec["adamw_update"].update(measure(
        torch, ref, rec, "adamw_update", lambda: (ak.adamw_update(g, m, v, p, **ADAMW_KW), m, v),
        lambda: (ref.adamw_update_ref(g, mr, vr, p, **ADAMW_KW), mr, vr), 28 * n,
        ADAMW_OPS * n, "f32 g and p, t 1, lr 3e-3", label=f"embed {ADAMW_SHAPE}",
        library=lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], steps, lr=3e-3, beta1=0.9, beta2=0.95, weight_decay=0.01,
            eps=1e-8, amsgrad=False, maximize=False)))
    del g, p, m, v, mr, vr, steps
    torch.cuda.empty_cache()


def max_shift_residual(torch, tree_leaves, base, others: dict) -> float:
    """max |roll(base, s) - others[s]| over every leaf and shift."""
    worst = 0.0
    for s, tree in others.items():
        for b, o in zip(tree_leaves(base), tree_leaves(tree)):
            worst = max(worst, (torch.roll(b, s, dims=0) - o).abs().max().item())
    return worst


ADAPTIVE_SPEC = "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"
K1_K2, K3_K4A = ("quantize_pack_2d", "unpack_dequant_axpy_2d"), ("quantize_2d", "dequantize_2d")
# (algo, wire, steps, the wire's kernels: {kernel: launches a step}, or the
# names of those that launch where the step analyzer's grid,
# step_checks.DEFAULT_GRID, counts the pair's launches); the other wire
# kernels launch none
TRAIN_RUNS = (
    ("dcd", "quant:4", 3, {"quantize_pack_2d": 12, "unpack_dequant_axpy_2d": 36}),
    ("ecd", "quant:4", 2, K1_K2),
    ("choco", "sign", 2, ("sign_pack_2d", "unpack_sign_axpy_2d")),
    ("deepsqueeze", "sign", 2, ("sign_pack_2d", "unpack_sign_axpy_2d")),
    ("choco", "sparse:0.05:topk", 2, {"sparse_select_pack_2d": 12,
                                      "sparse_scatter_axpy_2d": 36}),
    # lowrank: 11 matrix leaves (final_ln, (n, d), rides fp16); adaptive:
    # embed by its override, ln1/ln2/final_ln (2048 per replica) small
    ("dcd", "lowrank:2:warm", 3, {"lowrank_project_2d": 11, "lowrank_axpy_2d": 33}),
    ("dcd", "lowrank:2", 2, ("lowrank_project_2d", "lowrank_axpy_2d")),
    ("choco", ADAPTIVE_SPEC, 2, {"quantize_pack_2d": 1, "unpack_dequant_axpy_2d": 3,
                                 "lowrank_project_2d": 8, "lowrank_axpy_2d": 24}),
    # the runtime's default wire: K3 sends, each receive a K4a decode + axpy
    ("dcd", "quant:8", 2, {"quantize_2d": 12, "dequantize_2d": 36}),
)
# algo -> (the tree every shifted copy tracks, prefix of the shifted copies)
INVARIANTS = {"dcd": (None, "rep"), "ecd": ("tilde_self", "tilde"),
              "choco": ("hat_self", "hat")}


def warm_factor_snapshots(train_mod, wire):
    """Wrap launch/train.py's step builder so that each step's warm factors are
    kept (a copy per step); returns (snapshots, undo)."""
    real = train_mod.make_dist_train_step
    snaps = []

    def traced(*args, **kwargs):
        step = real(*args, **kwargs)

        def step_and_snapshot(state, batch):
            out = step(state, batch)
            snaps.append({k: f.clone() for k, f in state.aux[wire.aux_name].items()})
            return out
        return step_and_snapshot

    train_mod.make_dist_train_step = traced
    return snaps, lambda: setattr(train_mod, "make_dist_train_step", real)


STEP_KERNELS = ("markov_walk", "adamw_update")     # every run_training step takes both


def took_the_kernels(q, calls0: dict, counts: dict, wire, step=STEP_KERNELS) -> None:
    """Every wrapper call since ``calls0`` (``q.call_counts()``) launched
    its kernel, so no plain version ran on the card: the calls equal
    ``counts`` (the launches, reset at the same point).  Of the kernels
    other than ``STEP_KERNELS``, exactly those of ``wire`` launched: as
    often as it says where it is a dict of launches, at least once where it
    is a tuple of names.  Each kernel of ``step`` launched at least once."""
    calls = {k: v - calls0[k] for k, v in q.call_counts().items()}
    assert calls == counts, (calls, counts)
    got = {k: v for k, v in counts.items() if v and k not in STEP_KERNELS}
    assert (got == wire) if isinstance(wire, dict) else (sorted(got) == sorted(wire)), \
        (got, wire)
    assert all(counts[k] for k in step), (counts, step)


def phase_train(torch, algo: str, wire: str, steps: int, launched, q) -> None:
    """A run of ``TRAIN_RUNS`` on granite-3-2b at full width, depth 1, 8
    nodes, ring: finite losses, the shared-state invariant exact, every
    non-zero warm factor of a stateful wire moving every step."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.wire import make_wire_format
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import TrainConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    tc = TrainConfig(arch="granite-3-2b", algo=algo, wire=wire, gamma=0.5, topology="ring",
                     n_nodes=8, steps=steps, log_every=1, reduced=False)
    tag = f"{algo} {wire}"
    wf = make_wire_format(wire)
    snaps, undo = warm_factor_snapshots(train_mod, wf) if wf.stateful else ([], None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    q.reset_launch_counts()
    calls0 = q.call_counts()
    try:
        hist = train_mod.run_training(cfg, tc, device="cuda")
    finally:
        if undo is not None:
            undo()
    counts = q.launch_counts()
    took_the_kernels(q, calls0, counts, {k: v * steps for k, v in launched.items()}
                     if isinstance(launched, dict) else launched)
    peak = torch.cuda.max_memory_allocated()
    state = hist["state"]
    n_leaves = len(tree_leaves(state.params))
    per_node = sum(l[0].numel() for l in tree_leaves(state.params))
    log(f"train {tag}: granite-3-2b d_model={cfg.d_model} n_layers={cfg.n_layers} "
        f"vocab_padded={cfg.vocab_padded} params/node={per_node} leaves={n_leaves} "
        f"nodes={tc.n_nodes} seq={tc.seq_len} global_batch={tc.global_batch}")
    log(f"train {tag}: losses={hist['losses']} consensus={hist['consensus']}")
    log(f"train {tag}: step_s={[round(s, 4) for s in hist['step_s']]} "
        f"peak_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"train {tag}: launches {counts}")
    nbytes = wf.wire_nbytes(state.params)
    log(f"train {tag}: wire_nbytes per step {nbytes} B for the {tc.n_nodes} nodes' payloads "
        f"({nbytes // tc.n_nodes} B a node, {8 * nbytes / (tc.n_nodes * per_node):.4f} bits "
        f"an element)")
    if wf.stateful:
        # every non-zero factor must move each step; a zero factor is a fixed
        # point of the power iteration (as in the JAX package), reached when
        # a round's difference is exactly zero
        prev = wf.init_aux(state.params)
        assert len(snaps) == steps, len(snaps)
        changed, live = [], []
        for snap in snaps:
            keys = [k for k in prev if bool(prev[k].any())]
            changed.append(sum(not torch.equal(prev[k], snap[k]) for k in keys))
            live.append(len(keys))
            prev = snap
        zero = [k for k in prev if not bool(prev[k].any())]
        log(f"train {tag}: warm factors ({len(prev)} leaves) changed each step: {changed} "
            f"of the non-zero {live}; zero after the last step: leaves {zero}")
        assert changed == live and live[0] == len(prev), (changed, live)
        del snaps, prev
    assert all(math.isfinite(l) for l in hist["losses"]), hist["losses"]
    assert all(math.isfinite(c) for c in hist["consensus"]), hist["consensus"]
    assert n_leaves == 12, n_leaves
    if algo in INVARIANTS:
        base_key, prefix = INVARIANTS[algo]
        base = state.params if base_key is None else state.aux[base_key]
        resid = max_shift_residual(torch, tree_leaves, base,
                                   {s: state.aux[f"{prefix}{s:+d}"] for s in (-1, 1)})
        log(f"train {tag}: invariant {prefix}{{s}} == roll({base_key or 'X'}, s): "
            f"max_abs_diff={resid}")
        assert resid <= INVARIANT_LIMIT, resid
    del hist, state
    torch.cuda.empty_cache()


def drop_history(tc, steps: int, start: int = 0):
    """Replays the runtime's drop masks and freshness on the host: for every
    union shift, the nodes whose edge never dropped in steps [start, steps),
    and every round's realized mixing matrix (row sums checked) and final
    freshness vectors.  Without drops every node counts as delivered."""
    import torch

    from repro_torch.distributed.decentralized import REPLICA_ALGOS
    from repro_torch.distributed.failures import edge_drop_mask, make_drop_spec, update_freshness
    from repro_torch.distributed.gossip import (as_schedule, make_gossip_plan,
                                                realized_mixing_matrix)

    sched = as_schedule(make_gossip_plan(tc.topology, tc.n_nodes))
    drop = make_drop_spec(tc.drop_rate, salt=tc.drop_salt)
    n = sched.n
    never = {s: torch.ones(n) for s in sched.shift_union}
    fresh = {s: torch.ones(n) for s in sched.shift_union}
    worst_row_sum, dropped_edges = 0.0, 0
    if drop is None:
        return never, fresh, worst_row_sum, dropped_edges
    tv = sched.time_varying and sched.period > 1
    for t in range(start, steps):
        todo = [(sched.rounds[t % sched.period], t)] if tv else \
            [(rnd, t * sched.period + r) for r, rnd in enumerate(sched.rounds)]
        for rnd, enc in todo:
            shifts = sched.shift_union if tc.algo in REPLICA_ALGOS else rnd.shift_list
            masks = {s: edge_drop_mask(n, s, enc, drop) for s in shifts}
            if tc.algo in REPLICA_ALGOS:
                for s in shifts:
                    fresh[s] = update_freshness(fresh[s], masks[s], drop.decay)
                gates = {s: masks[s] * fresh[s] for s in rnd.shift_list}
            else:
                gates = {s: masks[s] for s in rnd.shift_list}
            for s in shifts:
                never[s] = never[s] * masks[s]
            dropped_edges += int(sum((1 - m).sum().item() for m in masks.values()))
            W = realized_mixing_matrix(rnd, gates).double()
            worst_row_sum = max(worst_row_sum, (W.sum(dim=1) - 1).abs().max().item())
    return never, fresh, worst_row_sum, dropped_edges


def replica_residuals(torch, state, algo: str, never: dict):
    """max |rep{s} - roll(X, s)| over the rows whose edges never dropped
    (must be 0), and over the frozen rows (stale, reported)."""
    from repro_torch.distributed.decentralized import REPLICA_ALGOS
    from repro_torch.tree import tree_leaves

    if algo not in REPLICA_ALGOS:
        return None, None
    base_key, prefix = INVARIANTS[algo]
    base = state.params if base_key is None else state.aux[base_key]
    kept, stale = 0.0, 0.0
    for s, ok in never.items():
        rows = ok.bool().to(tree_leaves(base)[0].device)
        for b, o in zip(tree_leaves(base), tree_leaves(state.aux[f"{prefix}{s:+d}"])):
            d = (torch.roll(b, s, dims=0) - o).abs().flatten(1).amax(dim=1)
            kept = max(kept, d[rows].max().item() if rows.any() else 0.0)
            stale = max(stale, d[~rows].max().item() if (~rows).any() else 0.0)
    return kept, stale


def rekey_watch(torch, train_mod, algo: str):
    """Wrap launch/train.py's rekey so that the shift invariant is measured
    on the state it returns; returns (residuals, undo)."""
    from repro_torch.distributed.decentralized import REPLICA_ALGOS
    from repro_torch.tree import tree_leaves

    real = train_mod.rekey_dist_state
    seen = []

    def watched(state, algo_, plan, **kw):
        out = real(state, algo_, plan, **kw)
        if algo in REPLICA_ALGOS:
            base_key, prefix = INVARIANTS[algo]
            base = out.params if base_key is None else out.aux[base_key]
            seen.append(max_shift_residual(torch, tree_leaves, base, {
                int(k[len(prefix):]): v for k, v in out.aux.items()
                if k.startswith(prefix) and k[len(prefix):][:1] in "+-"}))
        return out
    train_mod.rekey_dist_state = watched
    return seen, lambda: setattr(train_mod, "rekey_dist_state", real)


# The full-width runs of the whole runtime: (label, TrainConfig fields,
# steps, the wire's kernels as in TRAIN_RUNS, a dict holding the launches over
# the run); 12 leaves.
PLAN_RUNS = (
    ("R1", dict(algo="naive", wire="quant:4", topology="chain", drop_rate=0.1), 2,
     {"quantize_pack_2d": 24, "unpack_dequant_2d": 72}),
    ("R2", dict(algo="dcd", wire="quant:8", topology="full_logn", drop_rate=0.1), 2, K3_K4A),
    ("R3", dict(algo="dcd", wire="quant:4", topology="exp"), 3, K1_K2),
    ("R4", dict(algo="dpsgd", topology="chain", drop_rate=0.1), 2, ()),
    ("R5", dict(algo="cpsgd", topology="ring"), 2, {}),
    ("R6", dict(algo="dcd", phase_plan="0@ring@quant:8;2@full_logn@quant:4"), 4,
     K3_K4A + K1_K2),
)


def phase_plan_run(torch, q, label: str, fields: dict, steps: int, launched) -> None:
    """One run of ``PLAN_RUNS`` on granite-3-2b at full width, depth 1, 8
    nodes, through ``run_training``: launch counts, peak memory, step times,
    and what the run exercises — replicas exact on the rows whose edges never
    dropped, realized mixing rows summing to 1, the freshness replayed on
    the host equal to the runtime's, identical replicas under cpsgd, the
    shift invariant right after a phase boundary's rekey."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.failures import fresh_key, make_drop_spec
    from repro_torch.distributed.gossip import as_schedule, make_gossip_plan
    from repro_torch.distributed.wire import make_wire_format
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import GOSSIP_ALGOS, TrainConfig
    from repro_torch.netsim.controller import PhasePlan
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    tc = TrainConfig(arch="granite-3-2b", gamma=0.5, n_nodes=8, steps=steps, log_every=1,
                     reduced=False, **fields)
    tag = f"{label} " + " ".join(f"{k}={v}" for k, v in fields.items())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rekeys, undo = rekey_watch(torch, train_mod, tc.algo)
    q.reset_launch_counts()
    calls0 = q.call_counts()
    try:
        hist = train_mod.run_training(cfg, tc, device="cuda")
    finally:
        undo()
    counts = q.launch_counts()
    took_the_kernels(q, calls0, counts, launched)
    peak = torch.cuda.max_memory_allocated()
    state = hist["state"]
    log(f"plan {tag}: losses={hist['losses']} consensus={hist['consensus']}")
    log(f"plan {tag}: step_s={[round(x, 4) for x in hist['step_s']]} "
        f"peak_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"plan {tag}: launches {counts}")
    pplan = PhasePlan.parse(tc.phase_plan) if tc.phase_plan else None
    phases = [(a, b, ph.topology, ph.wire) for a, b, ph in pplan.segments(steps)] \
        if pplan else [(0, steps, tc.topology, tc.wire)]
    for a, b, topo, wire in phases:
        sched = as_schedule(make_gossip_plan(topo, tc.n_nodes))
        rounds = 1 if sched.time_varying else sched.period
        rolls = sched.replica_payloads if tc.algo in ("dcd", "ecd", "choco") else sched.degree
        if tc.algo in GOSSIP_ALGOS:
            enc = make_wire_format(wire).wire_nbytes(state.params)
            log(f"plan {tag}: steps {a}-{b - 1} ({topo}, {wire}): {enc * rounds} B encoded a "
                f"step ({rounds} payload(s) of {enc} B for the {tc.n_nodes} nodes), "
                f"{rolls} payload rolls a step")
        else:
            dense = sum(l.numel() * l.element_size() for l in tree_leaves(state.params))
            log(f"plan {tag}: steps {a}-{b - 1} ({topo}): full precision, "
                f"{dense if tc.algo == 'dpsgd' else 0} B of params a roll, "
                f"{rolls if tc.algo == 'dpsgd' else 0} rolls a step")
    assert all(math.isfinite(v) for v in hist["losses"] + hist["consensus"]), hist
    last = dataclasses.replace(tc, topology=phases[-1][2])
    never, fresh, row_sum, n_dropped = drop_history(last, steps, start=phases[-1][0])
    kept, stale = replica_residuals(torch, state, tc.algo, never)
    if tc.drop_rate:
        log(f"plan {tag}: {n_dropped} directed edges dropped over the run; realized mixing "
            f"rows sum to 1 within {row_sum:.3e}")
        assert row_sum <= 1e-6, row_sum
        drop = make_drop_spec(tc.drop_rate, salt=tc.drop_salt)
        if tc.algo in INVARIANTS:
            for s, f in fresh.items():
                assert torch.equal(state.aux[fresh_key(s, drop.salt)], f), s
    if kept is not None:
        log(f"plan {tag}: replicas vs roll(X, s): max_abs_diff {kept} on the rows whose edges "
            f"never dropped, {stale} on the frozen rows")
        assert kept <= INVARIANT_LIMIT, kept
    if rekeys:
        log(f"plan {tag}: right after each rekey, max |rep{{s}} - roll(X, s)| = {rekeys}")
        assert len(rekeys) == len(phases) - 1 and max(rekeys) <= INVARIANT_LIMIT, rekeys
    if tc.algo == "cpsgd":
        same = all(bool((l == l[:1]).all()) for l in tree_leaves(state.params))
        log(f"plan {tag}: replicas identical {same}, consensus {hist['consensus']}")
        assert same and all(c == 0.0 for c in hist["consensus"]), hist["consensus"]
    del hist, state
    torch.cuda.empty_cache()


def phase_checkpoint(torch, q) -> None:
    """R7: DCD ``quant:4`` on the ring at a small width (granite-3-2b
    reduced: d 256, 2 layers), 8 nodes.  A 4-step run saves every 2 steps;
    a fresh run resumed from the step-2 checkpoint must restore the saved
    state bit for bit and reproduce the run-through's losses and final
    state."""
    import shutil

    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.checkpoint import _items
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import TrainConfig

    cfg = get_config("granite-3-2b").reduced()
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainConfig(arch="granite-3-2b", algo="dcd", wire="quant:4", topology="ring",
                     n_nodes=8, seq_len=64, global_batch=16, steps=4, log_every=1,
                     ckpt_dir=str(root / "through"), ckpt_every=2)
    real_save, saved = train_mod.save, {}

    def keep_copy(ckpt_dir, step, tree, **kw):
        saved[step] = [(k, v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in _items(tree)]
        return real_save(ckpt_dir, step, tree, **kw)
    train_mod.save = keep_copy
    q.reset_launch_counts()
    calls0 = q.call_counts()
    try:
        through = train_mod.run_training(cfg, tc, device="cuda")
        (root / "resumed").mkdir(parents=True)
        for suffix in (".npz", ".npz.json"):
            shutil.copy(root / "through" / f"ckpt_{2:08d}{suffix}", root / "resumed")
        resumed = train_mod.run_training(cfg, dataclasses.replace(
            tc, ckpt_dir=str(root / "resumed")), device="cuda")
    finally:
        train_mod.save = real_save
    counts = q.launch_counts()
    took_the_kernels(q, calls0, counts, K1_K2)
    restored, _ = restore(str(root / "through"), through["state"], 2)
    same_restore = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for (_, a), (_, b) in zip(saved[2], _items(restored)))
    end_a, end_b = _items(through["state"]), _items(resumed["state"])
    diff = max((a.float() - b.float()).abs().max().item() if isinstance(a, torch.Tensor)
               else float(a != b) for (_, a), (_, b) in zip(end_a, end_b))
    loss_diff = max(abs(a - b) for a, b in zip(through["losses"][2:], resumed["losses"]))
    log(f"checkpoint R7: reduced granite dcd quant:4 ring, 8 nodes: run-through losses "
        f"{through['losses']}, resumed from step 2 {resumed['losses']}; restored state "
        f"bit-equal to the saved one {same_restore}; final state max_abs_diff {diff}, "
        f"loss max diff {loss_diff}; launches {counts}")
    assert same_restore and diff == 0.0 and loss_diff == 0.0, (same_restore, diff, loss_diff)
    shutil.rmtree(root, ignore_errors=True)


def _stacked_setup(cfg, n_nodes: int, seq_len: int, global_batch: int):
    from repro_torch.data import DataConfig
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
                    n_shards=n_nodes, seed=0)
    return model, dc


def stacked_step(model, algo_step, state, batch, key, lr: float):
    """One stacked-reference step: per-node losses and gradients of the
    port's model, then the algorithm's in-place step.  Returns the mean loss."""
    from repro_torch.distributed.decentralized import _node_grads
    from repro_torch.tree import leaf_items, tree_from_items

    losses, _, grads = _node_grads(model.loss, state.params, batch)
    paths = [p for p, _ in leaf_items(state.params)]
    algo_step(state, tree_from_items(list(zip(paths, grads))), key, lr)
    return float(losses.mean())


def stacked_runs():
    from repro_torch.core import RandomQuantizer, RandomSparsifier

    # (algo, compressor, {kernel: launches a step} of its kernels), outside
    # the step analyzer's grid; the other wire kernels launch none
    return (("dcd", RandomQuantizer(bits=8, block_size=1024, use_kernel=True),
             {"quantize_2d": 12, "dequantize_2d": 12}),
            ("ecd", RandomQuantizer(bits=4, block_size=1024),
             {"quantize_pack_2d": 12, "unpack_dequant_2d": 12}),
            ("dcd", RandomSparsifier(p=0.25, block_size=128),
             {"sparse_select_pack_2d": 12, "sparse_unpack_scatter_2d": 12}))


def phase_stacked(torch, q, algo: str, comp, per_step: dict, steps: int = 2) -> None:
    """The stacked reference (``repro_torch.core``) at full width: granite-3-2b
    with one layer, 8 nodes on the ring, constant lr 3e-3, integer step keys."""
    from repro_torch.configs import get_config
    from repro_torch.core import consensus_distance, make_algorithm
    from repro_torch.data import stacked_node_batches

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    model, dc = _stacked_setup(cfg, 8, 256, 32)
    alg = make_algorithm(algo, 8, "ring", comp)
    tag = f"stacked {algo} {comp}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    q.reset_launch_counts()
    calls0 = q.call_counts()
    state = alg.init(model.init(0, device="cuda"))
    step = alg.step_fn()
    losses, consensus, step_s = [], [], []
    for t in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        batch = stacked_node_batches(dc, t, device="cuda")
        losses.append(stacked_step(model, step, state, batch, t, 3e-3))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        consensus.append(float(consensus_distance(state.params)))
    counts = q.launch_counts()
    took_the_kernels(q, calls0, counts, {k: v * steps for k, v in per_step.items()},
                     step=("markov_walk",))
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: losses={losses} consensus_distance={consensus}")
    log(f"{tag}: step_s={[round(x, 4) for x in step_s]} peak_memory_allocated={peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"{tag}: launches {counts}")
    nbytes = comp.wire.wire_nbytes(state.params)
    log(f"{tag}: wire_nbytes per step {nbytes} B for the 8 nodes' payloads")
    assert all(math.isfinite(v) for v in losses + consensus), (losses, consensus)
    del state
    torch.cuda.empty_cache()


# (algo, wire, drop, gamma, {kernel: the reference's launches a step}): sends
# and dense decodes only; the sign and lowrank decodes are plain torch, and
# lowrank's 1-D leaf (final_ln) rides fp16
GOSSIP_REFERENCE_RUNS = (
    ("dcd", "quant:4", "0.2:4", 0.5, {"quantize_pack_2d": 12, "unpack_dequant_2d": 12}),
    ("choco", "sign", "0.2:4", 0.7, {"sign_pack_2d": 12}),
    ("dcd", "lowrank:2:warm", None, 0.5, {"lowrank_project_2d": 11}),
)
GOSSIP_REFERENCE_NODES, GOSSIP_REFERENCE_STEPS, GOSSIP_REFERENCE_ATOL = 4, 3, 1e-5
# compare_compression's gated and failure modes, in process on the card
COMPARE_RUNS = (["--quick", "--pareto"], ["--quick", "--lowrank"],
                ["--quick", "--drop-rate", "0.2"],
                ["--quick", "--error-feedback", "--algo", "choco", "--wire", "sign"])


def phase_gossip_reference(torch, q) -> None:
    """(a) The runtime against ``GossipReference`` side by side at full
    width: granite-3-2b with one layer on a ring of 4 nodes, SGD at a
    constant lr, ``GOSSIP_REFERENCE_STEPS`` steps of each run of
    ``GOSSIP_REFERENCE_RUNS``.  The runtime is ``make_dist_train_step``; the
    reference takes ``_node_grads`` of its own params on the same batches.
    Params within ``GOSSIP_REFERENCE_ATOL`` after every step (the largest
    difference logged); the reference's launches a step, counted alone, are
    its sends and dense decodes and no receive kernel; its step time (host
    clock, ending in a synchronize) and the peak memory during its step,
    with the runtime's state resident, are logged.  Deterministic algorithms
    are on, so that the two sides' gradients of equal params are equal.
    (b) ``compare_compression``'s modes of ``COMPARE_RUNS`` on the card; a
    gate's ``SystemExit`` fails the run."""
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.core import GossipReference
    from repro_torch.data import DataConfig, stacked_node_batches
    from repro_torch.distributed.decentralized import (
        _node_grads, init_dist_state, make_dist_train_step)
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.examples import compare_compression
    from repro_torch.models.api import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.tree import leaf_items, tree_from_items, tree_leaves

    t_phase = time.perf_counter()
    n, lr = GOSSIP_REFERENCE_NODES, 3e-3
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8 * n, n_shards=n, seed=0)
    plan = make_gossip_plan("ring", n)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for algo, wire, drop, gamma, per_step in GOSSIP_REFERENCE_RUNS:
                tag = f"gossip_reference {algo} {wire} drop={drop}"
                torch.cuda.empty_cache()
                params0 = model.init(0, device="cuda")
                ds = init_dist_state(algo, params0, plan, sgd(), drop=drop, wire=wire)
                dstep = make_dist_train_step(model.loss, algo, sgd(), wire, plan, constant(lr),
                                             gamma=gamma, drop=drop)
                ref = GossipReference(name=algo, plan=plan, wire=wire, drop=drop, gamma=gamma)
                rs, rstep = ref.init(params0), ref.step_fn()
                del params0
                paths = [p for p, _ in leaf_items(rs.params)]
                diffs, ref_s, ref_peak, ref_counts, run_counts = [], [], [], [], []
                for t in range(GOSSIP_REFERENCE_STEPS):
                    batch = stacked_node_batches(dc, t, device="cuda")
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    q.reset_launch_counts()
                    t0 = time.perf_counter()
                    _, _, grads = _node_grads(model.loss, rs.params, batch)
                    rs = rstep(rs, tree_from_items(list(zip(paths, grads))), t, lr)
                    del grads
                    torch.cuda.synchronize()
                    ref_s.append(time.perf_counter() - t0)
                    ref_counts.append({k: v for k, v in q.launch_counts().items() if v})
                    ref_peak.append(torch.cuda.max_memory_allocated())
                    q.reset_launch_counts()
                    ds, _ = dstep(ds, batch)
                    torch.cuda.synchronize()
                    run_counts.append({k: v for k, v in q.launch_counts().items() if v})
                    diffs.append(max(float((a - b).abs().max()) for a, b in
                                     zip(tree_leaves(ds.params), tree_leaves(rs.params))))
                log(f"{tag}: granite-3-2b 1 layer, {n} nodes, ring, lr {lr}: max |runtime - "
                    f"reference| params per step {diffs}")
                log(f"{tag}: reference step_s={ref_s} peak_memory_allocated per step "
                    f"{ref_peak} B ({max(ref_peak) / 2**30:.2f} GiB, runtime state resident); "
                    f"reference launches {ref_counts[0]} a step; runtime {run_counts[0]}")
                assert all(d <= GOSSIP_REFERENCE_ATOL for d in diffs), (tag, diffs)
                assert all(c == per_step for c in ref_counts), (tag, ref_counts, per_step)
                del ds, rs, dstep, rstep
    finally:
        torch.use_deterministic_algorithms(deterministic)
    torch.cuda.empty_cache()
    log(f"gossip_reference (a): {time.perf_counter() - t_phase:.1f} s")
    for argv in COMPARE_RUNS:
        t0 = time.perf_counter()
        q.reset_launch_counts()
        rows = compare_compression.main(argv + ["--device", "cuda"])
        counts = {k: v for k, v in q.launch_counts().items() if v}
        log(f"gossip_reference compare_compression {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}, result {rows}")
        if "--pareto" not in argv:
            assert all(math.isfinite(v) for *_, v in rows), (argv, rows)
    log(f"gossip_reference: {time.perf_counter() - t_phase:.1f} s")


# the analyzer's steps at the train phase's width: (algo, wire, drop)
ANALYSIS_FULL_WIDTH = (("dcd", "quant:8", 0.0), ("dcd", "quant:4", 0.2))


def phase_analysis(torch, q) -> None:
    """One step each of ``ANALYSIS_FULL_WIDTH`` through the step analyzer
    (``step_checks.analyze_case``) at the train phase's width (granite-3-2b,
    1 layer, ring of 8, the ``TrainConfig`` defaults: AdamW, warmup-cosine
    lr, seq 256, batch 32): the report ``ok`` (no float64, no host read of
    a card tensor, only wire containers handed to the transport) and the
    receive launches equal to the calls and to ``decode sites x kernels per
    site``; the dtypes each step handed its transport logged."""
    from repro_torch.analysis import step_checks
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, stacked_node_batches
    from repro_torch.launch.train import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import linear_warmup_cosine

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    tc = TrainConfig(arch="granite-3-2b", reduced=False)
    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
                    n_shards=tc.n_nodes, seed=tc.seed)
    for algo, wire, drop in ANALYSIS_FULL_WIDTH:
        torch.cuda.empty_cache()
        q.reset_launch_counts()
        calls0 = q.call_counts()
        testbed = (model.loss, model.init(tc.seed, device="cuda"),
                   stacked_node_batches(dc, 0, cfg, device="cuda"))
        rep = step_checks.analyze_case(
            algo, tc.topology, wire, drop, n=tc.n_nodes, device="cuda", testbed=testbed,
            opt=make_optimizer(tc.optimizer, weight_decay=0.01),
            lr_schedule=linear_warmup_cosine(tc.lr, tc.warmup, tc.steps))
        del testbed
        counts = q.launch_counts()
        log(f"analysis[{'ok' if rep.ok else 'FAIL'}] granite-3-2b 1 layer {rep.describe()} "
            f"launches={rep.launches} host_reads={rep.host_reads}; wire dtypes handed "
            f"{list(rep.permute_dtypes)}; launches {({k: v for k, v in counts.items() if v})}")
        assert rep.ok and rep.host_reads == 0, (rep.describe(), rep.violations)
        assert rep.launches == rep.kernel_calls == rep.expected_kernels > 0, rep.describe()
        took_the_kernels(q, calls0, counts, K3_K4A if wire == "quant:8" else K1_K2)
    torch.cuda.empty_cache()


def phase_quickstart(torch, q) -> None:
    """The paper's Fig. 1 on the card, held to the JAX package's thresholds
    (tests/test_algorithms.py): dpsgd and 8-bit DCD within 1.2x the optimal
    loss + 1e-3 and 1e-2 of the optimum, 8-bit ECD within 1.5x + 5e-3, and
    naive compression at 4 bits stalling more than 10x farther from the
    optimum than DCD at 4 bits."""
    from repro_torch.examples.quickstart import FIG1, fig1_problem, run_row

    problem = fig1_problem("cuda")
    q.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [(label, algo, bits) for label, algo, bits in FIG1] + [
        ("dcd   (4-bit difference compression)", "dcd", 4),
        ("naive (4-bit models on the wire)", "naive", 4)]
    hist = {}
    for label, algo, bits in rows:
        h = run_row(problem, algo, bits)
        hist[(algo, bits)] = h
        log(f"quickstart {label:42s} final_loss={h['final_loss']:.4f} "
            f"dist_to_opt={h['final_dist_opt']:.2e}")
    counts = q.launch_counts()
    log(f"quickstart: {time.perf_counter() - t0:.1f} s, optimum loss "
        f"{hist[('dpsgd', None)]['opt_loss']:.4f}, launches {counts}")
    for key in (("dpsgd", None), ("dcd", 8)):
        h = hist[key]
        assert h["final_loss"] < 1.2 * h["opt_loss"] + 1e-3, (key, h["final_loss"])
        assert h["final_dist_opt"] < 1e-2, (key, h["final_dist_opt"])
    h = hist[("ecd", 8)]
    assert h["final_loss"] < 1.5 * h["opt_loss"] + 5e-3, h["final_loss"]
    assert hist[("naive", 4)]["final_dist_opt"] > 10 * hist[("dcd", 4)]["final_dist_opt"]
    # block 32: the sends run plain (off the 128-lane gate), every decode a kernel
    assert counts["dequantize_2d"] > 0 and counts["unpack_dequant_2d"] > 0, counts


def phase_reference(torch, algo: str, wire: str, topology: str = "ring", drop=None,
                    n_nodes: int = 4) -> None:
    """Reduced granite, 2 steps: the card (kernels) against the CPU (plain
    versions) from the same params and batches, on ``topology`` with the
    edge drops ``drop``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, stacked_node_batches
    from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.models.api import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params_cpu = model.init(0, device="cpu")
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2 * n_nodes, n_shards=n_nodes,
                    seed=0)
    batches = [stacked_node_batches(dc, t, device="cpu") for t in range(2)]
    plan = make_gossip_plan(topology, n_nodes)
    out, lr = {}, 0.05
    for dev in ("cpu", "cuda"):
        opt = sgd()
        step = make_dist_train_step(model.loss, algo, opt, wire, plan, constant(lr), gamma=0.5,
                                    drop=drop)
        state = init_dist_state(algo, tree_map(lambda p: p.to(dev), params_cpu), plan, opt,
                                drop=drop, wire=wire)
        losses = []
        for b in batches:
            state, met = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(met["loss"]))
        out[dev] = (losses, [l.cpu() for l in tree_leaves(state.params)])
    x0 = [p.unsqueeze(0) for p in tree_leaves(params_cpu)]
    d_cpu = torch.cat([(a - p).flatten() for a, p in zip(out["cpu"][1], x0)])
    d_gpu = torch.cat([(a - p).flatten() for a, p in zip(out["cuda"][1], x0)])
    dl = max(abs(a - b) for a, b in zip(out["cpu"][0], out["cuda"][0]))
    rel = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
    log(f"reference: reduced granite {algo} {wire} {topology} drop={drop} {n_nodes} nodes sgd, "
        f"cuda vs cpu: losses {out['cuda'][0]} "
        f"vs {out['cpu'][0]}, max loss diff {dl:.3e}, relative L2 error of the param change "
        f"{rel:.3e}")
    # bf16 matmuls round differently on the two devices, so losses agree to
    # bf16 accuracy; 4-bit stochastic rounding turns those ~1% gradient
    # differences into occasional one-level code flips of the payload, and
    # the sign codec into sign flips of near-zero differences; the low-rank
    # factors move with the gradients they project
    assert dl <= 1e-3 and rel <= 0.2, (dl, rel)


def phase_reference_stacked(torch) -> None:
    """Stacked DCD over the 8-bit ``RandomQuantizer`` at reduced granite, 4
    nodes, 2 steps: the card (K3, K4a) against the CPU (plain versions) from
    the same params and batches."""
    from repro_torch.configs import get_config
    from repro_torch.core import RandomQuantizer, make_algorithm
    from repro_torch.data import stacked_node_batches
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("granite-3-2b").reduced()
    model, dc = _stacked_setup(cfg, 4, 32, 8)
    params_cpu = model.init(0, device="cpu")
    batches = [stacked_node_batches(dc, t, device="cpu") for t in range(2)]
    out, lr = {}, 0.05
    for dev in ("cpu", "cuda"):
        alg = make_algorithm("dcd", 4, "ring", RandomQuantizer(bits=8, block_size=1024))
        state = alg.init(tree_map(lambda p: p.to(dev), params_cpu))
        step = alg.step_fn()
        losses = [stacked_step(model, step, state, {k: v.to(dev) for k, v in b.items()}, t, lr)
                  for t, b in enumerate(batches)]
        out[dev] = (losses, [l.cpu() for l in tree_leaves(state.params)])
    x0 = [p.unsqueeze(0) for p in tree_leaves(params_cpu)]
    d_cpu = torch.cat([(a - p).flatten() for a, p in zip(out["cpu"][1], x0)])
    d_gpu = torch.cat([(a - p).flatten() for a, p in zip(out["cuda"][1], x0)])
    dl = max(abs(a - b) for a, b in zip(out["cpu"][0], out["cuda"][0]))
    rel = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
    log(f"reference: reduced granite stacked dcd RandomQuantizer(bits=8) lr {lr}, cuda vs cpu: "
        f"losses {out['cuda'][0]} vs {out['cpu'][0]}, max loss diff {dl:.3e}, relative L2 "
        f"error of the param change {rel:.3e}")
    # as phase_reference: bf16 matmuls round differently on the two devices
    assert dl <= 1e-3 and rel <= 0.2, (dl, rel)


# ------------------------------------------------------------ ranks

RANKS = 4
# (algo, wire, steps, the wire's kernels as in TRAIN_RUNS); K6 with a
# non-zero counter offset on every rank but 0
RANK_RUNS = (
    ("dcd", "quant:4", 3, K1_K2),
    ("dpsgd", None, 2, ()),
    ("choco", "sparse:0.05:randk", 2, ("sparse_select_pack_2d", "sparse_scatter_axpy_2d")),
)
# algo -> (what a rank's shifted copies track, their prefix), as INVARIANTS
RANK_INVARIANTS = {"dcd": (None, "rep"), "choco": ("hat_self", "hat")}
# a rank's params against the stacked run's node slice: equal unless cuBLAS
# picks another algorithm for a lone (1, ...) leaf than for a slice of a
# stacked one, which moves the gradients by rounding (and, through the
# stochastic codes, the params by at most a few updates of size lr)
RANK_STACKED_ATOL = 1e-3


def _rank_worker(group, cfg, runs, ref_dir) -> list:
    """One rank of the ranks phase: each ``(TrainConfig, the wire's
    kernels)`` of ``runs`` through ``run_training(group=)``, held by
    ``took_the_kernels``; then one more
    exchange of X (or hat_self) against the rank's replicas (or hats), and
    the params against the stacked run's node slice."""
    import torch

    from repro_torch import trace
    from repro_torch.distributed.transport import RankTransport
    from repro_torch.kernels import quant as q
    from repro_torch.launch.train import run_training
    from repro_torch.tree import leaf_items, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for tc, launched in runs:
        q.reset_launch_counts()
        calls0 = q.call_counts()
        group.stats.reset()
        torch.cuda.reset_peak_memory_stats(group.device)
        trace.enable(True)
        hist = run_training(cfg, tc, group=group)
        trace.enable(False)
        counts = q.launch_counts()
        took_the_kernels(q, calls0, counts, launched)
        state = hist["state"]
        rec = {"losses": hist["losses"], "step_s": hist["step_s"],
               "consensus": hist["consensus"], "counts": counts,
               "sent": dict(group.stats.sent), "seconds": hist["transport"]["seconds"],
               "peak": torch.cuda.max_memory_allocated(group.device)}
        if tc.algo in RANK_INVARIANTS:
            base_key, prefix = RANK_INVARIANTS[tc.algo]
            base = tree_leaves(state.params if base_key is None else state.aux[base_key])
            tp, worst = RankTransport(group), 0.0
            for s in (-1, 1):
                for mine, copy in zip(base, tree_leaves(state.aux[f"{prefix}{s:+d}"])):
                    theirs = tp.exchange({"x": mine}, (s,), label="check")[s]["x"]
                    worst = max(worst, (theirs - copy).abs().max().item())
            rec["invariant"] = worst
        want = ref_dir / f"{tc.algo}_node{group.rank}.pt"
        if want.exists():
            ref_params = torch.load(want, map_location=group.device)
            rec["vs_stacked"] = max((leaf[0] - ref_params[path]).abs().max().item()
                                    for path, leaf in leaf_items(state.params))
            del ref_params
        out.append(rec)
        del hist, state
        torch.cuda.empty_cache()
    return out


def phase_ranks(torch) -> None:
    """RANKS processes, one gossip node each, all on the one card over gloo
    (NCCL refuses two ranks on one GPU), each holding its node's slice of
    granite-3-2b at published widths (1 layer): ``RANK_RUNS`` on the ring,
    the TrainConfig defaults otherwise.  A stacked run of DCD ``quant:4`` at
    n RANKS on the card first: its node slices, saved under ``build/``, are
    what each rank's params are held to.  Logs per run and rank the step,
    exchange and metric times, bytes by label and launches; asserts the
    kernels (``took_the_kernels``, in each rank), ``rep{s}`` (``hat{s}``)
    equal to node ``(i - s)``'s X (hat_self) exactly, equal losses on every
    rank, and the params against the stacked run's."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import TrainConfig
    from repro_torch.tree import leaf_items

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    runs = [(TrainConfig(arch="granite-3-2b", algo=algo, wire=wire or "quant:8", gamma=0.5,
                         topology="ring", n_nodes=RANKS, steps=steps, log_every=1,
                         reduced=False), launched) for algo, wire, steps, launched in RANK_RUNS]
    ref_dir = ROOT / "build" / "chip_smoke_ranks"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    stacked = train_mod.run_training(cfg, runs[0][0], device="cuda")     # DCD quant:4
    for i in range(RANKS):
        torch.save({path: leaf[i].cpu() for path, leaf in leaf_items(stacked["state"].params)},
                   ref_dir / f"dcd_node{i}.pt")
    log(f"ranks: stacked dcd quant:4 at n {RANKS}: losses {stacked['losses']}")
    del stacked
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = spawn_ranks(_rank_worker, RANKS, "gloo", cfg, runs, ref_dir, device="cuda",
                           timeout_s=900)
    log(f"ranks: {RANKS} ranks over gloo on one card ran {len(RANK_RUNS)} runs in "
        f"{time.perf_counter() - t0:.1f} s, process start-up included")
    for ri, (algo, wire, steps, _) in enumerate(RANK_RUNS):
        tag = f"{algo} {wire or 'full precision'}"
        for rank, runs in enumerate(per_rank):
            r = runs[ri]
            exch = sum(v for k, v in r["seconds"].items() if k in ("wire", "dense"))
            log(f"ranks {tag} rank {rank}: step_s={[round(x, 4) for x in r['step_s']]} "
                f"exchange_s={exch:.4f} metric_s={r['seconds'].get('metric', 0.0):.4f} "
                f"sent_bytes={r['sent']} peak_memory_allocated={r['peak']} B launches "
                f"{ {k: v for k, v in r['counts'].items() if v} } invariant "
                f"{r.get('invariant')} params vs the stacked run's {r.get('vs_stacked')}")
            assert all(math.isfinite(v) for v in r["losses"]), r["losses"]
            assert r.get("invariant", 0.0) <= INVARIANT_LIMIT, r["invariant"]
            assert r.get("vs_stacked", 0.0) <= RANK_STACKED_ATOL, r["vs_stacked"]
        losses = [runs[ri]["losses"] for runs in per_rank]
        assert all(l == losses[0] for l in losses), losses
        log(f"ranks {tag}: losses {losses[0]} consensus {per_rank[0][ri]['consensus']}")
    shutil.rmtree(ref_dir, ignore_errors=True)


# ------------------------------------------------------------ serving and families

DEVICE = "cuda"
# architectures whose f32 weights at full depth exceed what the card holds
# beside the serving and forward activations: their depth is cut to fit
SERVE_WEIGHT_BUDGET = 64e9       # bytes of float32 weights
SERVE_DEPTHS = {"deepseek-moe-16b": 27, "mistral-large-123b": 10, "internvl2-76b": 16}
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 6, 3, 32, 16
# decode logits against the full forward's at the same position: bf16 (JAX's
# test_dense_decode_matches_forward holds 5e-2 at the reduced width, where the
# logits' std is about 0.3; at the published widths the logits' scale grows
# with sqrt(d_model), so the bound is 5e-2 per 0.3 of the forward logits'
# std).  Two families are held in float32 compute instead (activations and
# caches), to F32_DECODE_REL of the std, and their bf16 gap is logged: the
# SSM's recurrent float32 decode drifts from the chunked bf16 scan with depth
# (JAX's test_ssm_decode_tracks_forward holds 0.25 of the std at 2-4
# layers), and the MoE router's top-k flips on near ties when the router
# logits round differently in a 3-token decode step and in the whole-sequence
# forward.
DECODE_REL = 5e-2 / 0.3
F32_DECODE_REL = 1e-3


def serve_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=SERVE_DEPTHS[arch]) if arch in SERVE_DEPTHS else cfg


def timed_decode(torch, model, times: list):
    """``model`` whose decode step records its synchronized wall time."""
    real = model.decode_step

    def step(params, caches, tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(params, caches, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return dataclasses.replace(model, decode_step=step)


def teacher_forced(torch, model, cfg, params, seq, frames=None, window=None):
    """Decode ``seq`` (B, S) one position a step from fresh caches; returns
    the (B, S, V) logits."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import layers

    B, S = seq.shape
    caches = model.init_cache(B, S, window=window, device=seq.device)
    if layers.COMPUTE_DTYPE != torch.bfloat16:
        # the caches' bf16 default, in the activations' dtype
        caches = {k: dataclasses.replace(c, **{
            f: getattr(c, f).to(layers.COMPUTE_DTYPE) for f in ("k", "v", "c_kv", "k_rope")
            if hasattr(c, f)}) for k, c in caches.items()}
    if frames is not None:
        caches = ed.encdec_prefill_cross(cfg, params, frames, caches)
    out = []
    for t in range(S):
        logits, caches = model.decode_step(params, caches, seq[:, t:t + 1])
        out.append(logits)
    return torch.cat(out, dim=1)


@contextlib.contextmanager
def compute_dtype(dtype):
    """The models' activation dtype (``COMPUTE_DTYPE``) set to ``dtype``
    for the block."""
    from repro_torch.models import encdec, layers, lm

    mods = (layers, lm, encdec)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d


def decode_forward_gap(torch, model, cfg, params, seq, frames, batch):
    """max |decode - forward| of the logits over every position of ``seq``,
    and the forward logits' std."""
    with torch.no_grad():
        full = model.logits(params, dict(batch, tokens=seq)).float()
    dec = teacher_forced(torch, model, cfg, params, seq, frames).float()
    assert bool(torch.isfinite(full).all()) and bool(torch.isfinite(dec).all())
    return float((dec - full).abs().max()), float(full.std())


def phase_serve(torch, arch: str) -> dict:
    """Serve ``arch`` at its published widths (depth cut only where the f32
    weights would not fit) through ``serve_batch``: 6 requests in batches of
    3, 32-token prompts, 16 new tokens; then the decode logits against the
    full forward's at every position of the first batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves

    cfg = serve_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=DEVICE)
    n_params = sum(l.numel() for l in tree_leaves(params))
    wbytes = 4 * n_params
    assert wbytes <= SERVE_WEIGHT_BUDGET, (arch, wbytes)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    prompts = torch.randint(2, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), generator=gen,
                            device=DEVICE)
    times: list = []
    served = timed_decode(torch, model, times)
    outs, batch_s = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(0, SERVE_REQUESTS, SERVE_BATCH):
        sampler = torch.Generator(device=DEVICE)
        sampler.manual_seed(1)
        tb = time.perf_counter()
        outs.append(serve_batch(served, params, prompts[b:b + SERVE_BATCH], SERVE_NEW, sampler))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_PROMPT + SERVE_NEW
    assert len(times) == len(outs) * steps, (len(times), [o.shape for o in outs])
    last = times[-steps:]                       # the second batch: warm
    prefill_ms = 1e3 * sum(last[:SERVE_PROMPT])
    decode_ms = 1e3 * sum(last[SERVE_PROMPT:]) / SERVE_NEW
    tok_s = SERVE_REQUESTS * steps / wall
    for o in outs:
        assert o.shape == (SERVE_BATCH, SERVE_NEW), o.shape
        assert int(o.min()) >= 0 and int(o.max()) < cfg.vocab, (int(o.min()), int(o.max()))
    batch0 = {"tokens": prompts[:SERVE_BATCH]}
    frames = None
    if cfg.is_encdec:
        frames = torch.randn((SERVE_BATCH, cfg.frontend.n_tokens, cfg.frontend.dim),
                             generator=gen, device=DEVICE)
        batch0["extra_embeds"] = frames
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: model.prefill(params, batch0), iters=3, warmup=1)
    seq = torch.cat([prompts[:SERVE_BATCH], outs[0][:, :SERVE_NEW - 1]], dim=1)
    if cfg.moe:
        # the router drops tokens past an expert's capacity, which depends on
        # the tokens routed together (a decode step's batch, the forward's
        # whole sequence), in JAX as here: hold decode to forward with a
        # capacity no group can overflow, and log the served config's gap
        served_gap = decode_forward_gap(torch, model, cfg, params, seq, frames, batch0)[0]
        log(f"serve {arch}: decode vs forward with capacity_factor "
            f"{cfg.moe.capacity_factor} (tokens dropped past capacity): "
            f"max_abs_err={served_gap:.4g}")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
        model = build_model(cfg)
    err, std = decode_forward_gap(torch, model, cfg, params, seq, frames, batch0)
    rel, in_f32 = DECODE_REL, bool(cfg.ssm or cfg.moe)
    if in_f32:
        log(f"serve {arch}: decode vs forward in bf16 over {seq.shape[1]} positions: "
            f"max_abs_err={err:.4g} logits_std={std:.4g} ({err / std:.4g} of the std)")
        with compute_dtype(torch.float32):
            err, std = decode_forward_gap(torch, model, cfg, params, seq, frames, batch0)
        rel = F32_DECODE_REL
    log(f"serve {arch}: n_layers={cfg.n_layers} of {get_config(arch).n_layers} "
        f"d_model={cfg.d_model} params={n_params} f32_bytes={wbytes} "
        f"requests={SERVE_REQUESTS} batch={SERVE_BATCH} prompt={SERVE_PROMPT} new={SERVE_NEW}")
    log(f"serve {arch}: prefill_ms={prefill_ms:.3f} ({SERVE_PROMPT} decode steps, batch "
        f"{SERVE_BATCH}) "
        f"decode_ms_per_token={decode_ms:.3f} tokens_per_s={tok_s:.1f} "
        f"batch_s={[round(x, 4) for x in batch_s]} prefill_forward_ms={fwd_ms:.3f} "
        f"peak_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    log(f"serve {arch}: decode vs forward {'in float32 ' if in_f32 else ''}over "
        f"{seq.shape[1]} positions: max_abs_err={err:.4g} logits_std={std:.4g} "
        f"bound={rel * std:.4g}")
    assert math.isfinite(err) and math.isfinite(std), arch
    assert err <= rel * std, (arch, err, rel * std)
    if arch == "granite-3-2b":
        # a ring buffer that covers the context is the full cache; a shorter
        # one forgets
        dec = teacher_forced(torch, model, cfg, params, seq).float()
        cover = teacher_forced(torch, model, cfg, params, seq, window=64).float()
        short = teacher_forced(torch, model, cfg, params, seq, window=16).float()
        d_short = float((short - dec).abs().max())
        log(f"serve {arch}: window 64 vs full cache max_abs_diff="
            f"{float((cover - dec).abs().max())}; window 16: {d_short:.4g}")
        assert torch.equal(cover, dec) and d_short > 0.0
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "n_layers": cfg.n_layers, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tokens_per_s": tok_s, "peak": peak}


def phase_chunked(torch) -> None:
    """granite-3-2b ``Model.prefill`` at published width and S
    ``FLASH_THRESHOLD`` (every layer's attention through ``_sdpa_chunked``)
    against the same prefill with the unchunked ``_sdpa``, and layer 0's
    attention both ways on the same q, k, v: within two bf16 ulps."""
    from repro_torch.models import attention as attn
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import apply_rope, dense, rmsnorm
    from repro_torch.models.lm import _layer

    cfg = serve_config("granite-3-2b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, device=DEVICE)
    S = attn.FLASH_THRESHOLD
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)
    with torch.no_grad():
        chunked = model.prefill(params, {"tokens": toks}).float()
        attn.FLASH_THRESHOLD = S + 1
        try:
            plain = model.prefill(params, {"tokens": toks}).float()
        finally:
            attn.FLASH_THRESHOLD = S
        lp = _layer(params["blocks"], 0)
        x = rmsnorm(params["embed"][toks].to(torch.bfloat16), lp["ln1"])
        pos = torch.arange(S, device=DEVICE)
        qkv = [dense(x, lp["attn"][w]).reshape(1, S, h, cfg.hd)
               for w, h in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wv", cfg.n_kv_heads))]
        q, k = (apply_rope(t, pos, cfg.rope_theta) for t in qkv[:2])
        a_chunked = attn._sdpa_chunked(q, k, qkv[2]).float()
        a_plain = attn._sdpa(q, k, qkv[2], attn.causal_mask(S, device=DEVICE)).float()
    err, std = float((chunked - plain).abs().max()), float(plain.std())
    a_err, a_max = float((a_chunked - a_plain).abs().max()), float(a_plain.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(a_max)) - 7)     # bf16's spacing at a_max
    log(f"chunked: granite-3-2b n_layers={cfg.n_layers} prefill S={S}: last-position logits "
        f"max_abs_err={err:.4g} (std {std:.4g}, bound {DECODE_REL * std:.4g}); layer-0 "
        f"attention max_abs_err={a_err:.4g} (max |out| {a_max:.4g}, two bf16 ulps {2 * ulp:.4g})")
    # one layer's attention differs by bf16 rounding of its output (the
    # chunked path normalizes after the PV product, the plain one before);
    # 40 layers compound it as the decode path's do (DECODE_REL)
    assert a_err <= 2 * ulp and err <= DECODE_REL * std, (err, a_err)
    del params
    torch.cuda.empty_cache()


TRAIN_FAMILY_RUNS = (
    # (arch, n_layers, n_nodes, seq_len, global_batch)
    ("mamba2-370m", 12, 8, 256, 32),
    ("deepseek-v2-lite-16b", 2, 2, 256, 4),
)


def phase_train_families(torch, q, arch: str, n_layers: int, n_nodes: int, seq_len: int,
                         global_batch: int, steps: int = 3) -> None:
    """DCD ``quant:8`` at the published widths of a family other than the
    dense decoder; the replicas must stay exactly ``roll(X, s)``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import TrainConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    tc = TrainConfig(arch=arch, algo="dcd", wire="quant:8", topology="ring", n_nodes=n_nodes,
                     steps=steps, seq_len=seq_len, global_batch=global_batch, log_every=1,
                     reduced=False)
    metrics = []
    real = train_mod.make_dist_train_step

    def traced(*args, **kwargs):
        step = real(*args, **kwargs)

        def step_and_record(state, batch):
            state, met = step(state, batch)
            metrics.append({k: float(met[k]) for k in ("lb_loss", "z_loss", "xent")})
            return state, met
        return step_and_record

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    q.reset_launch_counts()
    calls0 = q.call_counts()
    train_mod.make_dist_train_step = traced
    try:
        hist = train_mod.run_training(cfg, tc, device=DEVICE)
    finally:
        train_mod.make_dist_train_step = real
    counts = q.launch_counts()
    took_the_kernels(q, calls0, counts, K3_K4A)
    peak = torch.cuda.max_memory_allocated()
    state = hist["state"]
    leaves = tree_leaves(state.params)
    per_node = sum(l[0].numel() for l in leaves)
    shifts = make_gossip_plan("ring", n_nodes).shift_list
    tag = f"train_families {arch}"
    log(f"{tag}: dcd quant:8 n_layers={n_layers} d_model={cfg.d_model} params/node={per_node} "
        f"leaves={len(leaves)} nodes={n_nodes} seq={seq_len} global_batch={global_batch}")
    log(f"{tag}: losses={hist['losses']} "
        f"lb_loss/z_loss={[(m['lb_loss'], m['z_loss']) for m in metrics]}")
    log(f"{tag}: step_s={[round(s, 4) for s in hist['step_s']]} peak_memory_allocated={peak} B "
        f"({peak / 2**30:.2f} GiB); launches {counts}")
    assert all(math.isfinite(l) for l in hist["losses"]), hist["losses"]
    if cfg.moe:
        assert all(m["lb_loss"] > 0 and m["z_loss"] > 0 for m in metrics), metrics
    resid = max_shift_residual(torch, tree_leaves, state.params,
                               {s: state.aux[f"rep{s:+d}"] for s in shifts})
    log(f"{tag}: invariant rep{{s}} == roll(X, s) for shifts {list(shifts)}: "
        f"max_abs_diff={resid}")
    assert resid <= INVARIANT_LIMIT, resid
    del hist, state
    torch.cuda.empty_cache()


# the dryrun's executed plan: mistral-large-123b at its published widths,
# depth cut 88 -> 1, its plan's 2 nodes and bf16 replicas stacked on the
# card, remat, train_4k's 4096 positions and one sequence a node
EXEC_ARCH, EXEC_LAYERS, EXEC_SEQ = "mistral-large-123b", 1, 4096
# (algo, wire, steps, the kernels the run must launch): every bf16 variant
# launches on a path (CHOCO decodes only into bf16 estimates)
EXEC_RUNS = (
    ("dcd", "quant:8", 3, ("quantize_2d", "dequantize_2d")),
    ("dcd", "quant:4", 3, ("quantize_pack_2d", "unpack_dequant_axpy_2d",
                           "unpack_dequant_axpy_2d_bf16")),
    ("choco", "sign", 3, ("sign_pack_2d", "unpack_sign_axpy_2d_bf16")),
    ("choco", "sparse:0.05:topk", 3, ("sparse_select_pack_2d", "sparse_scatter_axpy_2d_bf16")),
    ("dcd", "lowrank:2:warm", 3, ("lowrank_project_2d", "lowrank_axpy_2d",
                                  "lowrank_axpy_2d_bf16")),
)
DRYRUN_RECORDS = ROOT / "build" / "dryrun" / "records.jsonl"     # git-ignored


def split_cores():
    """Pin this process (and so every thread and process it starts later)
    to all of its cores but the last, and return the cores for the meta
    records' process, so the card's host-bound phases never share a core
    with it."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 1:
        os.sched_setaffinity(0, cores[:-1])
    return {cores[-1]}


def start_meta_records(cores):
    """The dryrun's meta records in a CPU process beside the card's phases
    (they need no device), pinned to ``cores`` with one thread: every arch
    x shape at 1 pod, then mistral's train record at 2 pods, appended to
    ``DRYRUN_RECORDS``."""
    DRYRUN_RECORDS.parent.mkdir(parents=True, exist_ok=True)
    if DRYRUN_RECORDS.exists():
        DRYRUN_RECORDS.unlink()
    mod = f"{sys.executable} -m repro_torch.launch.dryrun --json {DRYRUN_RECORDS}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log_file = open(DRYRUN_RECORDS.with_suffix(".log"), "w")
    return subprocess.Popen(
        ["sh", "-c", f"{mod} && {mod} --multi-pod --arch {EXEC_ARCH} --shape train_4k"],
        env=env, stdout=log_file, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.sched_setaffinity(0, cores)), log_file


def finish_meta_records(proc, log_file) -> list:
    """Wait for the meta records, log each with its build seconds, and hold
    them: every arch x shape at 1 pod and one at 2 pods, each with a
    positive argument size and roofline."""
    proc.wait(timeout=900)
    log_file.close()
    text = DRYRUN_RECORDS.with_suffix(".log").read_text()
    assert proc.returncode == 0, text[-4000:]
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.specs import SHAPES
    recs = [json.loads(l) for l in DRYRUN_RECORDS.read_text().splitlines() if l.strip()]
    assert len(recs) == len(ARCH_IDS) * len(SHAPES) + 1, len(recs)
    for r in recs:
        assert r["memory"]["argument_bytes"] > 0 and r["flops_per_chip"] > 0, r["arch"]
        log(f"dryrun meta {r['arch']} {r['shape']} {'2-pod' if r['multi_pod'] else '1-pod'}: "
            f"build_s={r['build_s']} argument_bytes={r['memory']['argument_bytes']} "
            f"bottleneck={r['bottleneck']} t_compute_s={r['t_compute_s']} "
            f"t_memory_s={r['t_memory_s']} t_collective_s={r['t_collective_s']}")
    log(f"dryrun meta: {len(recs)} records, build_s total "
        f"{sum(r['build_s'] for r in recs):.1f}")
    return recs


def state_nbytes(torch, state) -> int:
    """The bytes of a ``DistState``'s tensors: params, optimizer moments,
    aux trees (replicas, estimates, freshness vectors, codec state)."""
    from repro_torch.tree import leaf_items
    trees = [state.params, state.opt.m, state.opt.v, *state.aux.values()]
    return sum(l.numel() * l.element_size() for t in trees if t is not None
               for _, l in leaf_items(t) if isinstance(l, torch.Tensor))


class ReplicaBound:
    """An elementwise bound on DCD's bf16 replicas, ``|rep{s} - roll(X, s)|``.

    Each step decodes the same delta ``v`` into X (float32, ``X + v``) and
    into each replica (``bf16(float(rep) + v)``), so the replica drifts from
    X only by its roundings: at most ``2^-8 |rep|`` a step for the bf16
    rounding (with room for the float32 sum's and this bound's own) plus
    ``2^-23 |X|`` for the float32 sums, on top of the initial copy's
    rounding.  The bound is kept per element on the host in bf16, rounded
    up; a replica that missed any update exceeds it wherever X moved by
    more than a few of its bf16 roundings, which :meth:`check` counts."""

    def __init__(self, torch, state):
        from repro_torch.tree import tree_leaves
        self.torch, self.leaves = torch, tree_leaves
        self.shifts = sorted(int(k[3:]) for k in state.aux if k.startswith("rep"))
        self.bound = {(s, i): self._store((r.float() - torch.roll(x, s, 0)).abs())
                      for s, pairs in self._pairs(state) for i, (x, r) in enumerate(pairs)}

    def _pairs(self, state):
        X = self.leaves(state.params)
        return [(s, list(zip(X, self.leaves(state.aux[f"rep{s:+d}"])))) for s in self.shifts]

    def _store(self, b):
        # round-to-nearest of b (1 + 2^-7) is at least b
        return (b * (1 + 2.0 ** -7)).to(self.torch.bfloat16).cpu()

    def advance(self, state) -> None:
        """Add one step's roundings (call after each step)."""
        torch = self.torch
        for s, pairs in self._pairs(state):
            for i, (x, r) in enumerate(pairs):
                b = self.bound[s, i].to(x.device).float()
                b += (2.0 ** -8 + 2.0 ** -14) * r.float().abs()
                b += 2.0 ** -23 * torch.roll(x, s, 0).abs() + 2.0 ** -120
                self.bound[s, i] = self._store(b)

    def check(self, state, x0) -> tuple:
        """Hold every replica element within its bound; returns the largest
        gap over bound and the number of elements where a replica left at
        its initial copy ``bf16(x0)`` would be out of bound."""
        torch, worst, stale = self.torch, 0.0, 0
        for s, pairs in self._pairs(state):
            for i, ((x, r), x0l) in enumerate(zip(pairs, self.leaves(x0))):
                b = self.bound[s, i].to(x.device).float()
                rolled = torch.roll(x, s, 0)
                gap = (r.float() - rolled).abs()
                assert bool((gap <= b).all()), (s, i, (gap - b).max().item())
                worst = max(worst, (gap / b.clamp_min(2.0 ** -126)).max().item())
                stale += int(((x0l.to(torch.bfloat16).float() - rolled).abs() > b).sum())
        return worst, stale


def phase_dryrun_plan(torch, q) -> None:
    """The executed plan (``EXEC_RUNS``): mistral-large-123b's training
    plan at its published widths with the depth cut to ``EXEC_LAYERS``, its
    ``n_nodes`` stacked on the card on a ring with its bf16 replicas and its
    remat, random weights (seed 0) and one random sequence of ``EXEC_SEQ``
    tokens a node a step.  Per run the launch counts zeroed before and read
    after, the state's bytes on the card (as built) equal to the meta
    build's count, peak memory, step times (host clock around a step ending
    in a synchronize) and the shared-state invariants: CHOCO's bf16
    ``hat{s}`` exactly ``roll(hat_self, s)``, DCD's bf16 ``rep{s}`` within
    :class:`ReplicaBound` of ``roll(X, s)``, a bound that a replica left at
    its initial value breaks; the records go to netsim's controller."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.distributed.plans import TRAIN_PLANS
    from repro_torch.distributed.wire import make_wire_format
    from repro_torch.launch.dryrun import _gossip_record, _wire_record
    from repro_torch.launch.specs import params_specs
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.netsim import plan_phases_measured
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.tree import tree_leaves
    plan = TRAIN_PLANS[EXEC_ARCH]
    cfg = dataclasses.replace(get_config(EXEC_ARCH), n_layers=EXEC_LAYERS)
    model, n = build_model(cfg), plan.n_nodes
    gossip = make_gossip_plan("ring", n)
    records = []
    for algo, wire, steps, must in EXEC_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        codec, opt = make_wire_format(wire), sgd()
        meta = init_dist_state(algo, params_specs(cfg), gossip, opt, wire=codec,
                               aux_dtype=plan.torch_aux_dtype)
        q.reset_launch_counts()
        state = init_dist_state(algo, model.init(0, device="cuda"), gossip, opt, wire=codec,
                                aux_dtype=plan.torch_aux_dtype)
        step = make_dist_train_step(lambda p, b: model.loss(p, b, remat=plan.remat), algo,
                                    opt, codec, gossip, constant(1e-2))
        built = state_nbytes(torch, state)
        bound = ReplicaBound(torch, state) if algo == "dcd" else None
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        losses, times = [], []
        for _ in range(steps):
            batches = [make_batch(cfg, gen, 1, EXEC_SEQ) for _ in range(n)]
            batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            if bound is not None:
                bound.advance(state)
        tag = f"dryrun plan {EXEC_ARCH} ({EXEC_LAYERS} layer) {algo} {wire}"
        counts = {k: v for k, v in q.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        aux = [l for a, t in state.aux.items() if a.split("+")[0] in ("rep", "hat")
               or a == "hat_self" for l in tree_leaves(t)]
        assert aux and all(l.dtype == torch.bfloat16 for l in aux), tag
        if algo == "choco":
            gap = max_shift_residual(torch, tree_leaves, state.aux["hat_self"],
                                     {1: state.aux["hat+1"]})
            assert gap == 0.0, f"{tag}: hat+1 differs from roll(hat_self, 1) by {gap}"
            shared = f"hat+1 - roll(hat_self, 1) max {gap}"
        else:
            worst, stale = bound.check(state, model.init(0, device="cuda"))
            # the check has teeth: a replica never updated would fail it
            assert stale > 0, f"{tag}: X moved within the replicas' rounding bound"
            shared = (f"rep+1 within its rounding bound of roll(X, 1) (largest gap/bound "
                      f"{worst}); a replica left at bf16(X0) would exceed it at {stale} "
                      f"elements")
            del bound
        meta_bytes = state_nbytes(torch, meta)
        log(f"{tag}: losses={losses} step_s={times} peak_memory_allocated={peak} "
            f"state_bytes={built} meta_state_bytes={meta_bytes} {shared} launches {counts}")
        assert built == meta_bytes, tag
        assert all(math.isfinite(l) for l in losses), tag
        assert all(counts.get(k, 0) > 0 for k in must), (tag, counts)
        records.append({"arch": EXEC_ARCH, "kind": "train", "algo": algo, "wire": wire,
                        **_gossip_record(gossip, algo), "n_nodes": n, "n_layers": EXEC_LAYERS,
                        "aux_dtype": plan.aux_dtype, "remat": plan.remat,
                        "step_time_s": min(times),
                        "wire_bits_per_element": _wire_record(
                            codec, meta.params)["wire_bits_per_element"]})
        del state, step, aux, meta
    pplan = plan_phases_measured(records, total_steps=100)
    log("dryrun plan records: " + json.dumps(records))
    log(f"dryrun plan controller: {pplan.describe()}")
    torch.cuda.empty_cache()


# the kernel phases ``--only`` runs; each takes (torch, the wrappers' module,
# ref, rec): K7's ``kernels/lowrank.py``, the walk's ``kernels/markov.py``
# and the others' ``kernels/quant.py``
KERNEL_PHASES = {"kernels": phase_kernels, "kernels_sign": phase_kernels_sign,
                 "kernels_sparse": phase_kernels_sparse, "kernels_decode": phase_kernels_decode,
                 "kernels_sparse_decode": phase_kernels_sparse_decode,
                 "kernels_lowrank": phase_kernels_lowrank, "kernels_markov": phase_kernels_markov,
                 "kernels_adamw": phase_kernels_adamw}
# the path phases ``--only`` runs; each takes (torch, the wrappers' module)
PATH_PHASES = {"gossip_reference": phase_gossip_reference}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases of " + ", ".join(KERNEL_PHASES) + ", " +
                        ", ".join(PATH_PHASES) + ": build, run just those (checks and times, "
                        "logged) and print no result; to time two trees of the kernels' "
                        "sources against each other, one process a tree")
    only = [name for name in parser.parse_args().only.split(",") if name]
    if any(name not in KERNEL_PHASES and name not in PATH_PHASES for name in only):
        parser.error(f"--only takes {sorted(KERNEL_PHASES) + sorted(PATH_PHASES)}, got {only}")
    meta_cores = split_cores()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import build
    from repro_torch.kernels import lowrank as lk
    from repro_torch.kernels import markov as mk
    from repro_torch.kernels import quant as q
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase_build(build)
    rec = {name: {"err": 0.0} for name in KERNELS}
    modules = {"kernels_lowrank": lk, "kernels_markov": mk, "kernels_adamw": ak}
    if only:
        for name in only:
            if name in PATH_PHASES:
                PATH_PHASES[name](torch, q)
            else:
                KERNEL_PHASES[name](torch, modules.get(name, q), ref, rec)
        log(f"{','.join(only)}: {time.perf_counter() - t0:.1f} s; {gpu_name_and_power()}")
        return 0
    meta_proc = start_meta_records(meta_cores)
    assert sorted(KERNELS) == sorted(q.launch_counts()), sorted(q.launch_counts())
    for name, phase in KERNEL_PHASES.items():
        phase(torch, modules.get(name, q), ref, rec)
    log(f"phases through kernels: {time.perf_counter() - t0:.1f} s")
    for algo, wire, steps, launched in TRAIN_RUNS:
        phase_train(torch, algo, wire, steps, launched, q)
    for algo, comp, per_step in stacked_runs():
        phase_stacked(torch, q, algo, comp, per_step)
    phase_quickstart(torch, q)
    phase_gossip_reference(torch, q)
    phase_analysis(torch, q)
    for label, fields, steps, launched in PLAN_RUNS:
        phase_plan_run(torch, q, label, fields, steps, launched)
    phase_checkpoint(torch, q)
    for run in TRAIN_FAMILY_RUNS:
        phase_train_families(torch, q, *run)
    log(f"phases through train_families: {time.perf_counter() - t0:.1f} s")
    phase_reference(torch, "dcd", "quant:4")
    phase_reference(torch, "choco", "sign")
    phase_reference(torch, "dcd", "lowrank:2:warm")
    phase_reference(torch, "dcd", "quant:8", topology="full_logn", drop=0.1, n_nodes=8)
    phase_reference_stacked(torch)
    torch.cuda.empty_cache()
    log(f"phases through reference: {time.perf_counter() - t0:.1f} s")
    phase_ranks(torch)
    phase_dryrun_plan(torch, q)
    log(f"phases through dryrun: {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import ARCH_IDS
    served = [phase_serve(torch, arch) for arch in ARCH_IDS]
    log("serve summary: " + json.dumps(served))
    log(f"phases through serve: {time.perf_counter() - t0:.1f} s")
    phase_chunked(torch)
    finish_meta_records(*meta_proc)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
                "plain_ms": rec[name]["plain_ms"], "bound_ms": rec[name]["bound"][0],
                "bound_by": rec[name]["bound"][1], "library_ms": rec[name].get("library_ms")}
               for name, (src, replaces) in KERNELS.items()]
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(gpu_name_and_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
