#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train, serve.

    python3 chip_smoke.py

Phases, in one process; any failure exits non-zero and nothing is caught:

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, started together) into ``build/repro_torch/``.
2. kernels — each kernel against its plain PyTorch version on the card at
   the training path's shapes: for ``quant:4`` (K1, K2) and ``sign`` (K5a,
   K5b) the ``lm_head`` fold 802,816 x 1024 and the ``wk`` fold 16,384 x 512,
   for ``sparse`` (K6, K6c) the ``lm_head`` fold 6,324,224 x 128 and the
   ``wk`` fold 65,536 x 128, and a small ragged case; rows with all zeros,
   -0.0, a NaN and exact ties, and for K6 also an all-NaN row, NaNs past k,
   +-inf, a tie across a lane boundary and ties past a lane's span; K6 at
   p 0.05, 0.25 and 1.0 in f32 and f16; the bf16-accumulator variants of
   K2, K5b, K6c and K7b at the same folds (a bf16 accumulator with a zero
   row, -0.0 and a NaN; weights 1 and an ECD-like decay 0.75).  Words,
   indices, values, scales and floats
   must be bit-equal (a NaN matching any NaN).  Each is timed with CUDA
   events beside its bound (bytes moved over 3.35 TB/s, or operations over
   67 TFLOP/s, whichever is larger) and beside its plain version; K6 at
   p 0.05 topk and p 0.25 randk, beside ``torch.topk`` (selection only);
   K4a beside ``torch.mul`` of the int8 codes and the per-row factor.  For
   ``lowrank`` (K7a, K7b) the folds are whole leaves with their lead batch
   of 8: ``lm_head`` (2048 x 49408) and ``embed`` (49408 x 2048), each with
   the cold factor shared at batch stride 0 and with warm per-slab factors,
   ``wk`` (2048 x 512), a norm leaf (1 x 2048) and a ragged 37 x 384 fold,
   at ranks 1, 2, 4 and 128 (the largest), with zeros, -0.0 and a NaN row;
   their rank-2 ``lm_head`` times stand beside the one PyTorch call that
   computes the same function (``torch.bmm``, ``torch.baddbmm``).  K1 on a
   row holding a NaN: NaN scale, the row's other codes bit-equal, an all-NaN
   decode (K4b and K2).  K1, K3 and K6 random-k (p 0.05 and 0.25, and at
   512 and 2048 columns) with a counter offset, at a rank's folds (one node's
   rows of the ``lm_head`` leaf of 4 stacked nodes): each node's rows at
   offset ``i*rows*cols`` equal those rows of the whole fold and the plain
   version, and an offset that wraps past 2^32 too.  For the 8-bit and
   dense-decode kernels: K3 (8
   bits, with K4a) and K4b (4 bits) at the same ``lm_head``, ``wk`` and
   ragged folds as K1, K4a and K4b also at block 32 (the quickstart's), K3 on
   a NaN row; K6b at the ``sparse`` ``lm_head`` fold (p = 0.25 randk, k = 32,
   and p = 0.05 topk), the ``wk`` fold and a ragged one with f16 values, its
   rows holding zeros, -0.0 (a whole row, so -0.0 values are kept), a NaN
   and ties.  K6c's and K7b's paths at their edges (``k6c_edges``,
   ``k7b_edges``), both accumulator types, each case logged with the path
   it took: K6c at k 1, 8 (the rows path) and 9 (the slot-map path), f32
   and f16 values, 1 and 200,003 rows, indices past the row at 384 columns;
   K7b at ranks 1, 2, 4 (the rows path) and 3, 5, 128 (the scalar path),
   rows 1 and 17, n 128 and 49408, cold and warm, a -0.0 dot on a -0.0 row;
   each on an accumulator of its own, one a row into a buffer and one off
   16-byte alignment (the scalar accesses), into a fresh ``out`` and in
   place.  Beside each receive's time the same-bytes yardstick
   ``torch.mul(acc, 1.0, out=out)`` (the accumulator's bytes, not the same
   function), and for bf16 K7b ``torch.baddbmm`` on bf16 factors (the
   nearest library call, not the same function); the registers and local
   bytes of K6c's and K7b's kernel instances (``cudaFuncGetAttributes``).
   The data layer's Markov walk (``phase_kernels_markov``) against the eager
   walk, token for token, at the cells' batches (32 x 49,155 x 256 and 8 x
   50,280 x 1,024) and a rank's 4 rows, three seeds each; timed beside the
   eager walk, one CTA a row, its fixed cost and its lower bound
   (``markov_bound``: the operations a candidate needs, each unit at its
   peak rate).  The optim layer's AdamW update (``phase_kernels_adamw``)
   against the eager body, m, v and the update bit for bit, at granite's
   largest stacked leaf (f32 and bf16 g and p) and a ragged one; timed
   beside its bound (28 B an element), the eager body and
   ``torch._fused_adamw_``.
   ``--only kernels_sparse,kernels_lowrank`` (any of ``KERNEL_PHASES``)
   builds and runs just those phases and prints no result: to time a
   parent's kernels against a change's, one process a tree.
3. train   — granite-3-2b at full width with its depth cut to one layer,
   8 nodes stacked on the card, ring, through
   ``repro_torch.launch.train.run_training``: DCD and ECD over ``quant:4``,
   CHOCO (gamma 0.5) and DeepSqueeze over ``sign``, CHOCO over
   ``sparse:0.05:topk``, DCD over ``lowrank:2:warm`` and ``lowrank:2``,
   CHOCO over ``adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4``
   and DCD over ``quant:8``, the runtime's default wire (K3 sends, K4a
   decodes and the axpy in torch).
   Each run's kernel launch counts are zeroed just before it and read just
   after; each kernel of the run's wire must show its launches a step (12
   sends, 36 receives for DCD, ECD and CHOCO, 48 for DeepSqueeze; 11 K7a and
   33 K7b for DCD over ``lowrank``, one per matrix leaf and 1 + 2 shifts
   per matrix leaf; under ``adaptive`` 1 K1 + 3 K2 for ``embed`` and 8 K7a
   + 24 K7b for the other matrices) and every other kernel none, but the
   data's Markov walk, one launch a step (``WALK_PER_STEP``), and AdamW's
   update, one launch a leaf a step (``ADAMW_PER_STEP``, in the runs of
   ``run_training``), as many calls as launches, here and in every run of
   the phases below.  The
   shared-state invariants ``rep{s} == roll(X, s)`` (DCD),
   ``tilde{s} == roll(tilde_self, s)`` (ECD) and ``hat{s} ==
   roll(hat_self, s)`` (CHOCO) are checked, and every non-zero warm factor
   must change every step.
4. stacked — the paper-facing reference path (``repro_torch.core``) at
   the same full width: 8 nodes on ``make_algorithm(..., "ring", ...)``,
   constant lr 3e-3, per-node gradients of the port's model, integer step
   keys, 2 steps each of DCD with ``RandomQuantizer(bits=8,
   use_kernel=True)`` (12 K3 + 12 K4a a step), ECD with
   ``RandomQuantizer(bits=4)`` (12 K1 + 12 K4b) and DCD with
   ``RandomSparsifier(p=0.25)`` (12 K6 + 12 K6b); finite losses and
   consensus distances.
5. quickstart — the paper's Fig. 1 table (``repro_torch.examples.quickstart``)
   on the card, held to the JAX package's test thresholds.
   gossip_reference — the runtime and ``repro_torch.core.GossipReference``
   side by side at the train phase's width on a ring of 4 nodes, SGD at a
   constant lr, 3 steps each of DCD ``quant:4`` and CHOCO ``sign`` (gamma
   0.7) at drop 0.2 and DCD ``lowrank:2:warm``: params within 1e-5 after
   every step, the reference's launches a step (its sends and dense decodes,
   no receive kernel), its step time and peak memory; then
   ``repro_torch.examples.compare_compression`` on the card with
   ``--pareto``, ``--lowrank``, ``--drop-rate 0.2`` and ``--error-feedback
   --algo choco --wire sign`` (``--quick``), whose gates fail the run.
   ``--only gossip_reference`` runs just this phase and prints no result.
   analysis — the port's ``repro_torch.analysis`` on the card: the lint of
   the port's files (0 findings); one step of each of the 19 cases of the
   JAX package's representative grid on its toy testbed
   (``step_checks.run_sweep``): every case ``ok``, each wrapper's launches
   equal to its calls, the receive launches equal to ``decode sites x
   kernels per site`` (> 0 for every wire case), no float64 and no host
   read of a card tensor inside the step, only wire containers handed to
   the transport; then one step each of DCD ``quant:8`` and DCD ``quant:4``
   at drop 0.2 at the train phase's width and ``TrainConfig`` defaults,
   with the same checks and the dtypes each handed its transport.  ``--only
   analysis`` runs just this phase and prints no result.
6. plans — the rest of the runtime at the train phase's width (``PLAN_RUNS``):
   R1 naive ``quant:4`` on a chain with drops at 0.1 (K1 sends, K4b decodes
   every neighbour densely), R2 DCD ``quant:8`` on ``full_logn`` (three
   rounds a step) with drops, R3 DCD ``quant:4`` on ``exp`` (one round a
   step), R4 D-PSGD on a chain with drops, R5 C-PSGD, R6 DCD on the phase
   plan ``0@ring@quant:8;2@full_logn@quant:4``.  Launch totals asserted;
   replicas equal ``roll(X, s)`` exactly on the rows whose edges never
   dropped and right after the rekey; the drops and freshness replayed on the
   host give the runtime's freshness and realized mixing rows that sum to 1;
   C-PSGD's replicas stay identical with consensus 0.  R7: DCD ``quant:4``
   at the reduced width, 4 steps saving every 2, then a run resumed from
   step 2: the restored state, losses and final state bit-equal.  Before the
   runs, K6's persistent grid is logged for every kernel instance.
7. profile — device time by kernel over a further 2-step DCD ``quant:4``
   run, a 2-step CHOCO ``sign`` run, a 2-step CHOCO ``sparse:0.05:topk``
   run, a 2-step DCD ``lowrank:2:warm`` run, a 2-step DCD ``quant:8`` run
   and 2 steps each of the stacked ECD 4-bit and DCD random-k 0.25 runs.
8. reference — reduced granite runs (DCD ``quant:4``, CHOCO ``sign``, DCD
   ``lowrank:2:warm``, DCD ``quant:8`` on ``full_logn`` with drops, and
   stacked DCD over 8-bit ``RandomQuantizer``) on the card against the same
   runs on the CPU (the kernels' plain versions), same params and batches.

9. train_families — DCD ``quant:8`` (K3 sends, K4a decodes) at the
   published widths of two more families, 3 steps each: mamba2-370m (12 of
   its 48 layers, 8 nodes) and deepseek-v2-lite-16b (MLA, the dense first
   layer ``blocks0`` and one MoE layer; 2 nodes).  Launch counts, losses
   finite, ``lb_loss`` and ``z_loss`` non-zero for the MoE, replicas exactly
   ``roll(X, s)``.
10. serve — every architecture of ``ARCH_IDS`` at its published widths
   through ``repro_torch.launch.serve.serve_batch``: params on the card from
   a seed, 6 requests in batches of 3, 32-token prompts, 16 new tokens;
   depth cut only where the float32 weights would pass ``SERVE_WEIGHT_BUDGET``
   (``SERVE_DEPTHS``).  Prints the prefill ms (the 32 prompt steps through
   the decode step), decode ms per token, tokens/s, ``Model.prefill`` ms and
   the serving's peak memory, and profiles 4 decode steps of three archs
   (``SERVE_PROFILED``); holds every decode step's logits to
   ``Model.logits`` of the full forward at the same position (bf16, or
   float32 for the SSM and MoE families; see ``DECODE_REL``); on
   granite-3-2b, a ring buffer that covers the context equals the full cache
   and a shorter one differs.
11. chunked — granite-3-2b ``Model.prefill`` at S 4096 through
   ``_sdpa_chunked`` against the unchunked ``_sdpa``, and layer 0's attention
   both ways.
12. families — each family at its ``reduced()`` width: the card against the
   CPU, 16 greedy decode steps from the same params and prompts.
13. ranks (run after the reference phase, before serve) — the rank-per-node
   runtime: 4 processes, one gossip node each, share the card over gloo
   (NCCL refuses two ranks on one GPU), each holding its node's slice of
   granite-3-2b at published widths (1 layer), ring, ``TrainConfig``
   defaults: DCD ``quant:4`` 3 steps (the main path), D-PSGD 2 steps, CHOCO
   ``sparse:0.05:randk`` 2 steps.  Per run and rank: step time (host clock,
   each step ending in a synchronize and a barrier), exchange time (staging
   and ``batch_isend_irecv``), metric time, bytes sent by label, launches (12
   sends and 36 receives a step on every rank).  After the steps one more
   exchange shows ``rep{s}`` (``hat{s}``) equal to node ``(i - s)``'s X
   (hat_self) exactly; each rank's DCD params are held to a stacked n-4 run
   on the card (``RANK_STACKED_ATOL``, bit-equality logged).
14. dryrun (after ranks, before serve) — the port's dryrun
   (``repro_torch.launch.dryrun``): its smoke on the card (reduced
   granite-3-2b, DCD ``quant:8``, 2 nodes, 2 executed steps with remat);
   mistral-large-123b's training plan executed at its published widths with
   the depth cut 88 -> 1 (``EXEC_RUNS``: its plan's 2 nodes stacked, bf16
   replicas, remat, 4096 positions, one sequence a node; DCD ``quant:8`` and
   ``quant:4``, CHOCO ``sign`` and ``sparse:0.05:topk``, DCD
   ``lowrank:2:warm``, 2 steps each, so that every bf16-accumulator kernel
   launches): per run the launches, step times, peak memory and the state's
   bytes on the card, equal to the meta build's count, and one more step
   under ``torch.profiler`` for each kernel's device ms a step; CHOCO's bf16
   estimates exactly ``roll(hat_self, 1)``, DCD's bf16 replicas elementwise
   within the bound of their roundings from ``roll(X, 1)`` that a replica
   never updated would break (``ReplicaBound``); the runs' records through
   netsim's ``plan_phases_measured``.  The meta records of every arch x
   shape (and mistral's train record at 2 pods) are built by a CPU process
   started after the build, beside the card's phases on a core of its own
   (this process keeps the others), into ``DRYRUN_RECORDS``, and logged
   with their build seconds at the end.

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

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published peak at 700 W
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
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


def bound(nbytes: int, f32_ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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


# kernel name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "quantize_pack_2d": ("src/repro_torch/kernels/csrc/quant.cu",
                         "src/repro/kernels/quant.py:284"),
    "unpack_dequant_axpy_2d": ("src/repro_torch/kernels/csrc/quant.cu",
                               "src/repro/kernels/quant.py:367"),
    "quantize_2d": ("src/repro_torch/kernels/csrc/quant.cu", "src/repro/kernels/quant.py:253"),
    "dequantize_2d": ("src/repro_torch/kernels/csrc/quant.cu", "src/repro/kernels/quant.py:323"),
    "unpack_dequant_2d": ("src/repro_torch/kernels/csrc/quant.cu",
                          "src/repro/kernels/quant.py:343"),
    "sign_pack_2d": ("src/repro_torch/kernels/csrc/sign.cu", "src/repro/kernels/quant.py:612"),
    "unpack_sign_axpy_2d": ("src/repro_torch/kernels/csrc/sign.cu",
                            "src/repro/kernels/quant.py:648"),
    "sparse_select_pack_2d": ("src/repro_torch/kernels/csrc/sparse.cu",
                              "src/repro/kernels/quant.py:503"),
    "sparse_unpack_scatter_2d": ("src/repro_torch/kernels/csrc/sparse.cu",
                                 "src/repro/kernels/quant.py:544"),
    "sparse_scatter_axpy_2d": ("src/repro_torch/kernels/csrc/sparse.cu",
                               "src/repro/kernels/quant.py:684"),
    "lowrank_project_2d": ("src/repro_torch/kernels/csrc/lowrank.cu",
                           "src/repro/kernels/lowrank.py:67"),
    "lowrank_axpy_2d": ("src/repro_torch/kernels/csrc/lowrank.cu",
                        "src/repro/kernels/lowrank.py:92"),
    # the bf16-accumulator variants of the four receives (bf16 replicas and
    # estimates); the JAX package widens the accumulator and runs the same
    # TPU kernel
    "unpack_dequant_axpy_2d_bf16": ("src/repro_torch/kernels/csrc/quant.cu",
                                    "src/repro/kernels/quant.py:367"),
    "unpack_sign_axpy_2d_bf16": ("src/repro_torch/kernels/csrc/sign.cu",
                                 "src/repro/kernels/quant.py:648"),
    "sparse_scatter_axpy_2d_bf16": ("src/repro_torch/kernels/csrc/sparse.cu",
                                    "src/repro/kernels/quant.py:684"),
    "lowrank_axpy_2d_bf16": ("src/repro_torch/kernels/csrc/lowrank.cu",
                             "src/repro/kernels/lowrank.py:92"),
    # the data layer's Markov walk; the JAX package samples its walk with
    # threefry keys and no TPU kernel
    "markov_walk": ("src/repro_torch/kernels/csrc/markov.cu", "none"),
    # the optim layer's AdamW update; the JAX package's AdamW is jnp that XLA
    # fuses
    "adamw_update": ("src/repro_torch/kernels/csrc/adamw.cu", "none"),
}
# the data's Markov walk takes its kernel once a batch, so once a training step
WALK_PER_STEP = {"markov_walk": 1}
# AdamW, ``run_training``'s optimizer, takes its kernel once a leaf a step:
# the 12 leaves of granite-3-2b at one layer
ADAMW_PER_STEP = {"adamw_update": 12}
# (aw, w) of the bf16-accumulator checks: DCD's and CHOCO's 1.0, and an
# ECD-like decay
BF16_WEIGHTS = ((1.0, 1.0), (0.75, -0.5))
# the CUDA symbols of those kernels, for the profile
KERNEL_SYMBOLS = ("quantize_pack_kernel", "unpack_dequant_axpy_kernel", "quantize_kernel",
                  "dequantize_kernel", "unpack_dequant_kernel", "sign_pack_kernel",
                  "unpack_sign_axpy_kernel", "sparse_select_pack_",
                  "sparse_unpack_scatter_kernel", "sparse_scatter_axpy_",
                  "lowrank_project_kernel", "lowrank_axpy_", "markov_walk_kernel",
                  "adamw_update_kernel")


def max_abs_err(a, b) -> float:
    """max |a - b| where neither is NaN (equal infinities differ by 0)."""
    ok = ~(a.isnan() | b.isnan())
    af, bf = a.float(), b.float()
    d = (af - bf).abs().masked_fill(af == bf, 0.0)[ok]
    return d.max().item() if d.numel() else 0.0


def edge_rows(x, ties: bool):
    """All-zero row, -0.0 entries, a NaN, and (for selection) exact ties."""
    x[0].zero_()
    x[1, :7] = -0.0
    x[2, 5] = float("nan")
    if ties:
        x[3, :] = 0.75
        x[3, 1::2] = -0.75
        x[4, 10:40] = 0.5
    return x


def bf16_acc(torch, acc, dtype=None):
    """A bfloat16 (or ``dtype``) accumulator copied from ``acc`` with edge
    entries: a zero row, -0.0 entries and a NaN (rows of the last two
    dims)."""
    a = acc.to(dtype or torch.bfloat16, copy=True)
    rows = a.view(-1, a.shape[-1])
    rows[0].zero_()
    rows[min(1, rows.shape[0] - 1), :7] = -0.0
    rows[min(2, rows.shape[0] - 1), 3] = float("nan")
    return a


def check(ref, rec: dict, name: str, label: str, got, want, what: str) -> None:
    """Kernel outputs against their plain version's: bit-equal
    (``ref.same_bits``), or fail."""
    ok = all(ref.same_bits(g, w) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want) if g.is_floating_point()) \
        if any(g.is_floating_point() for g in got) else 0.0
    rec[name]["err"] = max(rec[name]["err"], err)
    log(f"kernel {name} {label} ({what}): bit_equal={ok} max_abs_err={err}")
    assert ok, f"{name} disagrees with its plain version at {label} ({what})"


def check_nan_row(torch, ref, name: str, label: str, got, want, bits: int, row: int,
                  lane: int, decoded) -> None:
    """A quantize kernel's (codes, scale) for a fold whose ``row`` holds a NaN
    at ``lane``: the row's scale is NaN, every other row and every other code
    of the row bit-equal to the plain version, and each tensor of
    ``decoded`` (that row decoded) all NaN.  The NaN element's own code is a
    NaN cast to an integer, implementation-defined on both sides."""
    (gc, gs), (wc, ws) = got, want
    keep = torch.ones(gc.shape[0], dtype=torch.bool, device=gc.device)
    keep[row] = False
    rows_equal = torch.equal(gc[keep], wc[keep]) and ref.same_bits(gs, ws)

    def codes(c):
        return ref.unpack_codes(c, bits=bits) if c.dtype == torch.int32 else c
    cg, cw = codes(gc[row:row + 1]), codes(wc[row:row + 1])
    lanes = torch.ones(cg.shape[1], dtype=torch.bool, device=cg.device)
    lanes[lane] = False
    row_codes_equal = torch.equal(cg[:, lanes], cw[:, lanes])
    nan_scale = bool(gs[row].isnan().all())
    all_nan = [bool(d.isnan().all()) for d in decoded]
    log(f"kernel {name} {label} (NaN at row {row} lane {lane}): scale NaN={nan_scale}, "
        f"other rows bit_equal={rows_equal}, the row's other codes bit_equal="
        f"{row_codes_equal}, decoded all NaN={all_nan}")
    assert nan_scale and rows_equal and row_codes_equal and all(all_nan), name


def log_times(rec: dict, names) -> None:
    """Each kernel's time at its ``lm_head`` fold beside its bound (and its
    share of it), its plain version, its library call and, for the
    receives, the same-bytes yardstick ``torch.mul(acc, 1.0, out=out)``
    (it moves the accumulator's bytes, not the same function)."""
    for name in names:
        r = rec[name]
        lib = f", library {r['library_ms']:.4f} ms" if r.get("library_ms") is not None else ""
        yard = f", yardstick torch.mul {r['yardstick_ms']:.4f} ms" if "yardstick_ms" in r else ""
        log(f"time {name} lm_head: kernel {r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it), plain "
            f"{r['plain_ms']:.2f} ms{lib}{yard}")


def phase_kernels(torch, q, ref, rec: dict, bits: int = 4) -> None:
    """K1/K2 vs plain version at the ``quant:4`` path's shapes; fills
    ``rec`` with errors, times and bounds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    shapes = [("lm_head", 802816, 1024), ("wk", 16384, 512), ("ragged", 37, 256)]
    for label, rows, cols in shapes:
        x = torch.randn((rows, cols), generator=gen, device=dev) * 0.02
        x[0].zero_()                                   # all-zero row: scale 0 -> 1
        x[1, :7] = -0.0
        seed = 0x9E3779B9 ^ rows
        words, scale = q.quantize_pack_2d(x, seed, bits=bits)
        torch.cuda.synchronize()
        check(ref, rec, "quantize_pack_2d", label, (words, scale),
              ref.quantize_pack_2d_ref(x, seed, bits=bits), f"{rows}x{cols}, {bits}-bit")
        acc = torch.randn((rows, cols), generator=gen, device=dev)
        for aw, w in ((1.0, 1.0), (-1.0, 2.0)):
            out = q.unpack_dequant_axpy_2d(words, scale, acc, bits=bits, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "unpack_dequant_axpy_2d", label, (out,),
                  (ref.unpack_dequant_axpy_2d_ref(words, scale, acc, bits=bits, weight=w,
                                                  acc_weight=aw),), f"aw={aw}, w={w}")
            del out
        accb = bf16_acc(torch, acc)
        for aw, w in BF16_WEIGHTS:
            out = q.unpack_dequant_axpy_2d(words, scale, accb, bits=bits, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "unpack_dequant_axpy_2d_bf16", label, (out,),
                  (ref.unpack_dequant_axpy_2d_ref(words, scale, accb, bits=bits, weight=w,
                                                  acc_weight=aw),), f"bf16 acc, aw={aw}, w={w}")
            del out
        xn = x.clone()
        xn[2, 5] = float("nan")
        got = q.quantize_pack_2d(xn, seed, bits=bits)
        torch.cuda.synchronize()
        w2, s2 = got[0][2:3].contiguous(), got[1][2:3].contiguous()
        check_nan_row(torch, ref, "quantize_pack_2d", label, got,
                      ref.quantize_pack_2d_ref(xn, seed, bits=bits), bits, 2, 5,
                      (q.unpack_dequant_2d(w2, s2, bits=bits),
                       q.unpack_dequant_axpy_2d(w2, s2, acc[2:3].contiguous(), bits=bits,
                                                weight=1.0)))
        del xn, got, w2, s2
        if label == "lm_head":
            W = words.shape[1]
            out = torch.empty_like(acc)
            k1 = time_ms(torch, lambda: q.quantize_pack_2d(x, seed, bits=bits), 10)
            k1p = time_ms(torch, lambda: ref.quantize_pack_2d_ref(x, seed, bits=bits), 2, 1)
            k2 = time_ms(torch, lambda: q.unpack_dequant_axpy_2d(
                words, scale, acc, bits=bits, weight=1.0, acc_weight=1.0, out=out), 10)
            k2p = time_ms(torch, lambda: ref.unpack_dequant_axpy_2d_ref(
                words, scale, acc, bits=bits, weight=1.0, acc_weight=1.0), 2, 1)
            n = rows * cols
            rec["quantize_pack_2d"].update(
                ms=k1, plain_ms=k1p,
                bound=bound(n * 4 + rows * W * 4 + rows * 4, 8 * n))
            rec["unpack_dequant_axpy_2d"].update(
                ms=k2, plain_ms=k2p,
                bound=bound(rows * W * 4 + rows * 4 + 2 * n * 4, 3 * n))
            outb = torch.empty_like(accb)
            rec["unpack_dequant_axpy_2d_bf16"].update(
                ms=time_ms(torch, lambda: q.unpack_dequant_axpy_2d(
                    words, scale, accb, bits=bits, weight=1.0, acc_weight=1.0, out=outb), 10),
                plain_ms=time_ms(torch, lambda: ref.unpack_dequant_axpy_2d_ref(
                    words, scale, accb, bits=bits, weight=1.0, acc_weight=1.0), 2, 1),
                bound=bound(rows * W * 4 + rows * 4 + 2 * n * 2, 3 * n))
            log_times(rec, ("quantize_pack_2d", "unpack_dequant_axpy_2d",
                            "unpack_dequant_axpy_2d_bf16"))
            del out, outb
        del x, words, scale, acc, accb
        torch.cuda.empty_cache()


def phase_kernels_sign(torch, q, ref, rec: dict) -> None:
    """K5a (both scale modes) and K5b vs plain version at the ``sign`` path's
    shapes (block 1024, the wk leaf's 512)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    for label, rows, cols in [("lm_head", 802816, 1024), ("wk", 16384, 512),
                              ("ragged", 37, 384)]:
        x = edge_rows(torch.randn((rows, cols), generator=gen, device=dev) * 0.02, ties=True)
        for mode in ("mean", "l2"):
            words, scale = q.sign_pack_2d(x, scale_mode=mode)
            torch.cuda.synchronize()
            check(ref, rec, "sign_pack_2d", label, (words, scale),
                  ref.sign_pack_2d_ref(x, scale_mode=mode), f"{rows}x{cols}, {mode}")
        acc = torch.randn((rows, cols), generator=gen, device=dev)
        for aw, w in ((1.0, 1.0), (1.0, -1.0)):
            out = q.unpack_sign_axpy_2d(words, scale, acc, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "unpack_sign_axpy_2d", label, (out,),
                  (ref.unpack_sign_axpy_2d_ref(words, scale, acc, weight=w, acc_weight=aw),),
                  f"aw={aw}, w={w}")
            del out
        accb = bf16_acc(torch, acc)
        for aw, w in BF16_WEIGHTS:
            out = q.unpack_sign_axpy_2d(words, scale, accb, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "unpack_sign_axpy_2d_bf16", label, (out,),
                  (ref.unpack_sign_axpy_2d_ref(words, scale, accb, weight=w, acc_weight=aw),),
                  f"bf16 acc, aw={aw}, w={w}")
            del out
        if label == "lm_head":
            out = torch.empty_like(acc)
            n, W = rows * cols, words.shape[1]
            rec["sign_pack_2d"].update(
                ms=time_ms(torch, lambda: q.sign_pack_2d(x), 10),
                plain_ms=time_ms(torch, lambda: ref.sign_pack_2d_ref(x), 2, 1),
                bound=bound(n * 4 + rows * W * 4 + rows * 4, 3 * n))
            rec["unpack_sign_axpy_2d"].update(
                ms=time_ms(torch, lambda: q.unpack_sign_axpy_2d(
                    words, scale, acc, weight=1.0, acc_weight=1.0, out=out), 10),
                plain_ms=time_ms(torch, lambda: ref.unpack_sign_axpy_2d_ref(
                    words, scale, acc, weight=1.0, acc_weight=1.0), 2, 1),
                bound=bound(rows * W * 4 + rows * 4 + 2 * n * 4, 3 * n))
            outb = torch.empty_like(accb)
            rec["unpack_sign_axpy_2d_bf16"].update(
                ms=time_ms(torch, lambda: q.unpack_sign_axpy_2d(
                    words, scale, accb, weight=1.0, acc_weight=1.0, out=outb), 10),
                plain_ms=time_ms(torch, lambda: ref.unpack_sign_axpy_2d_ref(
                    words, scale, accb, weight=1.0, acc_weight=1.0), 2, 1),
                bound=bound(rows * W * 4 + rows * 4 + 2 * n * 2, 3 * n))
            log_times(rec, ("sign_pack_2d", "unpack_sign_axpy_2d", "unpack_sign_axpy_2d_bf16"))
            del out, outb
        del x, words, scale, acc, accb
        torch.cuda.empty_cache()


def phase_kernels_sparse(torch, q, ref, rec: dict) -> None:
    """K6 (topk and randk) and K6c vs plain version at the ``sparse`` path's
    shapes (block 128) and K6's selection edge rows; K6 at p 0.05, 0.25 and
    1.0 in f32 and f16.  K6 timed at p 0.05 topk (with ``torch.topk`` beside
    it, selection only: it neither orders ties canonically nor packs) and at
    p 0.25 randk."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    seed = 0x51A7E
    for label, rows, cols in [("lm_head", 6324224, 128), ("wk", 65536, 128),
                              ("ragged", 37, 384)]:
        x = edge_rows(torch.randn((rows, cols), generator=gen, device=dev) * 0.02, ties=True)
        x = ref.sparse_selection_edge_rows(x, 5)
        for mode in ("topk", "randk"):
            for p, vdt in [(p, vdt) for p in (0.05, 0.25, 1.0)
                           for vdt in (torch.float32, torch.float16)]:
                got = q.sparse_select_pack_2d(x, seed, p=p, mode=mode, value_dtype=vdt)
                torch.cuda.synchronize()
                check(ref, rec, "sparse_select_pack_2d", label, got,
                      ref.sparse_select_pack_2d_ref(x, seed, p=p, mode=mode, value_dtype=vdt),
                      f"{rows}x{cols}, {mode}, p={p}, {vdt}")
                del got
        vals, idx = q.sparse_select_pack_2d(x, seed, p=0.05, mode="topk")
        acc = torch.randn((rows, cols), generator=gen, device=dev)
        for aw, w in ((1.0, 1.0), (1.0, -1.0)):
            out = q.sparse_scatter_axpy_2d(vals, idx, acc, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "sparse_scatter_axpy_2d", label, (out,),
                  (ref.sparse_scatter_axpy_2d_ref(vals, idx, acc, weight=w, acc_weight=aw),),
                  f"aw={aw}, w={w}")
            del out
        accb = bf16_acc(torch, acc)
        for aw, w in BF16_WEIGHTS:
            out = q.sparse_scatter_axpy_2d(vals, idx, accb, weight=w, acc_weight=aw)
            torch.cuda.synchronize()
            check(ref, rec, "sparse_scatter_axpy_2d_bf16", label, (out,),
                  (ref.sparse_scatter_axpy_2d_ref(vals, idx, accb, weight=w, acc_weight=aw),),
                  f"bf16 acc, aw={aw}, w={w}")
            del out
        if label == "lm_head":
            out = torch.empty_like(acc)
            n, k, W = rows * cols, vals.shape[1], idx.shape[1]
            k25, _, _, w25 = ref.sparse_geometry(cols, 0.25)
            rec["sparse_select_pack_2d"].update(
                ms=time_ms(torch, lambda: q.sparse_select_pack_2d(x, seed, p=0.05, mode="topk"),
                           10),
                plain_ms=time_ms(torch, lambda: ref.sparse_select_pack_2d_ref(
                    x, seed, p=0.05, mode="topk"), 2, 1),
                library_ms=time_ms(torch, lambda: torch.topk(x.abs(), k, dim=1), 10),
                # the selection: one key a lane, then k passes of cols comparisons
                bound=bound(n * 4 + rows * k * 4 + rows * W * 4, rows * cols * (k + 1)))
            t25 = time_ms(torch, lambda: q.sparse_select_pack_2d(x, seed, p=0.25, mode="randk"),
                          10)
            p25 = time_ms(torch, lambda: ref.sparse_select_pack_2d_ref(
                x, seed, p=0.25, mode="randk"), 2, 1)
            b25 = bound(n * 4 + rows * k25 * 4 + rows * w25 * 4, rows * cols * (k25 + 1))
            rec["sparse_scatter_axpy_2d"].update(
                ms=time_ms(torch, lambda: q.sparse_scatter_axpy_2d(
                    vals, idx, acc, weight=1.0, acc_weight=1.0, out=out), 10),
                plain_ms=time_ms(torch, lambda: ref.sparse_scatter_axpy_2d_ref(
                    vals, idx, acc, weight=1.0, acc_weight=1.0), 2, 1),
                bound=bound(rows * k * 4 + rows * W * 4 + 2 * n * 4, 3 * n))
            outb = torch.empty_like(accb)
            rec["sparse_scatter_axpy_2d_bf16"].update(
                ms=time_ms(torch, lambda: q.sparse_scatter_axpy_2d(
                    vals, idx, accb, weight=1.0, acc_weight=1.0, out=outb), 10),
                plain_ms=time_ms(torch, lambda: ref.sparse_scatter_axpy_2d_ref(
                    vals, idx, accb, weight=1.0, acc_weight=1.0), 2, 1),
                bound=bound(rows * k * 4 + rows * W * 4 + 2 * n * 2, 3 * n))
            rec["sparse_scatter_axpy_2d"]["yardstick_ms"] = time_ms(
                torch, lambda: torch.mul(acc, 1.0, out=out), 10)
            rec["sparse_scatter_axpy_2d_bf16"]["yardstick_ms"] = time_ms(
                torch, lambda: torch.mul(accb, 1.0, out=outb), 10)
            del outb
            log_times(rec, ("sparse_select_pack_2d", "sparse_scatter_axpy_2d",
                            "sparse_scatter_axpy_2d_bf16"))
            log(f"time sparse_select_pack_2d lm_head p=0.25 randk: kernel {t25:.4f} ms, bound "
                f"{b25[0]:.4f} ms ({b25[1]}), plain {p25:.2f} ms (torch.topk at p=0.05 is "
                f"selection only: no canonical tie order, no packing)")
            del out
        del x, vals, idx, acc, accb
        torch.cuda.empty_cache()
    k6c_edges(torch, q, ref, rec)


def check_views(torch, ref, rec: dict, name: str, base, run, plain, path, what: str,
                weights=((1.0, 1.0), (0.5, -2.0)), signed_zero=None) -> None:
    """``run(acc, out, aw, w)`` against ``plain(acc, aw, w)`` on each of
    ``ref.offset_views(base)`` (its own, one row into a buffer, off 16-byte
    alignment), into a fresh ``out`` and in place, at each ``(aw, w)`` of
    ``weights``; ``signed_zero(out)``, where given, must be all -0.0 at
    w > 0.  One log line with the path each view took (``path(acc,
    out)``)."""
    paths, ok, err = {}, True, 0.0
    for view, acc in ref.offset_views(base).items():
        paths[view] = path(acc, acc)
        for aw, w in weights:
            want = plain(acc, aw, w)
            got = run(acc, None, aw, w)
            run(acc, acc, aw, w)
            torch.cuda.synchronize()
            for g in (got, acc):
                ok = ok and ref.same_bits(g, want)
                err = max(err, max_abs_err(g, want))
            if signed_zero is not None and w > 0:
                ok = ok and bool(signed_zero(got).signbit().all())
            acc.copy_(base)
    rec[name]["err"] = max(rec[name]["err"], err)
    log(f"kernel {name} edges ({what}; paths {paths}): bit_equal={ok} max_abs_err={err}")
    assert ok, f"{name} disagrees with its plain version at its edges ({what})"


def k6c_edges(torch, q, ref, rec: dict) -> None:
    """K6c at its paths' edges against its plain version, both accumulator
    types: k 1 and 8 (the rows path's edge) and 9 (the slot-map path) at
    128 columns, f32 and f16 values, 1 row and 200,003 rows (no whole step
    of the persistent grid); an index word holding indices >= cols at 384
    columns (``ref.sparse_payload_past_cols``); each on an accumulator of
    its own, one a row into a buffer and one off 16-byte alignment (the
    slot-map path's scalar accesses), into a fresh ``out`` and in place."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    lib = q.build.load("sparse")
    names = {torch.float32: "sparse_scatter_axpy_2d",
             torch.bfloat16: "sparse_scatter_axpy_2d_bf16"}
    paths = {1: "rows", 0: "slot map"}
    x = ref.sparse_selection_edge_rows(edge_rows(torch.randn(
        (200003, 128), generator=gen, device=dev), ties=True), 5)
    cases = []
    for k in (1, 8, 9):
        for vdt in (torch.float32, torch.float16):
            for rows in (1, 200003):
                cases.append((f"{rows}x128, k={k}, {vdt}", 128,
                              q.sparse_select_pack_2d(x[:rows], 77, p=k / 128, mode="topk",
                                                      value_dtype=vdt), None))
    for vdt in (torch.float32, torch.float16):
        sent, kept = ref.sparse_payload_past_cols(vdt, dev)
        cases.append((f"5x384, indices past cols, {vdt}", 384, sent, kept))
    for what, cols, (vals, idx), kept in cases:
        k, kpad = vals.shape[1], idx.shape[1] * 32 // ref.idx_bits_for(cols)
        pv, pi = kept if kept is not None else (vals, idx)
        for adt, name in names.items():
            base = bf16_acc(torch, torch.randn((vals.shape[0], cols), generator=gen,
                                               device=dev), adt)
            check_views(
                torch, ref, rec, name, base,
                lambda a, o, aw, w: q.sparse_scatter_axpy_2d(vals, idx, a, weight=w,
                                                             acc_weight=aw, out=o),
                lambda a, aw, w: ref.sparse_scatter_axpy_2d_ref(pv, pi, a, weight=w,
                                                                acc_weight=aw),
                lambda a, o: paths[lib.sparse_scatter_axpy_2d_path(cols, k, kpad, a.data_ptr(),
                                                                   o.data_ptr())],
                what, weights=((1.0, 1.0), (0.5, 0.75)) if kept is not None else
                ((1.0, 1.0), (0.5, -2.0)))
    del x, cases
    torch.cuda.empty_cache()


# K6's register instances (columns a lane C, rows a warp R) by the fold that
# takes each, and the shared-memory path past 1024 columns
K6_INSTANCES = ((128, 0.25, "C8 R2"), (256, 0.05, "C8 R1"), (384, 0.05, "C12 R1"),
                (512, 0.05, "C16 R1"), (640, 0.1, "C20 R1"), (768, 0.05, "C24 R1"),
                (896, 0.05, "C28 R1"), (1024, 0.05, "C32 R1"), (2048, 0.05, "shared memory"))


def phase_kernel_grids(q) -> None:
    """K6's persistent grid for every instance at the ``lm_head`` fold's
    rows, looked up in order and again in reverse: each instance keeps its
    own occupancy.  640 columns at p 0.1 and 1024 at p 0.05 take the same
    shared memory a CTA, so a cache keyed by shared memory alone would give
    the second the first's grid."""
    rows = 802816
    first = [q.sparse_select_pack_2d_grid(rows, c, p) for c, p, _ in K6_INSTANCES]
    again = [q.sparse_select_pack_2d_grid(rows, c, p) for c, p, _ in K6_INSTANCES[::-1]][::-1]
    for (c, p, name), g in zip(K6_INSTANCES, first):
        log(f"grid sparse_select_pack_2d {rows}x{c} p={p} ({name}): {g} CTAs")
    log(f"grid sparse_select_pack_2d: reverse order gives {again}")
    assert first == again, (first, again)


def phase_kernels_decode(torch, q, ref, rec: dict) -> None:
    """K3 (8 bits) with K4a, and K4b (4 bits), vs plain version at the
    ``quant`` folds, edge rows included; K4a and K4b at block 32; K3 on a NaN
    row.  Times at the ``lm_head`` fold."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(8642)
    for label, rows, cols in [("lm_head", 802816, 1024), ("wk", 16384, 512),
                              ("ragged", 37, 256), ("block32", 65536, 32)]:
        x = torch.randn((rows, cols), generator=gen, device=dev) * 0.02
        x[0].zero_()
        x[1, :7] = -0.0
        seed = 0x5EED8 ^ rows
        what = f"{rows}x{cols}"
        if cols % 128 == 0:
            codes, scale = q.quantize_2d(x, seed, bits=8)
            torch.cuda.synchronize()
            check(ref, rec, "quantize_2d", label, (codes, scale),
                  ref.quantize_2d_ref(x, seed, bits=8), f"{what}, 8-bit")
            words, s4 = q.quantize_pack_2d(x, seed, bits=4)
        else:    # block 32: the wire's plain encode (off the send kernels' gate)
            codes, scale = ref.quantize_2d_ref(x, seed, bits=8)
            words, s4 = ref.quantize_pack_2d_ref(x, seed, bits=4)
        out = q.dequantize_2d(codes, scale, bits=8)
        torch.cuda.synchronize()
        check(ref, rec, "dequantize_2d", label, (out,),
              (ref.dequantize_2d_ref(codes, scale, bits=8),), f"{what}, 8-bit")
        out4 = q.unpack_dequant_2d(words, s4, bits=4)
        torch.cuda.synchronize()
        check(ref, rec, "unpack_dequant_2d", label, (out4,),
              (ref.unpack_dequant_2d_ref(words, s4, bits=4),), f"{what}, 4-bit")
        del out, out4
        if cols % 128 == 0:
            xn = x.clone()
            xn[2, 5] = float("nan")
            got = q.quantize_2d(xn, seed, bits=8)
            torch.cuda.synchronize()
            check_nan_row(torch, ref, "quantize_2d", label, got,
                          ref.quantize_2d_ref(xn, seed, bits=8), 8, 2, 5,
                          (q.dequantize_2d(got[0][2:3].contiguous(),
                                           got[1][2:3].contiguous(), bits=8),))
            del xn, got
        if label == "lm_head":
            n, W = rows * cols, words.shape[1]
            rec["quantize_2d"].update(
                ms=time_ms(torch, lambda: q.quantize_2d(x, seed, bits=8), 10),
                plain_ms=time_ms(torch, lambda: ref.quantize_2d_ref(x, seed, bits=8), 2, 1),
                bound=bound(n * 4 + n + rows * 4, 8 * n))
            # K4a's body as one PyTorch call: int8 codes times the per-row
            # float32 factor, which type promotion turns into float32
            factor = scale * ref.inv_levels(8)
            rec["dequantize_2d"].update(
                ms=time_ms(torch, lambda: q.dequantize_2d(codes, scale, bits=8), 10),
                plain_ms=time_ms(torch, lambda: ref.dequantize_2d_ref(codes, scale, bits=8),
                                 2, 1),
                library_ms=time_ms(torch, lambda: torch.mul(codes, factor), 10),
                bound=bound(n + rows * 4 + n * 4, n + rows))
            rec["unpack_dequant_2d"].update(
                ms=time_ms(torch, lambda: q.unpack_dequant_2d(words, s4, bits=4), 10),
                plain_ms=time_ms(torch, lambda: ref.unpack_dequant_2d_ref(words, s4, bits=4),
                                 2, 1),
                bound=bound(rows * W * 4 + rows * 4 + n * 4, 2 * n + rows))
            log_times(rec, ("quantize_2d", "dequantize_2d", "unpack_dequant_2d"))
        del x, codes, scale, words, s4
        torch.cuda.empty_cache()


def phase_kernels_sparse_decode(torch, q, ref, rec: dict) -> None:
    """K6b vs plain version on K6's payloads at the ``sparse`` folds: p = 0.25
    randk (k = 32) and p = 0.05 topk, f16 values off the ``lm_head`` fold; a
    whole -0.0 row, so kept -0.0 values must decode to +0.0.  Timed at the
    ``lm_head`` fold, p = 0.25 randk."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9753)
    seed = 0xB10C
    for label, rows, cols in [("lm_head", 6324224, 128), ("wk", 65536, 128),
                              ("ragged", 37, 384)]:
        x = edge_rows(torch.randn((rows, cols), generator=gen, device=dev) * 0.02, ties=True)
        x[5] = -0.0
        cases = [(0.25, "randk", torch.float32), (0.05, "topk", torch.float32)]
        if label != "lm_head":
            cases += [(0.25, "randk", torch.float16), (0.05, "topk", torch.float16)]
        for p, mode, vdt in cases:
            vals, idx = q.sparse_select_pack_2d(x, seed, p=p, mode=mode, value_dtype=vdt)
            out = q.sparse_unpack_scatter_2d(vals, idx, cols=cols)
            torch.cuda.synchronize()
            check(ref, rec, "sparse_unpack_scatter_2d", label, (out,),
                  (ref.sparse_unpack_scatter_2d_ref(vals, idx, cols=cols),),
                  f"{rows}x{cols}, {mode}, p={p}, {vdt}")
            assert not bool(torch.signbit(out[5]).any()), "a kept -0.0 decoded to -0.0"
            if label == "lm_head" and p == 0.25:
                k, W = vals.shape[1], idx.shape[1]
                rec["sparse_unpack_scatter_2d"].update(
                    ms=time_ms(torch, lambda: q.sparse_unpack_scatter_2d(vals, idx, cols=cols),
                               10),
                    plain_ms=time_ms(torch, lambda: ref.sparse_unpack_scatter_2d_ref(
                        vals, idx, cols=cols), 2, 1),
                    bound=bound(rows * k * 4 + rows * W * 4 + rows * cols * 4, rows * k))
                log_times(rec, ("sparse_unpack_scatter_2d",))
            del vals, idx, out
        del x
        torch.cuda.empty_cache()


# (label, lead batch, rows, n) of the lowrank folds: whole leaves of the
# full-width tree with their 8-slab lead batch, and a ragged fold
LOWRANK_FOLDS = (("lm_head", 8, 2048, 49408), ("embed", 8, 49408, 2048), ("wk", 8, 2048, 512),
                 ("ln", 8, 1, 2048), ("ragged", 3, 37, 384))
LOWRANK_RANKS = (1, 2, 4, 128)


def phase_kernels_lowrank(torch, lk, ref, rec: dict) -> None:
    """K7a and K7b vs plain version on whole-leaf folds, cold (one factor at
    batch stride 0) and warm (a factor per slab), at every rank of
    ``LOWRANK_RANKS``; each rank-2 case is timed beside its bound, its plain
    version and the PyTorch call that computes the same function."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    for label, batch, rows, n in LOWRANK_FOLDS:
        m = torch.randn((batch, rows, n), generator=gen, device=dev) * 0.02
        acc = torch.randn((batch, rows, n), generator=gen, device=dev)
        m[0, 0].zero_()                                # zeros, -0.0 and a NaN
        m[0, min(1, rows - 1), :7] = -0.0
        m[1, min(2, rows - 1), 5] = float("nan")
        acc[0, min(1, rows - 1), :5] = -0.0
        acc[2, min(2, rows - 1), 3] = float("nan")
        accb = bf16_acc(torch, acc)
        for r in LOWRANK_RANKS:
            v0 = torch.rand((n, r), generator=gen, device=dev) - 0.5
            v0[0, 0] = -0.0
            vw = torch.rand((batch, n, r), generator=gen, device=dev) - 0.5
            for mode, v in (("cold", v0.expand(batch, n, r)), ("warm", vw)):
                if mode == "cold" and label not in ("lm_head", "embed"):
                    continue
                what = f"{batch}x{rows}x{n}, rank {r}, {mode}"
                p = lk.lowrank_project_2d(m, v)
                torch.cuda.synchronize()
                check(ref, rec, "lowrank_project_2d", label, (p,),
                      (ref.lowrank_project_2d_ref(m, v),), what)
                p[0, 0].zero_()
                p[0, min(1, rows - 1)] = -0.0
                for aw, w in ((1.0, 1.0), (0.5, -2.0)):
                    out = lk.lowrank_axpy_2d(p, v, acc, weight=w, acc_weight=aw)
                    torch.cuda.synchronize()
                    check(ref, rec, "lowrank_axpy_2d", label, (out,),
                          (ref.lowrank_axpy_2d_ref(p, v, acc, weight=w, acc_weight=aw),),
                          f"{what}, aw={aw}, w={w}")
                    del out
                for aw, w in BF16_WEIGHTS if mode == "warm" else ():
                    out = lk.lowrank_axpy_2d(p, v, accb, weight=w, acc_weight=aw)
                    torch.cuda.synchronize()
                    check(ref, rec, "lowrank_axpy_2d_bf16", label, (out,),
                          (ref.lowrank_axpy_2d_ref(p, v, accb, weight=w, acc_weight=aw),),
                          f"{what}, bf16 acc, aw={aw}, w={w}")
                    del out
                if r == 2:                              # the main path's rank
                    lowrank_times(torch, lk, ref, rec, label, mode, m, v, p, acc, accb)
                del p
            del v0, vw
        del m, acc, accb
        torch.cuda.empty_cache()
    k7b_edges(torch, lk, ref, rec)


def k7b_edges(torch, lk, ref, rec: dict) -> None:
    """K7b at its paths' edges against its plain version, both accumulator
    types: ranks 1, 2, 4 (the rows path) and 3, 5, 128 (the scalar path),
    rows 1 and 17, n 128 and 49408, a batch of 3, cold (one factor at batch
    stride 0) and warm; each on an accumulator of its own, one a row into a
    buffer and one off 16-byte alignment (the scalar path at every rank),
    into a fresh ``out`` and in place.  The factors are >= 0 and slab 0's
    row 0 has P = -0.0 and a -0.0 accumulator: its dot is -0.0, so at w > 0
    that row must stay -0.0 (a padded +0.0 product would make it +0.0)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1729)
    lib = lk.build.load("lowrank")
    names = {torch.float32: "lowrank_axpy_2d", torch.bfloat16: "lowrank_axpy_2d_bf16"}
    paths = {1: "rows", 0: "scalar"}
    batch = 3
    for r in (1, 2, 3, 4, 5, 128):
        for rows, n in ((1, 128), (17, 128), (1, 49408), (17, 49408)):
            p = torch.randn((batch, rows, r), generator=gen, device=dev)
            p[0, 0] = -0.0
            factors = {"cold": torch.rand((n, r), generator=gen, device=dev).expand(batch, n, r),
                       "warm": torch.rand((batch, n, r), generator=gen, device=dev)}
            for adt, name in names.items():
                base = bf16_acc(torch, torch.randn((batch, rows, n), generator=gen, device=dev),
                                adt)
                base[0, 0] = -0.0
                for mode, v in factors.items():
                    check_views(
                        torch, ref, rec, name, base,
                        lambda a, o, aw, w: lk.lowrank_axpy_2d(p, v, a, weight=w,
                                                               acc_weight=aw, out=o),
                        lambda a, aw, w: ref.lowrank_axpy_2d_ref(p, v, a, weight=w,
                                                                 acc_weight=aw),
                        lambda a, o: paths[lib.lowrank_axpy_2d_path(r, rows, a.data_ptr(),
                                                                    o.data_ptr())],
                        f"{batch}x{rows}x{n}, rank {r}, {mode}",
                        signed_zero=lambda out: out[0, 0])
    torch.cuda.empty_cache()


def lowrank_times(torch, lk, ref, rec: dict, label: str, mode: str, m, v, p, acc,
                  accb) -> None:
    """CUDA-event times of K7a and K7b (f32 ``acc`` and bf16 ``accb``) at one
    rank-2 fold; the warm ``lm_head`` fold, the main path's largest, fills
    ``rec``."""
    batch, rows, n = m.shape
    r = v.shape[-1]
    out = torch.empty_like(acc)
    vt = v.mT
    v_bytes = (n if mode == "cold" else batch * n) * r * 4
    t = {
        "K7a": time_ms(torch, lambda: lk.lowrank_project_2d(m, v), 10),
        "K7a plain": time_ms(torch, lambda: ref.lowrank_project_2d_ref(m, v), 2, 1),
        "K7a library": time_ms(torch, lambda: torch.bmm(m, v), 10),
        "K7b": time_ms(torch, lambda: lk.lowrank_axpy_2d(
            p, v, acc, weight=1.0, acc_weight=1.0, out=out), 10),
        "K7b plain": time_ms(torch, lambda: ref.lowrank_axpy_2d_ref(
            p, v, acc, weight=1.0, acc_weight=1.0), 2, 1),
        "K7b library": time_ms(torch, lambda: torch.baddbmm(acc, p, vt, beta=1.0, alpha=1.0), 10),
    }
    if mode == "warm":
        outb = torch.empty_like(accb)
        t["K7b bf16"] = time_ms(torch, lambda: lk.lowrank_axpy_2d(
            p, v, accb, weight=1.0, acc_weight=1.0, out=outb), 10)
        t["K7b bf16 plain"] = time_ms(torch, lambda: ref.lowrank_axpy_2d_ref(
            p, v, accb, weight=1.0, acc_weight=1.0), 2, 1)
        # the nearest library call, not the same function: its factors are
        # rounded to bf16
        pb, vtb = p.bfloat16(), vt.bfloat16()
        t["K7b bf16 library (baddbmm on bf16 factors, not the same function)"] = time_ms(
            torch, lambda: torch.baddbmm(accb, pb, vtb, beta=1.0, alpha=1.0), 10)
        t["yardstick torch.mul f32"] = time_ms(torch, lambda: torch.mul(acc, 1.0, out=out), 10)
        t["yardstick torch.mul bf16"] = time_ms(torch, lambda: torch.mul(accb, 1.0, out=outb),
                                                10)
        del outb, pb, vtb
    el = batch * rows * n
    b7a = bound(el * 4 + v_bytes + batch * rows * r * 4, 2 * el * r)
    b7b = bound(batch * rows * r * 4 + v_bytes + 2 * el * 4, (2 * r + 2) * el)
    b7b16 = bound(batch * rows * r * 4 + v_bytes + 2 * el * 2, (2 * r + 2) * el)
    log(f"time lowrank {label} {mode} rank {r}: " + ", ".join(
        f"{k} {val:.4f} ms" for k, val in t.items()) +
        f"; bound K7a {b7a[0]:.4f} ms ({b7a[1]}), K7b {b7b[0]:.4f} ms ({b7b[1]})")
    if label == "lm_head" and mode == "warm":
        rec["lowrank_project_2d"].update(ms=t["K7a"], plain_ms=t["K7a plain"],
                                         library_ms=t["K7a library"], bound=b7a)
        rec["lowrank_axpy_2d"].update(ms=t["K7b"], plain_ms=t["K7b plain"],
                                      library_ms=t["K7b library"], bound=b7b)
        rec["lowrank_axpy_2d_bf16"].update(ms=t["K7b bf16"], plain_ms=t["K7b bf16 plain"],
                                           bound=b7b16)
        rec["lowrank_axpy_2d"]["yardstick_ms"] = t["yardstick torch.mul f32"]
        rec["lowrank_axpy_2d_bf16"]["yardstick_ms"] = t["yardstick torch.mul bf16"]
        log_times(rec, ("lowrank_project_2d", "lowrank_axpy_2d", "lowrank_axpy_2d_bf16"))
    del out


# (rows, vocab, length) of the Markov walks: the granite cells' batch (the
# kernels record's shape), the mamba cell's, and a rank's rows of granite's
MARKOV_SHAPES = ((32, 49155, 256), (8, 50280, 1024), (4, 49155, 256))
# the data's seeds, of the benchmark's size (past 2^31 and 2^32) and small
MARKOV_SEEDS = (3_000_000_019, 2 ** 33 + 5, 77)


def phase_kernels_markov(torch, mk, ref, rec: dict) -> None:
    """The data layer's Markov walk against its plain version (the eager
    walk, ``ref.markov_walk_ref``) on the card at ``MARKOV_SHAPES``, token
    for token, on the row keys the pipeline makes, three (seed, step) pairs
    each.  At the two cells' shapes, timed beside: the plain version, the
    same walk at one CTA a row (``cluster_size`` held at 1, its tokens
    checked too), the walk's fixed cost (a vocab of one candidate a CTA:
    what every position's reductions and cluster barrier take), and the
    lower bound (``markov_bound``)."""
    from repro_torch.data import DataConfig
    from repro_torch.data import pipeline

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, vocab, length in MARKOV_SHAPES:
        label, nodes = f"{rows}x{vocab}x{length}", math.gcd(rows, 8)
        csize = mk.cluster_size(rows, sms)
        for i, seed in enumerate(MARKOV_SEEDS):
            dc = DataConfig(vocab=vocab, seq_len=length, global_batch=rows, n_shards=nodes,
                            seed=seed)
            key = pipeline._row_keys(dc, 5 * i + 1, range(nodes), dev)
            kw = dict(vocab=vocab, length=length, seed=seed,
                      concentration=dc.markov_concentration)
            got = mk.markov_walk(key, **kw)
            want = ref.markov_walk_ref(key, **kw)
            torch.cuda.synchronize()
            check(ref, rec, "markov_walk", label, (got,), (want,),
                  f"seed {seed}, {rows} clusters of {csize} CTAs")
        if (rows, vocab, length) == MARKOV_SHAPES[2]:
            continue
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


# (label, shape) of the AdamW leaves: granite's largest stacked leaf (embed,
# and lm_head: 8 nodes x 49,155 x 2,048) and a ragged one
ADAMW_SHAPES = (("embed", (8, 49155, 2048)), ("ragged", (8, 1001)))
# the cells' AdamW, lr 3e-3 past the warm-up
ADAMW_KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
ADAMW_OPS = 15                  # f32 operations an element (products, sums, sqrt, division)


def phase_kernels_adamw(torch, ak, ref, rec: dict) -> None:
    """The optim layer's AdamW update against its plain version (the eager
    body, ``ref.adamw_update_ref``) on the card at ``ADAMW_SHAPES``: ``m``,
    ``v`` and the update bit for bit, f32 leaves at t 1 with lr 3e-3 and at
    t 300 with lr 0.0, and bf16 ``g`` and ``p`` at the large leaf; ``g``
    holds NaN, +-inf and -0.0.  At the large leaf, f32, timed beside its
    bound (28 B an element), the plain version and the library's fused
    AdamW (``torch._fused_adamw_``, the same bytes; timed only, the port
    never calls it)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    for label, shape in ADAMW_SHAPES:
        g = torch.randn(shape, generator=gen, device=dev).mul_(1e-2)
        g.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
        p = torch.randn(shape, generator=gen, device=dev)
        m0 = torch.randn(shape, generator=gen, device=dev).mul_(1e-3)
        v0 = torch.rand(shape, generator=gen, device=dev).mul_(1e-4)
        for dtype in (torch.float32, torch.bfloat16)[:2 if label == "embed" else 1]:
            gd, pd = g.to(dtype), p.to(dtype)
            for t, lr in ((1, 3e-3), (300, 0.0)):
                m, v, mr, vr = m0.clone(), v0.clone(), m0.clone(), v0.clone()
                got = ak.adamw_update(gd, m, v, pd, lr=lr, t=t, **ADAMW_KW)
                want = ref.adamw_update_ref(gd, mr, vr, pd, lr=lr, t=t, **ADAMW_KW)
                torch.cuda.synchronize()
                check(ref, rec, "adamw_update", label, (got, m, v), (want, mr, vr),
                      f"{str(dtype)[6:]} g and p, t {t}, lr {lr}")
                del got, want, m, v, mr, vr
            del gd, pd
        if label != "embed":
            continue
        n = g.numel()
        m, v = m0.clone(), v0.clone()
        kw = dict(lr=3e-3, t=1, **ADAMW_KW)
        ms = time_ms(torch, lambda: ak.adamw_update(g, m, v, p, **kw), 10)
        plain_ms = time_ms(torch, lambda: ref.adamw_update_ref(g, m, v, p, **kw), 3)
        steps = [torch.ones((), device=dev)]
        lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], steps, lr=3e-3, beta1=0.9, beta2=0.95, weight_decay=0.01,
            eps=1e-8, amsgrad=False, maximize=False), 10)
        lower = bound(28 * n, ADAMW_OPS * n)
        rec["adamw_update"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=lower)
        log(f"time adamw_update {label} {shape}: kernel {ms:.4f} ms, bound {lower[0]:.4f} ms "
            f"({lower[1]}, {lower[0] / ms:.1%} of it), plain {plain_ms:.4f} ms, library "
            f"torch._fused_adamw_ {lib_ms:.4f} ms")
        del m, v, steps
    del g, p, m0, v0
    torch.cuda.empty_cache()


def max_shift_residual(torch, tree_leaves, base, others: dict) -> float:
    """max |roll(base, s) - others[s]| over every leaf and shift."""
    worst = 0.0
    for s, tree in others.items():
        for b, o in zip(tree_leaves(base), tree_leaves(tree)):
            worst = max(worst, (torch.roll(b, s, dims=0) - o).abs().max().item())
    return worst


ADAPTIVE_SPEC = "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"
# (algo, wire, steps, {kernel: launches a step}); the other kernels launch none
TRAIN_RUNS = (
    ("dcd", "quant:4", 3, {"quantize_pack_2d": 12, "unpack_dequant_axpy_2d": 36}),
    ("ecd", "quant:4", 2, {"quantize_pack_2d": 12, "unpack_dequant_axpy_2d": 36}),
    ("choco", "sign", 2, {"sign_pack_2d": 12, "unpack_sign_axpy_2d": 36}),
    ("deepsqueeze", "sign", 2, {"sign_pack_2d": 12, "unpack_sign_axpy_2d": 48}),
    ("choco", "sparse:0.05:topk", 2, {"sparse_select_pack_2d": 12,
                                      "sparse_scatter_axpy_2d": 36}),
    # lowrank: 11 matrix leaves (final_ln, (n, d), rides fp16); adaptive:
    # embed by its override, ln1/ln2/final_ln (2048 per replica) small
    ("dcd", "lowrank:2:warm", 3, {"lowrank_project_2d": 11, "lowrank_axpy_2d": 33}),
    ("dcd", "lowrank:2", 2, {"lowrank_project_2d": 11, "lowrank_axpy_2d": 33}),
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


def walk_took_the_kernel(q, calls0: dict, counts: dict) -> None:
    """Every call of the data's Markov walk since ``calls0`` (the wrappers'
    ``call_counts()``) launched its kernel: as many calls as ``counts``
    (launches, reset at the same point) holds launches."""
    calls = q.call_counts()["markov_walk"] - calls0["markov_walk"]
    assert calls == counts["markov_walk"], ("markov_walk", calls, counts["markov_walk"])


def phase_train(torch, algo: str, wire: str, steps: int, per_step: dict, q) -> dict:
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
    walk_took_the_kernel(q, calls0, counts)
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
    want = {name: {**WALK_PER_STEP, **ADAMW_PER_STEP, **per_step}.get(name, 0) * steps
            for name in counts}
    assert counts == want, (counts, want)
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
    return counts


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
# steps, {kernel: launches over the run}); the other kernels launch none.
# 12 leaves; full_logn and exp at n 8 have the shift union {1, 2, 4}.
PLAN_RUNS = (
    ("R1", dict(algo="naive", wire="quant:4", topology="chain", drop_rate=0.1), 2,
     {"quantize_pack_2d": 24, "unpack_dequant_2d": 72}),
    ("R2", dict(algo="dcd", wire="quant:8", topology="full_logn", drop_rate=0.1), 2,
     {"quantize_2d": 72, "dequantize_2d": 288}),
    ("R3", dict(algo="dcd", wire="quant:4", topology="exp"), 3,
     {"quantize_pack_2d": 36, "unpack_dequant_axpy_2d": 144}),
    ("R4", dict(algo="dpsgd", topology="chain", drop_rate=0.1), 2, {}),
    ("R5", dict(algo="cpsgd", topology="ring"), 2, {}),
    ("R6", dict(algo="dcd", phase_plan="0@ring@quant:8;2@full_logn@quant:4"), 4,
     {"quantize_2d": 24, "dequantize_2d": 72, "quantize_pack_2d": 72,
      "unpack_dequant_axpy_2d": 288}),
)


def phase_plan_run(torch, q, label: str, fields: dict, steps: int, launches: dict) -> dict:
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
    walk_took_the_kernel(q, calls0, counts)
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
    want = {name: launches.get(name, 0) + {**WALK_PER_STEP, **ADAMW_PER_STEP}.get(name, 0) * steps
            for name in counts}
    assert counts == want, (counts, want)
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
    return counts


def phase_checkpoint(torch, q) -> dict:
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
    from repro_torch.tree import leaf_items

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
    restored, _ = restore(str(root / "through"), through["state"], 2)
    same_restore = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for (_, a), (_, b) in zip(saved[2], _items(restored)))
    end_a, end_b = _items(through["state"]), _items(resumed["state"])
    diff = max((a.float() - b.float()).abs().max().item() if isinstance(a, torch.Tensor)
               else float(a != b) for (_, a), (_, b) in zip(end_a, end_b))
    loss_diff = max(abs(a - b) for a, b in zip(through["losses"][2:], resumed["losses"]))
    n_leaves = len(leaf_items(through["state"].params))
    log(f"checkpoint R7: reduced granite dcd quant:4 ring, 8 nodes: run-through losses "
        f"{through['losses']}, resumed from step 2 {resumed['losses']}; restored state "
        f"bit-equal to the saved one {same_restore}; final state max_abs_diff {diff}, "
        f"loss max diff {loss_diff}; launches {counts}")
    assert same_restore and diff == 0.0 and loss_diff == 0.0, (same_restore, diff, loss_diff)
    assert counts["quantize_pack_2d"] == 6 * n_leaves, counts
    assert counts["unpack_dequant_axpy_2d"] == 18 * n_leaves, counts
    assert counts["markov_walk"] == 6, counts                 # 4 steps, then 2 resumed
    assert counts["adamw_update"] == 6 * n_leaves, counts
    shutil.rmtree(root, ignore_errors=True)
    return counts


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

    # (algo, compressor, {kernel: launches a step}); the other kernels launch none
    return (("dcd", RandomQuantizer(bits=8, block_size=1024, use_kernel=True),
             {"quantize_2d": 12, "dequantize_2d": 12}),
            ("ecd", RandomQuantizer(bits=4, block_size=1024),
             {"quantize_pack_2d": 12, "unpack_dequant_2d": 12}),
            ("dcd", RandomSparsifier(p=0.25, block_size=128),
             {"sparse_select_pack_2d": 12, "sparse_unpack_scatter_2d": 12}))


def phase_stacked(torch, q, algo: str, comp, per_step: dict, steps: int = 2) -> dict:
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
    walk_took_the_kernel(q, calls0, counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: losses={losses} consensus_distance={consensus}")
    log(f"{tag}: step_s={[round(x, 4) for x in step_s]} peak_memory_allocated={peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"{tag}: launches {counts}")
    nbytes = comp.wire.wire_nbytes(state.params)
    log(f"{tag}: wire_nbytes per step {nbytes} B for the 8 nodes' payloads")
    assert all(math.isfinite(v) for v in losses + consensus), (losses, consensus)
    want = {name: {**WALK_PER_STEP, **per_step}.get(name, 0) * steps for name in counts}
    assert counts == want, (counts, want)
    del state
    torch.cuda.empty_cache()
    return counts


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


def phase_gossip_reference(torch, q) -> dict:
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
    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

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
                    add(ref_counts[-1])
                    q.reset_launch_counts()
                    ds, _ = dstep(ds, batch)
                    torch.cuda.synchronize()
                    run_counts.append({k: v for k, v in q.launch_counts().items() if v})
                    add(run_counts[-1])
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
        add(counts)
        log(f"gossip_reference compare_compression {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}, result {rows}")
        if "--pareto" not in argv:
            assert all(math.isfinite(v) for *_, v in rows), (argv, rows)
    log(f"gossip_reference: {time.perf_counter() - t_phase:.1f} s")
    return totals


# the analyzer's steps at the train phase's width: (algo, wire, drop)
ANALYSIS_FULL_WIDTH = (("dcd", "quant:8", 0.0), ("dcd", "quant:4", 0.2))


def phase_analysis(torch, q) -> dict:
    """The port's analysis (``repro_torch.analysis``) on the card.  (a) The
    lint of the port's files: 0 findings.  (b) ``run_sweep`` on the card,
    one step of each case of the JAX package's representative grid on its
    toy testbed: every report ``ok`` (no wrapper took its plain version, no
    float64, no host read of a card tensor, only wire containers handed to
    the transport), and the receive launches equal to the calls and to
    ``decode sites x kernels per site``, > 0 for every wire case.  (c) One
    step each of ``ANALYSIS_FULL_WIDTH`` at the train phase's width
    (granite-3-2b, 1 layer, ring of 8, the ``TrainConfig`` defaults: AdamW,
    warmup-cosine lr, seq 256, batch 32) with the same checks, the dtypes
    each step handed its transport and its launches logged.  Returns the
    launches of (b) and (c), ``kernels_per_site``'s one encode and receive a
    leaf included."""
    from repro_torch.analysis import step_checks
    from repro_torch.analysis.staticcheck import iter_py_files, lint_tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, stacked_node_batches
    from repro_torch.launch.train import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import linear_warmup_cosine

    t_phase = time.perf_counter()
    findings = lint_tree(ROOT)
    log(f"analysis lint: {len(findings)} finding(s) over "
        f"{sum(1 for _ in iter_py_files(ROOT))} files")
    assert not findings, [str(f) for f in findings]
    launches0 = q.launch_counts()

    def check(rep) -> None:
        assert rep.ok, (rep.describe(), rep.violations)
        assert rep.host_reads == 0, rep.describe()
        assert rep.launches == rep.kernel_calls == rep.expected_kernels, rep.describe()
        assert (rep.expected_kernels > 0) == (rep.wire is not None), rep.describe()

    t0 = time.perf_counter()
    reports = step_checks.run_sweep(device="cuda")
    for rep in reports:
        log(f"analysis[{'ok' if rep.ok else 'FAIL'}] {rep.describe()} "
            f"launches={rep.launches} host_reads={rep.host_reads}")
    log(f"analysis sweep: {len(reports)} cases on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    for rep in reports:
        check(rep)
    assert len(reports) == 19, len(reports)

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    tc = TrainConfig(arch="granite-3-2b", reduced=False)
    model = build_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
                    n_shards=tc.n_nodes, seed=tc.seed)
    for algo, wire, drop in ANALYSIS_FULL_WIDTH:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        before, calls0 = q.launch_counts(), q.call_counts()
        testbed = (model.loss, model.init(tc.seed, device="cuda"),
                   stacked_node_batches(dc, 0, cfg, device="cuda"))
        rep = step_checks.analyze_case(
            algo, tc.topology, wire, drop, n=tc.n_nodes, device="cuda", testbed=testbed,
            opt=make_optimizer(tc.optimizer, weight_decay=0.01),
            lr_schedule=linear_warmup_cosine(tc.lr, tc.warmup, tc.steps))
        del testbed
        counts = {k: v - before[k] for k, v in q.launch_counts().items() if v != before[k]}
        log(f"analysis[{'ok' if rep.ok else 'FAIL'}] granite-3-2b 1 layer {rep.describe()} "
            f"launches={rep.launches} host_reads={rep.host_reads}; wire dtypes handed "
            f"{list(rep.permute_dtypes)}; launches with kernels_per_site's {counts}; "
            f"{time.perf_counter() - t0:.1f} s")
        check(rep)
        # the testbed's one batch took the walk kernel
        assert counts["markov_walk"] == 1, counts
        walk_took_the_kernel(q, calls0, counts)
    torch.cuda.empty_cache()
    totals = {k: v - launches0[k] for k, v in q.launch_counts().items()}
    log(f"analysis: {time.perf_counter() - t_phase:.1f} s; {gpu_name_and_power()}")
    return totals


def phase_quickstart(torch, q) -> dict:
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
    return counts


def phase_profile(torch, algo: str, wire: str, steps: int = 2) -> None:
    """Where a step's device time goes: ``torch.profiler`` over ``steps``
    steady steps (batch generation included, as in ``run_training``) of the
    train configuration, after one unprofiled warm-up step and outside the
    counted runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, stacked_node_batches
    from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    model = build_model(cfg)
    opt = adamw(weight_decay=0.01)
    step = make_dist_train_step(model.loss, algo, opt, wire, 8,
                                linear_warmup_cosine(3e-3, 20, 300), gamma=0.5)
    state = init_dist_state(algo, model.init(0, device="cuda"), 8, opt, wire=wire)
    dc = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=32, n_shards=8, seed=0)
    state, _ = step(state, stacked_node_batches(dc, 0, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(1, 1 + steps):
            state, _ = step(state, stacked_node_batches(dc, t, device="cuda"))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    report_profile(prof, f"{algo} {wire}", steps, wall)


def report_profile(prof, tag: str, steps: int, wall: float) -> None:
    """Log a profile's device busy time and idle share, its top kernels, and
    each of the port's kernels a step."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    log(f"profile {tag} ({steps} steady steps): wall {wall:.3f} s, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    ours = [e for e in ranked if any(sym in e.key for sym in KERNEL_SYMBOLS)]
    for e in ranked[:12] + [e for e in ours if e not in ranked[:12]]:
        log(f"profile   {dev_us(e) / 1e3:10.2f} ms  {e.count:6d} launches  {e.key[:100]}")
    for e in ours:
        name = e.key.split("namespace)::")[-1].split("(")[0][:64]    # with template arguments
        log(f"profile {tag}: {name} {dev_us(e) / 1e3 / steps:.3f} ms a step "
            f"({e.count / steps:g} launches a step), of {busy / steps * 1e3:.1f} ms busy a step")


def phase_profile_stacked(torch, algo: str, comp, steps: int = 2) -> None:
    """Device time by kernel of the stacked reference at full width (as
    ``phase_stacked``), over ``steps`` steps after one unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import make_algorithm
    from repro_torch.data import stacked_node_batches

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    model, dc = _stacked_setup(cfg, 8, 256, 32)
    alg = make_algorithm(algo, 8, "ring", comp)
    state = alg.init(model.init(0, device="cuda"))
    step = alg.step_fn()
    stacked_step(model, step, state, stacked_node_batches(dc, 0, device="cuda"), 0, 3e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(1, 1 + steps):
            stacked_step(model, step, state, stacked_node_batches(dc, t, device="cuda"), t, 3e-3)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    report_profile(prof, f"stacked {algo} {comp}", steps, wall)


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
# one node's rows of the lm_head leaf of RANKS stacked nodes (49408 x 2048):
# (kernel, label, rows a node, cols, encode keywords); K6 also at the fold
# widths of its register (512) and shared-memory (2048) paths
OFFSET_FOLDS = (("quantize_pack_2d", "lm_head", 98816, 1024, dict(bits=4)),
                ("quantize_2d", "lm_head", 98816, 1024, dict(bits=8)),
                ("sparse_select_pack_2d", "lm_head", 790528, 128, dict(p=0.05, mode="randk")),
                ("sparse_select_pack_2d", "lm_head", 790528, 128, dict(p=0.25, mode="randk")),
                ("sparse_select_pack_2d", "w512", 4096, 512, dict(p=0.05, mode="randk")),
                ("sparse_select_pack_2d", "w2048", 1024, 2048, dict(p=0.05, mode="randk")))


def phase_kernel_offsets(torch, q, ref, rec: dict, device="cuda") -> None:
    """K1, K3 and K6 random-k with a counter offset, at a rank's folds: node
    ``i``'s rows encoded at offset ``i*rows*cols`` equal those rows of the
    whole fold's encode and the plain version at that offset; an offset that
    wraps past 2^32 inside the fold equals the plain version too."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    seed = 0x0FF5E7
    for name, label, rows, cols, kw in OFFSET_FOLDS:
        kernel, plain = getattr(q, name), getattr(ref, f"{name}_ref")
        x = torch.randn((RANKS * rows, cols), generator=gen, device=dev) * 0.02
        x[0].zero_()
        x[1, :7] = -0.0
        whole = kernel(x, seed, **kw)
        what = f"{rows}x{cols} {kw}"
        for i in range(RANKS):
            part = x[i * rows:(i + 1) * rows]
            got = kernel(part, seed, offset=i * rows * cols, **kw)
            torch.cuda.synchronize()
            check(ref, rec, name, f"{label} node {i}", got,
                  tuple(w[i * rows:(i + 1) * rows] for w in whole),
                  f"{what}, offset {i * rows * cols} against the whole fold's rows")
            check(ref, rec, name, f"{label} node {i}", got,
                  plain(part, seed, offset=i * rows * cols, **kw), f"{what}, plain, same offset")
            del got
        wrap = 2**32 - (rows // 2) * cols - 3
        part = x[:rows]
        check(ref, rec, name, label, kernel(part, seed, offset=wrap, **kw),
              plain(part, seed, offset=wrap, **kw), f"{what}, offset {wrap} wraps past 2^32")
        del x, whole, part
        torch.cuda.empty_cache()


# (algo, wire, steps, {kernel: launches a step on every rank}); the other
# kernels launch none.  A rank sends each of the 12 leaves once a step and
# decodes it into its params and its two replicas (or hats).
RANK_RUNS = (
    ("dcd", "quant:4", 3, {"quantize_pack_2d": 12, "unpack_dequant_axpy_2d": 36}),
    ("dpsgd", None, 2, {}),
    ("choco", "sparse:0.05:randk", 2, {"sparse_select_pack_2d": 12,
                                      "sparse_scatter_axpy_2d": 36}),
)
# algo -> (what a rank's shifted copies track, their prefix), as INVARIANTS
RANK_INVARIANTS = {"dcd": (None, "rep"), "choco": ("hat_self", "hat")}


def rank_train_config(algo: str, wire, steps: int):
    from repro_torch.launch.train import TrainConfig

    return TrainConfig(arch="granite-3-2b", algo=algo, wire=wire or "quant:8", gamma=0.5,
                       topology="ring", n_nodes=RANKS, steps=steps, log_every=1, reduced=False)


def _rank_worker(group, cfg, runs, ref_dir) -> list:
    """One rank of the ranks phase: each run of ``runs`` through
    ``run_training(group=)``, its launch counts and transport stats; then
    one more exchange of X (or hat_self) against the rank's replicas (or
    hats), and the params against the stacked run's node slice."""
    import torch

    from repro_torch import trace
    from repro_torch.distributed.transport import RankTransport
    from repro_torch.kernels import quant as q
    from repro_torch.launch.train import run_training
    from repro_torch.tree import leaf_items, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for algo, wire, steps, _ in runs:
        tc = rank_train_config(algo, wire, steps)
        q.reset_launch_counts()
        group.stats.reset()
        on_card = group.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(group.device)
        trace.enable(True)
        hist = run_training(cfg, tc, group=group)
        trace.enable(False)
        counts = q.launch_counts()
        stats = {"sent": dict(group.stats.sent), "seconds": hist["transport"]["seconds"]}
        state = hist["state"]
        rec = {"algo": algo, "wire": wire, "losses": hist["losses"], "step_s": hist["step_s"],
               "consensus": hist["consensus"], "counts": counts, "stats": stats,
               "peak": torch.cuda.max_memory_allocated(group.device) if on_card else 0}
        if algo in RANK_INVARIANTS:
            base_key, prefix = RANK_INVARIANTS[algo]
            base = tree_leaves(state.params if base_key is None else state.aux[base_key])
            tp, worst = RankTransport(group), 0.0
            for s in (-1, 1):
                for mine, copy in zip(base, tree_leaves(state.aux[f"{prefix}{s:+d}"])):
                    theirs = tp.exchange({"x": mine}, (s,), label="check")[s]["x"]
                    worst = max(worst, (theirs - copy).abs().max().item())
            rec["invariant"] = worst
        want = ref_dir / f"{algo}_node{group.rank}.pt"
        if want.exists():
            ref_params = torch.load(want, map_location=group.device)
            diffs = [(leaf[0] - ref_params[path]).abs().max().item()
                     for path, leaf in leaf_items(state.params)]
            rec["vs_stacked"] = (max(diffs), all(torch.equal(leaf[0], ref_params[path])
                                                 for path, leaf in leaf_items(state.params)))
            del ref_params
        out.append(rec)
        del hist, state
        if on_card:
            torch.cuda.empty_cache()
    return out


def phase_ranks(torch, q, cfg=None, device="cuda") -> dict:
    """RANKS processes, one gossip node each, all on the one card over gloo
    (NCCL refuses two ranks on one GPU), each holding its node's slice of
    granite-3-2b at published widths (1 layer): DCD ``quant:4`` (the main
    path), D-PSGD and CHOCO ``sparse:0.05:randk`` (K6 with a non-zero counter
    offset), ring, the TrainConfig defaults otherwise.  A stacked run of DCD
    ``quant:4`` at n RANKS on the card first: its node slices, saved under
    ``build/``, are what each rank's params are held to.  Logs per run and
    rank the step, exchange and metric times, bytes by label and launches;
    asserts the launches, ``rep{s}`` (``hat{s}``) equal to node ``(i - s)``'s
    X (hat_self) exactly, and the params against the stacked run's."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.tree import leaf_items

    cfg = cfg or dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    ref_dir = ROOT / "build" / "chip_smoke_ranks"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    log(f"ranks: {RANKS} processes, one gossip node each, share one {device} device over "
        f"gloo (this machine has one GPU, and NCCL refuses to put two ranks on one GPU); "
        f"each stages its containers through pinned host memory and loopback TCP")
    stacked = train_mod.run_training(cfg, rank_train_config("dcd", "quant:4", 3), device=device)
    for i in range(RANKS):
        torch.save({path: leaf[i].cpu() for path, leaf in leaf_items(stacked["state"].params)},
                   ref_dir / f"dcd_node{i}.pt")
    log(f"ranks: stacked dcd quant:4 at n {RANKS}: losses {stacked['losses']} step_s "
        f"{[round(x, 4) for x in stacked['step_s']]}")
    del stacked
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = spawn_ranks(_rank_worker, RANKS, "gloo", cfg, RANK_RUNS, ref_dir, device=device,
                           timeout_s=900)
    log(f"ranks: {RANKS} ranks ran {len(RANK_RUNS)} runs in {time.perf_counter() - t0:.1f} s, "
        f"process start-up included")
    totals = {}
    for ri, (algo, wire, steps, per_step) in enumerate(RANK_RUNS):
        tag = f"{algo} {wire or 'full precision'}"
        for rank, runs in enumerate(per_rank):
            r = runs[ri]
            st = r["stats"]
            exch = sum(v for k, v in st["seconds"].items() if k in ("wire", "dense"))
            log(f"ranks {tag} rank {rank}: step_s={[round(x, 4) for x in r['step_s']]} "
                f"exchange_s={exch:.4f} ({exch / steps:.4f} a step) "
                f"metric_s={st['seconds'].get('metric', 0.0):.4f} sent_bytes={st['sent']} "
                f"({ {k: v // steps for k, v in st['sent'].items()} } a step) "
                f"peak_memory_allocated={r['peak']} B launches "
                f"{ {k: v for k, v in r['counts'].items() if v} }")
            assert all(math.isfinite(v) for v in r["losses"]), r["losses"]
            want = {name: {**WALK_PER_STEP, **ADAMW_PER_STEP, **per_step}.get(name, 0) * steps
                    for name in r["counts"]}
            assert r["counts"] == want, (rank, r["counts"], want)
            for name, c in r["counts"].items():
                totals[name] = totals.get(name, 0) + c
            if "invariant" in r:
                log(f"ranks {tag} rank {rank}: max |{RANK_INVARIANTS[algo][1]}{{s}} - node "
                    f"(i - s)'s copy| = {r['invariant']} after one more exchange")
                assert r["invariant"] <= INVARIANT_LIMIT, r["invariant"]
            if "vs_stacked" in r:
                diff, same = r["vs_stacked"]
                log(f"ranks {tag} rank {rank}: params vs the stacked run's node {rank}: "
                    f"bit_equal={same} max_abs_diff={diff}")
                assert diff <= RANK_STACKED_ATOL, diff
        losses = [runs[ri]["losses"] for runs in per_rank]
        assert all(l == losses[0] for l in losses), losses
        log(f"ranks {tag}: losses {losses[0]} consensus {per_rank[0][ri]['consensus']}")
    shutil.rmtree(ref_dir, ignore_errors=True)
    return totals


# a rank's params against the stacked run's node slice: equal unless cuBLAS
# picks another algorithm for a lone (1, ...) leaf than for a slice of a
# stacked one, which moves the gradients by rounding (and, through the
# stochastic codes, the params by at most a few updates of size lr)
RANK_STACKED_ATOL = 1e-3


# ------------------------------------------------------------ serving and families

DEVICE = "cuda"
# architectures whose f32 weights at full depth exceed what the card holds
# beside the serving and forward activations: their depth is cut to fit
SERVE_WEIGHT_BUDGET = 64e9       # bytes of float32 weights
SERVE_DEPTHS = {"deepseek-moe-16b": 27, "mistral-large-123b": 10, "internvl2-76b": 16}
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 6, 3, 32, 16
SERVE_PROFILED = ("granite-3-2b", "zamba2-7b", "deepseek-moe-16b")   # device time of a decode step
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
# the card against the CPU at the reduced widths, the same params and prompts
FAMILY_ATOL = 5e-2


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


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


def profile_decode(torch, model, params, tokens, arch: str, steps: int = 4) -> None:
    """``torch.profiler`` over ``steps`` decode steps of a warm batch."""
    from torch.profiler import ProfilerActivity, profile

    caches = model.init_cache(tokens.shape[0], steps + 1, device=tokens.device)
    _, caches = model.decode_step(params, caches, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, caches = model.decode_step(params, caches, tokens)
        torch.cuda.synchronize()
    report_profile(prof, f"serve {arch} decode", steps, time.perf_counter() - t0)


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
    if arch in SERVE_PROFILED:
        profile_decode(torch, model, params, prompts[:SERVE_BATCH, :1], arch)
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
    """granite-3-2b ``Model.prefill`` at S 4096 (every layer's attention
    through ``_sdpa_chunked``) against the same prefill with the unchunked
    ``_sdpa``, and layer 0's attention both ways on the same q, k, v."""
    from repro_torch.models import attention as attn
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import apply_rope, dense, rmsnorm
    from repro_torch.models.lm import _layer

    cfg = serve_config("granite-3-2b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=DEVICE)
    S = attn.FLASH_THRESHOLD
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)
    with torch.no_grad():
        chunked_ms = time_ms(torch, lambda: model.prefill(params, {"tokens": toks}), iters=2,
                             warmup=1)
        chunked = model.prefill(params, {"tokens": toks}).float()
        peak_chunked = torch.cuda.max_memory_allocated()
        threshold = attn.FLASH_THRESHOLD
        attn.FLASH_THRESHOLD = S + 1
        try:
            plain_ms = time_ms(torch, lambda: model.prefill(params, {"tokens": toks}), iters=2,
                               warmup=1)
            plain = model.prefill(params, {"tokens": toks}).float()
        finally:
            attn.FLASH_THRESHOLD = threshold
        lp = _layer(params["blocks"], 0)
        x = rmsnorm(params["embed"][toks].to(torch.bfloat16), lp["ln1"])
        pos = torch.arange(S, device=DEVICE)
        q = apply_rope(dense(x, lp["attn"]["wq"]).reshape(1, S, cfg.n_heads, cfg.hd), pos,
                       cfg.rope_theta)
        k = apply_rope(dense(x, lp["attn"]["wk"]).reshape(1, S, cfg.n_kv_heads, cfg.hd), pos,
                       cfg.rope_theta)
        v = dense(x, lp["attn"]["wv"]).reshape(1, S, cfg.n_kv_heads, cfg.hd)
        a_chunked = attn._sdpa_chunked(q, k, v).float()
        a_plain = attn._sdpa(q, k, v, attn.causal_mask(S, device=DEVICE)).float()
    err, std = float((chunked - plain).abs().max()), float(plain.std())
    a_err, a_max = float((a_chunked - a_plain).abs().max()), float(a_plain.abs().max())
    log(f"chunked: granite-3-2b n_layers={cfg.n_layers} prefill S={S}: chunked {chunked_ms:.2f} "
        f"ms, unchunked {plain_ms:.2f} ms; last-position logits max_abs_err={err:.4g} "
        f"(std {std:.4g}, bound {DECODE_REL * std:.4g}); layer-0 attention "
        f"max_abs_err={a_err:.4g} (max |out| {a_max:.4g}, two bf16 ulps there "
        f"{2 * bf16_ulp(a_max):.4g}); peak with the chunked path {peak_chunked} B "
        f"({peak_chunked / 2**30:.2f} GiB)")
    # one layer's attention differs by bf16 rounding of its output (the
    # chunked path normalizes after the PV product, the plain one before);
    # 40 layers compound it as the decode path's do (DECODE_REL)
    assert a_err <= 2 * bf16_ulp(a_max) and err <= DECODE_REL * std, (err, a_err)
    del params
    torch.cuda.empty_cache()


def phase_families_reference(torch) -> None:
    """Each family at its ``reduced()`` width, the same params and prompts on
    the card and on the CPU: 16 greedy decode steps on each device, then the
    card fed the CPU's greedy tokens.  The logits agree within
    ``FAMILY_ATOL`` at every step, and the card picks the CPU's token
    wherever the CPU's top two logits are more than twice that apart (a
    nearer tie may go either way)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import encdec as ed
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map

    def greedy(model, cfg, p, prompt, frames, dev, forced=None):
        caches = model.init_cache(2, 17, device=dev)
        if frames is not None:
            caches = ed.encdec_prefill_cross(cfg, p, frames.to(dev), caches)
        cur, logits, toks = prompt.to(dev), [], []
        for t in range(16):
            lg, caches = model.decode_step(p, caches, cur)
            cur = lg.argmax(-1) if forced is None else forced[:, t:t + 1].to(dev)
            logits.append(lg[:, 0].float().cpu())
            toks.append(lg.argmax(-1).cpu())
        return torch.stack(logits, 1), torch.cat(toks, 1)

    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(3)
        prompt = torch.randint(2, cfg.vocab, (2, 1), generator=gen)
        frames = torch.randn((2, cfg.frontend.n_tokens, cfg.frontend.dim), generator=gen) \
            if cfg.is_encdec else None
        card = tree_map(lambda t: t.to(DEVICE), params)
        lc, tc = greedy(model, cfg, params, prompt, frames, "cpu")
        _, tg = greedy(model, cfg, card, prompt, frames, DEVICE)
        lf, tf = greedy(model, cfg, card, prompt, frames, DEVICE, forced=tc)
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * FAMILY_ATOL
        err = float((lf - lc).abs().max())
        log(f"families {arch}: reduced, card vs cpu: free-running greedy tokens equal="
            f"{bool(torch.equal(tg, tc))}; fed the cpu's tokens: logits max_abs_err={err:.4g}, "
            f"argmax equal at {int(sure.sum())} unambiguous steps of 32: "
            f"{bool(torch.equal(tf[sure], tc[sure]))}")
        assert err <= FAMILY_ATOL and torch.equal(tf[sure], tc[sure]), (arch, err)


TRAIN_FAMILY_RUNS = (
    # (arch, n_layers, n_nodes, seq_len, global_batch)
    ("mamba2-370m", 12, 8, 256, 32),
    ("deepseek-v2-lite-16b", 2, 2, 256, 4),
)


def phase_train_families(torch, q, arch: str, n_layers: int, n_nodes: int, seq_len: int,
                         global_batch: int, steps: int = 3) -> dict:
    """DCD ``quant:8`` at the published widths of a family other than the
    dense decoder; the replicas must stay exactly ``roll(X, s)``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.distributed.wire import make_wire_format
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
    walk_took_the_kernel(q, calls0, counts)
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
    # K3 sends the leaves whose block passes the kernel's lane gate (the
    # others ride its plain version); K4a decodes every leaf once a payload
    wf = make_wire_format("quant:8")
    sends = sum(wf._kernel_ok(wf._block_for(l.shape[-1])) for l in leaves)
    want = {name: 0 for name in counts}
    want.update(quantize_2d=sends * steps, dequantize_2d=len(leaves) * (1 + len(shifts)) * steps,
                markov_walk=WALK_PER_STEP["markov_walk"] * steps,
                adamw_update=len(leaves) * steps)
    assert counts == want, (counts, want)
    resid = max_shift_residual(torch, tree_leaves, state.params,
                               {s: state.aux[f"rep{s:+d}"] for s in shifts})
    log(f"{tag}: invariant rep{{s}} == roll(X, s) for shifts {list(shifts)}: "
        f"max_abs_diff={resid}")
    assert resid <= INVARIANT_LIMIT, resid
    del hist, state
    torch.cuda.empty_cache()
    return counts


# the dryrun's executed plan: mistral-large-123b at its published widths,
# depth cut 88 -> 1, its plan's 2 nodes and bf16 replicas stacked on the
# card, remat, train_4k's 4096 positions and one sequence a node
EXEC_ARCH, EXEC_LAYERS, EXEC_SEQ = "mistral-large-123b", 1, 4096
# (algo, wire, steps, the kernels the run must launch): every bf16 variant
# launches on a path (CHOCO decodes only into bf16 estimates)
EXEC_RUNS = (
    ("dcd", "quant:8", 2, ("quantize_2d", "dequantize_2d")),
    ("dcd", "quant:4", 2, ("quantize_pack_2d", "unpack_dequant_axpy_2d",
                           "unpack_dequant_axpy_2d_bf16")),
    ("choco", "sign", 2, ("sign_pack_2d", "unpack_sign_axpy_2d_bf16")),
    ("choco", "sparse:0.05:topk", 2, ("sparse_select_pack_2d", "sparse_scatter_axpy_2d_bf16")),
    ("dcd", "lowrank:2:warm", 2, ("lowrank_project_2d", "lowrank_axpy_2d",
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


def phase_dryrun_smoke(torch, q) -> dict:
    """``dryrun_smoke`` on the card: reduced granite, DCD ``quant:8``, 2
    nodes, 2 executed steps with remat; its launches counted."""
    from repro_torch.launch.dryrun import dryrun_smoke
    q.reset_launch_counts()
    rec = dryrun_smoke("granite-3-2b", device="cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in q.launch_counts().items() if v}
    assert math.isfinite(rec["loss"]) and rec["n_devices"] == 1, rec
    log(f"dryrun smoke: loss={rec['loss']} launches {counts}")
    return counts


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


def phase_dryrun_plan(torch, q) -> dict:
    """The executed plan (``EXEC_RUNS``): mistral-large-123b's training
    plan at its published widths with the depth cut to ``EXEC_LAYERS``, its
    ``n_nodes`` stacked on the card on a ring with its bf16 replicas and its
    remat, random weights (seed 0) and one random sequence of ``EXEC_SEQ``
    tokens a node a step.  Per run the launch counts zeroed before and read
    after, the state's bytes on the card (as built) equal to the meta
    build's count, peak memory, step times (host clock around a step ending
    in a synchronize), each kernel's device time in one more step under
    ``torch.profiler`` (not timed), and the shared-state invariants: CHOCO's bf16
    ``hat{s}`` exactly ``roll(hat_self, s)``, DCD's bf16 ``rep{s}`` within
    :class:`ReplicaBound` of ``roll(X, s)``, a bound that a replica left at
    its initial value breaks; the records go to netsim's controller."""
    from torch.profiler import ProfilerActivity, profile

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
    totals, records = {}, []
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
        # one more step, profiled and not timed: each kernel's device ms a step
        batches = [make_batch(cfg, gen, 1, EXEC_SEQ) for _ in range(n)]
        batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
        report_profile(prof, tag, 1, time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if bound is not None:
            bound.advance(state)
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
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del state, step, aux, meta
    pplan = plan_phases_measured(records, total_steps=100)
    log("dryrun plan records: " + json.dumps(records))
    log(f"dryrun plan controller: {pplan.describe()}")
    torch.cuda.empty_cache()
    return totals


# the kernel phases ``--only`` runs; each takes (torch, the wrappers' module,
# ref, rec): K7's ``kernels/lowrank.py``, the walk's ``kernels/markov.py``
# and the others' ``kernels/quant.py``
KERNEL_PHASES = {"kernels": phase_kernels, "kernels_sign": phase_kernels_sign,
                 "kernels_sparse": phase_kernels_sparse, "kernels_decode": phase_kernels_decode,
                 "kernels_sparse_decode": phase_kernels_sparse_decode,
                 "kernels_lowrank": phase_kernels_lowrank, "kernels_markov": phase_kernels_markov,
                 "kernels_adamw": phase_kernels_adamw}
# the path phases ``--only`` runs; each takes (torch, the wrappers' module)
PATH_PHASES = {"gossip_reference": phase_gossip_reference, "analysis": phase_analysis}


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
    if only:
        for name in only:
            if name in PATH_PHASES:
                PATH_PHASES[name](torch, q)
            else:
                module = {"kernels_lowrank": lk, "kernels_markov": mk,
                          "kernels_adamw": ak}.get(name, q)
                KERNEL_PHASES[name](torch, module, ref, rec)
        log(f"{','.join(only)}: {time.perf_counter() - t0:.1f} s; {gpu_name_and_power()}")
        return 0
    meta_proc = start_meta_records(meta_cores)
    assert sorted(KERNELS) == sorted(q.launch_counts()), sorted(q.launch_counts())
    phase_kernels(torch, q, ref, rec)
    phase_kernels_sign(torch, q, ref, rec)
    phase_kernels_sparse(torch, q, ref, rec)
    phase_kernel_grids(q)
    phase_kernels_decode(torch, q, ref, rec)
    phase_kernels_sparse_decode(torch, q, ref, rec)
    phase_kernels_lowrank(torch, lk, ref, rec)
    phase_kernel_offsets(torch, q, ref, rec)
    phase_kernels_markov(torch, mk, ref, rec)
    phase_kernels_adamw(torch, ak, ref, rec)
    log(f"phases through kernels: {time.perf_counter() - t0:.1f} s")
    totals = {name: 0 for name in KERNELS}
    runs = [phase_train(torch, algo, wire, steps, per_step, q)
            for algo, wire, steps, per_step in TRAIN_RUNS]
    runs += [phase_stacked(torch, q, algo, comp, per_step)
             for algo, comp, per_step in stacked_runs()]
    runs.append(phase_quickstart(torch, q))
    runs.append(phase_gossip_reference(torch, q))
    runs.append(phase_analysis(torch, q))
    runs += [phase_plan_run(torch, q, label, fields, steps, launches)
             for label, fields, steps, launches in PLAN_RUNS]
    runs.append(phase_checkpoint(torch, q))
    runs += [phase_train_families(torch, q, *run) for run in TRAIN_FAMILY_RUNS]
    for counts in runs:
        for name, c in counts.items():
            totals[name] += c
    log(f"phases through train_families: {time.perf_counter() - t0:.1f} s")
    phase_profile(torch, "dcd", "quant:4")
    phase_profile(torch, "choco", "sign")
    phase_profile(torch, "choco", "sparse:0.05:topk")
    phase_profile(torch, "dcd", "lowrank:2:warm")
    phase_profile(torch, "dcd", "quant:8")
    _, ecd4, dcd_randk = stacked_runs()
    phase_profile_stacked(torch, "ecd", ecd4[1])
    phase_profile_stacked(torch, "dcd", dcd_randk[1])
    phase_reference(torch, "dcd", "quant:4")
    phase_reference(torch, "choco", "sign")
    phase_reference(torch, "dcd", "lowrank:2:warm")
    phase_reference(torch, "dcd", "quant:8", topology="full_logn", drop=0.1, n_nodes=8)
    phase_reference_stacked(torch)
    torch.cuda.empty_cache()
    log(f"phases through reference: {time.perf_counter() - t0:.1f} s")
    for name, c in phase_ranks(torch, q).items():
        totals[name] += c
    for name, c in phase_dryrun_smoke(torch, q).items():
        totals[name] += c
    for name, c in phase_dryrun_plan(torch, q).items():
        totals[name] += c
    log(f"phases through dryrun: {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import ARCH_IDS
    served = [phase_serve(torch, arch) for arch in ARCH_IDS]
    log("serve summary: " + json.dumps(served))
    log(f"phases through serve: {time.perf_counter() - t0:.1f} s")
    phase_chunked(torch)
    phase_families_reference(torch)
    finish_meta_records(*meta_proc)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": totals[name], "max_abs_err": rec[name]["err"],
                "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
                "bound_ms": rec[name]["bound"][0], "bound_by": rec[name]["bound"][1],
                "library_ms": rec[name].get("library_ms")}
               for name, (src, replaces) in KERNELS.items()]
    assert all(k["launches"] > 0 for k in kernels), totals
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(gpu_name_and_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
