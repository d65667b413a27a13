"""What a step must compute and move, from shapes alone, and the card's peaks.

* :func:`model_flops_per_token`: the forward and backward operations of one
  token, counted once (no recomputation): ``6 x`` the parameters that enter
  a matrix product, plus each layer's mixer operations beyond them, both as
  the configuration's family counts them (``bench/families/<family>.py``:
  attention's two products over the full ``S x S`` square, the SSD scan's
  chunk products).
* :func:`wire_kernel_work`: the bytes the wire kernels of one step must
  read and write (each input byte read once, each output byte written
  once), whichever kernel does the work: an encode reads the float32 leaf
  and writes its codes and scales; a fused receive reads codes, scales and
  the float32 accumulator and writes the accumulator; an unfused receive
  reads codes and scales and writes a float32 leaf.  Per leaf and gossip
  round, DCD encodes once and receives once for its own parameters and once
  for each neighbour's copy.
* :data:`PEAKS`: NVIDIA's published H100 SXM rates at the 700 W limit.
"""
from __future__ import annotations

import math

from bench import families

PEAKS = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}

# the CUDA symbols of the program's wire kernels, as the profiler names them
WIRE_KERNEL_SYMBOLS = ("quantize_pack_kernel", "unpack_dequant_axpy_kernel", "quantize_kernel",
                       "dequantize_kernel", "unpack_dequant_kernel", "sign_pack_kernel",
                       "unpack_sign_axpy_kernel", "sparse_select_pack_",
                       "sparse_unpack_scatter_kernel", "sparse_scatter_axpy_",
                       "lowrank_project_kernel", "lowrank_axpy_")


def bound_seconds(nbytes: float, f32_ops: float = 0.0) -> float:
    """The least time: the larger of the bytes over the memory bandwidth and
    the float32 operations over the float32 peak."""
    return max(nbytes / PEAKS["hbm_bytes"], f32_ops / PEAKS["f32_flops"])


def matmul_params(cfg: dict) -> int:
    """Parameters of one node that enter a matrix product (the LM head
    included, the embedding lookup not)."""
    d, vp = cfg["d_model"], -(-cfg["vocab"] // 256) * 256
    return sum(families.of(cfg).matmul_params_per_layer(cfg)) + d * vp


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    return 6.0 * matmul_params(cfg) + sum(families.of(cfg).mixer_flops_per_token(cfg, seq_len))


def _fold(shape, wire: dict) -> tuple:
    """(rows, block) of the blocked fold of a stacked leaf."""
    last = shape[-1]
    block = min(wire["block"], max(last, 1))
    if wire["packed"]:
        codes = math.lcm(wire["bits"], 32) // wire["bits"]
        block = min(wire["block"], -(-block // codes) * codes)
    return math.prod(shape[:-1]) * -(-last // block), block


def wire_kernel_work(leaf_shapes, traffic: dict) -> tuple:
    """``(bytes, f32 operations)`` the wire kernels of one step must move and
    compute over the stacked leaves of ``leaf_shapes``; ``(0, 0)`` without a
    wire.  Operations an element as ``chip_smoke.py`` counts them: 8 for an
    encode (hash and round), 3 for a fused receive, 1 for a decode (and 1 a
    row)."""
    if traffic["algo"] != "dcd":
        return 0, 0
    kind, _, bits = traffic["wire"].partition(":")
    if kind != "quant":
        raise ValueError(f"wire work is counted for quant wires, got {traffic['wire']}")
    bits = int(bits)
    wire = {"bits": bits, "block": 1024, "packed": bits < 8}
    receives = 1 + 2        # own parameters and both ring neighbours' copies
    nbytes = ops = 0
    for shape in leaf_shapes:
        rows, block = _fold(shape, wire)
        elems = math.prod(shape)
        codes = rows * block * bits // 8 + rows * 4
        nbytes += elems * 4 + codes                        # encode
        ops += 8 * rows * block
        if wire["packed"]:
            nbytes += receives * (codes + 2 * elems * 4)   # fused receive into float32
            ops += receives * 3 * rows * block
        else:
            nbytes += receives * (codes + elems * 4)       # decode to a float32 leaf
            ops += receives * (rows * block + rows)
    return nbytes, ops
