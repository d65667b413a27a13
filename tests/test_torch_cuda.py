"""Card-only tests of the port's CUDA kernels (marker ``cuda``): K1, K2, K3,
K4a, K4b, K5a, K5b, K6, K6b, K6c, K7a and K7b, and the bf16-accumulator
variants of K2, K5b, K6c and K7b, the data layer's Markov walk and the
optim layer's AdamW update, against their plain versions; the nodes'
gradients of ``_node_grads`` against per-node indexing (peak memory and
bits); the dryrun's
executed smoke on the card; the
step analyzer's grid on the card (``repro_torch.analysis.step_checks``); a
step of the small DeepSeek-V2-Lite cell (latent attention, dropless expert
share) with no host read; Nemotron 3 Nano at its published widths against
the benchmark's reference, with no host read.

    python -m pytest -m cuda tests/test_torch_cuda.py     # on a machine with an H100

Each test asks the ``cuda`` fixture for the device; the fixture decides
whether a card and nvcc are present when the test runs, never at import, so
every pytest-xdist worker collects the same tests.  Without a card they skip.
This file imports no JAX: the plain PyTorch versions are the reference here.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import step_checks as sc
from repro_torch.kernels import build
from repro_torch.kernels import lowrank as lk
from repro_torch.kernels import quant as q
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _x(rows, cols, device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device=device)
    x[0].zero_()
    x[1, :3] = -0.0
    return x


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("rows,cols", [(37, 128), (64, 1024), (9, 512)])
def test_quantize_pack_kernel_bit_equal(cuda, bits, rows, cols):
    x = _x(rows, cols, cuda, seed=bits)
    before = q.quantize_pack_2d.launches
    words, scale = q.quantize_pack_2d(x, 0xABCDEF ^ bits, bits=bits)
    torch.cuda.synchronize()
    assert q.quantize_pack_2d.launches == before + 1
    w_ref, s_ref = ref.quantize_pack_2d_ref(x, 0xABCDEF ^ bits, bits=bits)
    assert torch.equal(words, w_ref) and torch.equal(scale, s_ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (-1.0, 2.0), (0.5, 1.0 / 3.0)])
def test_unpack_dequant_axpy_kernel_bit_equal(cuda, bits, acc_weight, weight):
    x = _x(40, 256, cuda, seed=bits)
    acc = _x(40, 256, cuda, seed=100 + bits)
    words, scale = q.quantize_pack_2d(x, 5, bits=bits)
    out = q.unpack_dequant_axpy_2d(words, scale, acc, bits=bits, weight=weight,
                                   acc_weight=acc_weight)
    want = ref.unpack_dequant_axpy_2d_ref(words, scale, acc, bits=bits, weight=weight,
                                          acc_weight=acc_weight)
    assert torch.equal(out, want)
    q.unpack_dequant_axpy_2d(words, scale, acc, bits=bits, weight=weight,
                             acc_weight=acc_weight, out=acc)     # in place
    assert torch.equal(acc, want)


def test_wire_dcd_round_on_card_matches_cpu(cuda):
    """One stacked quant:4 encode + in-place decode on the card equals the
    CPU's (plain versions), words and floats."""
    from repro_torch.distributed.wire import QuantWire

    wire = QuantWire(bits=4, block=1024)
    leaf = _x(8, 3000, cuda, seed=3).reshape(8, 1, 3000) * 0.01
    acc = _x(8, 3000, cuda, seed=4).reshape(8, 1, 3000)
    p_gpu = wire.encode(leaf, 77)
    p_cpu = wire.encode(leaf.cpu(), 77)
    assert torch.equal(p_gpu["codes"].cpu(), p_cpu["codes"])
    assert torch.equal(p_gpu["scale"].cpu(), p_cpu["scale"])
    a_cpu = acc.cpu()
    wire.decode_axpy_(p_gpu, acc, 2.0, -1.0)
    wire.decode_axpy_(p_cpu, a_cpu, 2.0, -1.0)
    assert torch.equal(acc.cpu(), a_cpu)


def _edge_rows(x):
    """All-zero row, -0.0 entries, a NaN, exact ties (both signs)."""
    x[0].zero_()
    x[1, :9] = -0.0
    x[2, 5] = float("nan")
    x[3, :] = 0.75
    x[3, 1::2] = -0.75
    return x


@pytest.mark.parametrize("scale_mode", ["mean", "l2"])
@pytest.mark.parametrize("rows,cols", [(37, 128), (64, 1024), (9, 384), (5, 8192)])
def test_sign_pack_kernel_bit_equal(cuda, scale_mode, rows, cols):
    x = _edge_rows(_x(rows, cols, cuda, seed=cols))
    before = q.sign_pack_2d.launches
    words, scale = q.sign_pack_2d(x, scale_mode=scale_mode)
    torch.cuda.synchronize()
    assert q.sign_pack_2d.launches == before + 1
    w_ref, s_ref = ref.sign_pack_2d_ref(x, scale_mode=scale_mode)
    assert torch.equal(words, w_ref) and ref.same_bits(scale, s_ref)


@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (1.0, -1.0), (0.5, 1.0 / 3.0)])
def test_unpack_sign_axpy_kernel_bit_equal(cuda, acc_weight, weight):
    x = _edge_rows(_x(40, 1024, cuda, seed=3))
    acc = _x(40, 1024, cuda, seed=4)
    words, scale = q.sign_pack_2d(x)
    out = q.unpack_sign_axpy_2d(words, scale, acc, weight=weight, acc_weight=acc_weight)
    want = ref.unpack_sign_axpy_2d_ref(words, scale, acc, weight=weight, acc_weight=acc_weight)
    assert ref.same_bits(out, want)
    q.unpack_sign_axpy_2d(words, scale, acc, weight=weight, acc_weight=acc_weight, out=acc)
    assert ref.same_bits(acc, want)


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("p", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("rows,cols", [(37, 128), (20, 1024), (6, 384), (5, 4096), (5, 8192)])
def test_sparse_select_pack_kernel_bit_equal(cuda, mode, p, rows, cols):
    x = _edge_rows(_x(rows, cols, cuda, seed=cols + 1))
    for value_dtype in (torch.float32, torch.float16):
        before = q.sparse_select_pack_2d.launches
        vals, idx = q.sparse_select_pack_2d(x, 0xC0FFEE, p=p, mode=mode, value_dtype=value_dtype)
        torch.cuda.synchronize()
        assert q.sparse_select_pack_2d.launches == before + 1
        v_ref, i_ref = ref.sparse_select_pack_2d_ref(x, 0xC0FFEE, p=p, mode=mode,
                                                     value_dtype=value_dtype)
        assert torch.equal(idx, i_ref) and ref.same_bits(vals, v_ref)


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("p", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("rows,cols", [(10000, 128), (1, 128), (20, 640), (11, 384),
                                       (9, 1024), (9, 4096)])
def test_sparse_select_pack_kernel_selection_edges(cuda, mode, p, rows, cols):
    """K6 bit-equal to its plain version on its selection edges, across many
    CTAs and the persistent loop (10,000 rows), on a single row, and at a
    span that is not a power of two (640 = 32 x 20), in both value types."""
    g = torch.Generator(device=cuda)
    g.manual_seed(rows + cols)
    x = torch.randn((rows, cols), generator=g, device=cuda)
    if rows > 1:
        x = ref.sparse_selection_edge_rows(_edge_rows(x), 4)
    else:
        x[0, 3:40] = 0.5                        # one row: ties across lanes
    for value_dtype in (torch.float32, torch.float16):
        before = q.sparse_select_pack_2d.launches
        vals, idx = q.sparse_select_pack_2d(x, 0xBEEF, p=p, mode=mode, value_dtype=value_dtype)
        torch.cuda.synchronize()
        assert q.sparse_select_pack_2d.launches == before + 1
        v_ref, i_ref = ref.sparse_select_pack_2d_ref(x, 0xBEEF, p=p, mode=mode,
                                                     value_dtype=value_dtype)
        assert torch.equal(idx, i_ref) and ref.same_bits(vals, v_ref)


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("k", range(1, 10))
def test_sparse_select_pack_kernel_small_k(cuda, mode, k):
    """K6 at the wire's block for k = 1 to 9 (p = k/128): the thread-a-row
    path up to k = 8 and the rounds past it, on 300 rows (a partial last warp
    of rows) with the edge rows, a fold of zeros and a constant fold (every
    key tied)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(k)
    x = ref.sparse_selection_edge_rows(_edge_rows(torch.randn((300, 128), generator=g,
                                                               device=cuda)), 4)
    for fold in (x, torch.zeros_like(x), torch.full_like(x, -0.5)):
        got = q.sparse_select_pack_2d(fold, 0xBEEF, p=k / 128, mode=mode)
        want = ref.sparse_select_pack_2d_ref(fold, 0xBEEF, p=k / 128, mode=mode)
        assert got[0].shape[1] == k
        assert torch.equal(got[1], want[1]) and ref.same_bits(got[0], want[0])


def test_sparse_select_pack_kernel_unaligned_rows(cuda):
    """A fold whose first element is not 16-byte aligned takes the kernel's
    element-wise loads and still agrees bit for bit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    flat = torch.randn(40 * 128 + 1, generator=g, device=cuda)
    x = ref.sparse_selection_edge_rows(_edge_rows(flat[1:].view(40, 128)), 4)
    assert x.data_ptr() % 16 != 0
    for mode in ("topk", "randk"):
        got = q.sparse_select_pack_2d(x, 11, p=0.05, mode=mode)
        want = ref.sparse_select_pack_2d_ref(x, 11, p=0.05, mode=mode)
        assert torch.equal(got[1], want[1]) and ref.same_bits(got[0], want[0])


# Two K6 register instances with the same shared memory a CTA (8 warps x 20
# index words): 640 columns at p 0.1 take the 20-column span, 1024 at p 0.05
# the 32-column one.  A grid cache keyed by shared memory alone would hand
# one instance the other's occupancy.
GRID_PAIR = ((640, 0.1), (1024, 0.05))
_GRID_SCRIPT = """
import json, sys
from repro_torch.kernels import quant as q
print(json.dumps([q.sparse_select_pack_2d_grid(200000, int(c), float(p))
                  for c, p in (a.split(":") for a in sys.argv[1:])]))
"""


def _grids_in_fresh_process(order):
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _GRID_SCRIPT, *(f"{c}:{p}" for c, p in order)],
                         capture_output=True, text=True, check=True, env=env, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sparse_select_pack_grid_keyed_by_kernel(cuda):
    """K6's persistent grid is looked up per kernel instance: each width's
    grid is the same whichever width a process asked for first, and launches
    that alternate the two widths stay bit-equal to the plain version."""
    (ca, pa), (cb, pb) = GRID_PAIR
    a_first = _grids_in_fresh_process([(ca, pa), (cb, pb), (ca, pa)])
    b_first = _grids_in_fresh_process([(cb, pb), (ca, pa), (cb, pb)])
    assert a_first[0] == a_first[2] == b_first[1], (a_first, b_first)
    assert b_first[0] == b_first[2] == a_first[1], (a_first, b_first)
    g = torch.Generator(device=cuda)
    g.manual_seed(640)
    xs = {c: ref.sparse_selection_edge_rows(_edge_rows(torch.randn((20000, c), generator=g,
                                                                   device=cuda)), 4)
          for c, _ in GRID_PAIR}
    for c, p in GRID_PAIR * 2:
        for mode in ("topk", "randk"):
            got = q.sparse_select_pack_2d(xs[c], 0xFEED, p=p, mode=mode)
            want = ref.sparse_select_pack_2d_ref(xs[c], 0xFEED, p=p, mode=mode)
            assert torch.equal(got[1], want[1]) and ref.same_bits(got[0], want[0]), (c, p, mode)


@pytest.mark.parametrize("cols", [128, 8192])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (1.0, -1.0), (0.5, 1.0 / 3.0)])
def test_sparse_scatter_axpy_kernel_bit_equal(cuda, value_dtype, acc_weight, weight, cols):
    x = _edge_rows(_x(33, cols, cuda, seed=9))
    acc = _x(33, cols, cuda, seed=10)
    vals, idx = q.sparse_select_pack_2d(x, 5, p=0.25, mode="topk", value_dtype=value_dtype)
    out = q.sparse_scatter_axpy_2d(vals, idx, acc, weight=weight, acc_weight=acc_weight)
    want = ref.sparse_scatter_axpy_2d_ref(vals, idx, acc, weight=weight, acc_weight=acc_weight)
    assert ref.same_bits(out, want)
    q.sparse_scatter_axpy_2d(vals, idx, acc, weight=weight, acc_weight=acc_weight, out=acc)
    assert ref.same_bits(acc, want)


def _acc_views(shape, dtype, device, seed):
    """An accumulator with zeros, -0.0 and a NaN, as ``ref.offset_views``:
    its own, one row into a buffer, one element into a buffer."""
    n_rows = math.prod(shape) // shape[-1]
    acc = _x(max(n_rows, 2), shape[-1], device, seed=seed)[:n_rows].to(dtype)
    acc.view(-1)[-5] = float("nan")
    views = ref.offset_views(acc.view(shape))
    assert views["off1"].data_ptr() % 16 != 0
    assert views["own"].data_ptr() % 16 == 0 and views["row1"].data_ptr() % 16 == 0
    return views


def _k6c_path(cols, k, kpad, acc, out):
    return build.load("sparse").sparse_scatter_axpy_2d_path(cols, k, kpad, acc.data_ptr(),
                                                            out.data_ptr())


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("k", [1, 8, 9])
@pytest.mark.parametrize("rows", [1, 33, 200003])
def test_sparse_scatter_axpy_paths_bit_equal(cuda, acc_dtype, value_dtype, k, rows):
    """K6c at the wire's block on K6's payloads: k = 1 and 8 take the rows
    path (up to its edge), k = 9 the slot-map path; row counts that fill no
    whole step of the persistent grid; an accumulator of its own, one a row
    into a buffer, one off 16-byte alignment (the slot-map path's scalar
    accesses); a fresh ``out`` and ``out=acc``."""
    cols = 128
    x = ref.sparse_selection_edge_rows(_edge_rows(_x(max(rows, 10), cols, cuda, seed=k)), 4)
    x = x[:rows]
    vals, idx = q.sparse_select_pack_2d(x, 21, p=k / cols, mode="topk", value_dtype=value_dtype)
    assert vals.shape[1] == k
    kpad = idx.shape[1] * 32 // ref.idx_bits_for(cols)
    counter = q.SPARSE_SCATTER_AXPY_2D_BF16 if acc_dtype == torch.bfloat16 \
        else q.sparse_scatter_axpy_2d
    for name, acc in _acc_views((rows, cols), acc_dtype, cuda, seed=rows + k).items():
        for aw, w in ((1.0, 1.0), (0.75, -0.5)):
            want = ref.sparse_scatter_axpy_2d_ref(vals, idx, acc, weight=w, acc_weight=aw)
            fresh = torch.empty_like(acc)
            rows_path = k <= 8 and name != "off1"
            assert _k6c_path(cols, k, kpad, acc, fresh) == int(rows_path), name
            before = counter.launches
            got = q.sparse_scatter_axpy_2d(vals, idx, acc, weight=w, acc_weight=aw, out=fresh)
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert ref.same_bits(got, want), (name, aw, w)
            inplace = acc.clone() if name == "own" else acc
            saved = acc.clone()
            assert _k6c_path(cols, k, kpad, inplace, inplace) == int(rows_path), name
            q.sparse_scatter_axpy_2d(vals, idx, inplace, weight=w, acc_weight=aw, out=inplace)
            torch.cuda.synchronize()
            assert ref.same_bits(inplace, want), (name, "in place", aw, w)
            acc.copy_(saved)


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.float16])
def test_sparse_scatter_axpy_drops_an_index_past_cols(cuda, acc_dtype, value_dtype):
    """A constructed index word holding indices >= cols
    (``ref.sparse_payload_past_cols``): the kernel drops them, on the
    slot-map path's vector and scalar accesses."""
    (vals, packed), (kept_vals, kept) = ref.sparse_payload_past_cols(value_dtype, cuda)
    rows, cols = vals.shape[0], 384
    for name, acc in _acc_views((rows, cols), acc_dtype, cuda, seed=7).items():
        want = ref.sparse_scatter_axpy_2d_ref(kept_vals, kept, acc, weight=0.75, acc_weight=0.5)
        got = q.sparse_scatter_axpy_2d(vals, packed, acc, weight=0.75, acc_weight=0.5)
        torch.cuda.synchronize()
        assert ref.same_bits(got, want), name


@pytest.mark.parametrize("spec", ["sign", "sparse:0.05:topk", "sparse:0.25:randk:256"])
def test_wire_choco_round_on_card_matches_cpu(cuda, spec):
    """Encode + in-place decode of a stacked ragged leaf on the card equals
    the CPU's (plain versions), containers and floats."""
    from repro_torch.distributed.wire import make_wire_format

    wire = make_wire_format(spec)
    leaf = _x(8, 3000, cuda, seed=5).reshape(8, 1, 3000)
    acc = _x(8, 3000, cuda, seed=6).reshape(8, 1, 3000)
    p_gpu = wire.encode(leaf, 77)
    p_cpu = wire.encode(leaf.cpu(), 77)
    for k in p_cpu:
        assert ref.same_bits(p_gpu[k].cpu(), p_cpu[k]), k
    a_cpu = acc.cpu()
    wire.decode_axpy_(p_gpu, acc, 1.0 / 3.0, 1.0)
    wire.decode_axpy_(p_cpu, a_cpu, 1.0 / 3.0, 1.0)
    assert ref.same_bits(acc.cpu(), a_cpu)


def test_wrappers_raise_on_rows_wider_than_the_kernels(cuda):
    """A CUDA row past ``MAX_COLS`` raises in every wrapper; nothing falls
    back to the plain version on the card."""
    cols = 2 * q.MAX_COLS
    x = _x(2, cols, cuda)
    words, scale = ref.quantize_pack_2d_ref(x, 1, bits=4)
    signs, sign_scale = ref.sign_pack_2d_ref(x)
    vals, idx = ref.sparse_select_pack_2d_ref(x, 1, p=0.01, mode="topk")
    before = q.launch_counts()
    for call in (lambda: q.quantize_pack_2d(x, 1, bits=4),
                 lambda: q.quantize_2d(x, 1, bits=8),
                 lambda: q.sparse_unpack_scatter_2d(vals, idx, cols=cols),
                 lambda: q.unpack_dequant_axpy_2d(words, scale, x, bits=4, weight=1.0),
                 lambda: q.sign_pack_2d(x),
                 lambda: q.unpack_sign_axpy_2d(signs, sign_scale, x, weight=1.0),
                 lambda: q.sparse_select_pack_2d(x, 1, p=0.01, mode="topk"),
                 lambda: q.sparse_scatter_axpy_2d(vals, idx, x, weight=1.0)):
        with pytest.raises(ValueError, match="at most"):
            call()
    assert q.launch_counts() == before


def _lowrank_inputs(batch, rows, n, rank, device, seed):
    """M with a zero row, -0.0 entries and a NaN; factors centred uniform
    with a -0.0; the cold factor shared at batch stride 0, the warm one per
    slab."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = torch.randn((batch, rows, n), generator=g, device=device)
    m[0, 0].zero_()
    m[0, min(1, rows - 1), :7] = -0.0
    m[-1, min(2, rows - 1), 3] = float("nan")
    v0 = torch.rand((n, rank), generator=g, device=device) - 0.5
    v0[0, 0] = -0.0
    vw = torch.rand((batch, n, rank), generator=g, device=device) - 0.5
    return m, {"cold": v0.expand(batch, n, rank), "warm": vw}


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 8, 9, 128])
@pytest.mark.parametrize("batch,rows,n", [(3, 37, 384), (8, 1, 2048), (2, 70, 100),
                                          (1, 5, 49408)])
def test_lowrank_project_kernel_bit_equal(cuda, rank, batch, rows, n):
    m, factors = _lowrank_inputs(batch, rows, n, rank, cuda, seed=rank * 7 + n)
    for mode, v in factors.items():
        before = lk.lowrank_project_2d.launches
        p = lk.lowrank_project_2d(m, v)
        torch.cuda.synchronize()
        assert lk.lowrank_project_2d.launches == before + 1
        assert ref.same_bits(p, ref.lowrank_project_2d_ref(m, v)), mode
        # a node's result does not depend on its position in the batch
        assert ref.same_bits(p[1:], lk.lowrank_project_2d(m[1:].contiguous(), v[1:]))


@pytest.mark.parametrize("rank", [1, 2, 4, 128])
@pytest.mark.parametrize("batch,rows,n", [(3, 37, 384), (8, 1, 2048), (2, 70, 256)])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (0.5, -2.0), (1.0 / 3.0, 0.7)])
def test_lowrank_axpy_kernel_bit_equal(cuda, rank, batch, rows, n, acc_weight, weight):
    m, factors = _lowrank_inputs(batch, rows, n, rank, cuda, seed=rank + n)
    acc = _x(batch * rows, n, cuda, seed=rank).reshape(batch, rows, n)
    for mode, v in factors.items():
        p = ref.lowrank_project_2d_ref(m, v)
        p[0, 0] = -0.0
        before = lk.lowrank_axpy_2d.launches
        out = lk.lowrank_axpy_2d(p, v, acc, weight=weight, acc_weight=acc_weight)
        torch.cuda.synchronize()
        assert lk.lowrank_axpy_2d.launches == before + 1
        want = ref.lowrank_axpy_2d_ref(p, v, acc, weight=weight, acc_weight=acc_weight)
        assert ref.same_bits(out, want), mode
        inplace = acc.clone()
        lk.lowrank_axpy_2d(p, v, inplace, weight=weight, acc_weight=acc_weight, out=inplace)
        assert ref.same_bits(inplace, want), mode


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 128])
@pytest.mark.parametrize("rows,n", [(1, 128), (17, 128), (1, 49408), (17, 49408)])
def test_lowrank_axpy_paths_bit_equal(cuda, acc_dtype, rank, rows, n):
    """K7b's rows path (ranks 1, 2, 4 on 16-byte aligned views) and scalar
    path (ranks 3, 5, 128, and any rank off alignment), cold (one factor at
    batch stride 0) and warm, into a fresh ``out`` and in place.  Factors
    are >= 0, so slab 0's row 0, whose P is -0.0, has a -0.0 dot; with a
    -0.0 accumulator row and w > 0 it must stay -0.0 (a padded +0.0 product
    would make it +0.0)."""
    batch = 3
    g = torch.Generator(device=cuda)
    g.manual_seed(rank * 131 + rows + n)
    p = torch.randn((batch, rows, rank), generator=g, device=cuda)
    p[0, 0] = -0.0
    factors = {"cold": torch.rand((n, rank), generator=g, device=cuda).expand(batch, n, rank),
               "warm": torch.rand((batch, n, rank), generator=g, device=cuda)}
    lib = build.load("lowrank")
    counter = lk.LOWRANK_AXPY_2D_BF16 if acc_dtype == torch.bfloat16 else lk.lowrank_axpy_2d
    for name, acc in _acc_views((batch, rows, n), acc_dtype, cuda, seed=rank + n).items():
        acc[0, 0] = -0.0
        rows_path = rank in (1, 2, 4) and name != "off1"
        for mode, v in factors.items():
            for aw, w in ((1.0, 1.0), (0.5, -2.0)):
                want = ref.lowrank_axpy_2d_ref(p, v, acc, weight=w, acc_weight=aw)
                fresh = torch.empty_like(acc)
                assert lib.lowrank_axpy_2d_path(rank, rows, acc.data_ptr(),
                                                fresh.data_ptr()) == int(rows_path), name
                before = counter.launches
                got = lk.lowrank_axpy_2d(p, v, acc, weight=w, acc_weight=aw, out=fresh)
                torch.cuda.synchronize()
                assert counter.launches == before + 1
                assert ref.same_bits(got, want), (name, mode, aw, w)
                if w > 0:
                    assert bool(torch.signbit(got[0, 0]).all()), (name, mode, "-0.0 row")
                inplace = acc.clone() if name == "own" else acc
                saved = acc.clone()
                lk.lowrank_axpy_2d(p, v, inplace, weight=w, acc_weight=aw, out=inplace)
                torch.cuda.synchronize()
                assert ref.same_bits(inplace, want), (name, mode, "in place", aw, w)
                acc.copy_(saved)


@pytest.mark.parametrize("spec", ["lowrank:2", "lowrank:4"])
def test_lowrank_wire_round_on_card_matches_cpu(cuda, spec):
    """A stacked matrix leaf's encode on the card: K7a's projection bit-equal
    to the CPU's; MGS and the re-projection are torch sums, equal to
    rounding.  The receive of one payload bit-equal on both."""
    from repro_torch.distributed.wire import make_wire_format

    wire = make_wire_format(spec)
    leaf = _x(8 * 48, 640, cuda, seed=11).reshape(8, 1, 48, 640)
    acc = _x(8 * 48, 640, cuda, seed=12).reshape(8, 1, 48, 640)
    m, v0 = leaf.reshape(8, 48, 640), wire._factor_init(640, 77, cuda)
    assert ref.same_bits(lk.lowrank_project_2d(m, v0.expand(8, 640, wire.rank)).cpu(),
                         ref.lowrank_project_2d_ref(m.cpu(), v0.cpu()))
    p_gpu = wire.encode(leaf, 77)
    p_cpu = wire.encode(leaf.cpu(), 77)
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k].cpu(), p_cpu[k], rtol=1e-4, atol=1e-5)
    a_cpu = acc.cpu()
    wire.decode_axpy_({k: t.to(cuda) for k, t in p_cpu.items()}, acc, 0.5, 1.0)
    wire.decode_axpy_(p_cpu, a_cpu, 0.5, 1.0)
    assert ref.same_bits(acc.cpu(), a_cpu)


def test_lowrank_wrappers_raise_past_what_the_kernels_take(cuda):
    m = _x(4, 256, cuda).reshape(1, 4, 256)
    before = q.launch_counts()
    with pytest.raises(ValueError, match="ranks"):
        lk.lowrank_project_2d(m, torch.zeros((1, 256, 129), device=cuda))
    with pytest.raises(ValueError, match="n % 128"):
        lk.lowrank_axpy_2d(torch.zeros((4, 2), device=cuda), torch.zeros((100, 2), device=cuda),
                           torch.zeros((4, 100), device=cuda), weight=1.0)
    with pytest.raises(ValueError, match="slabs"):
        lk.lowrank_project_2d(torch.zeros((65536, 1, 128), device=cuda),
                              torch.zeros((128, 2), device=cuda).expand(65536, 128, 2))
    with pytest.raises(ValueError, match="batch stride"):
        lk.lowrank_project_2d(torch.zeros((2, 4, 256), device=cuda),
                              torch.zeros((4, 256, 2), device=cuda)[::2])
    assert q.launch_counts() == before


# ---------------------------------------------- K1's NaN row, K3, K4a, K4b, K6b

def _nan_row_holds(got, want, bits, row, lane):
    """NaN scale on ``row``, every other row and every other code of the row
    bit-equal (the NaN element's own code is implementation-defined)."""
    (gc, gs), (wc, ws) = got, want
    keep = torch.ones(gc.shape[0], dtype=torch.bool, device=gc.device)
    keep[row] = False
    if gc.dtype == torch.int32:
        cg, cw = ref.unpack_codes(gc[row:row + 1], bits=bits), ref.unpack_codes(
            wc[row:row + 1], bits=bits)
    else:
        cg, cw = gc[row:row + 1], wc[row:row + 1]
    lanes = torch.arange(cg.shape[1], device=cg.device) != lane
    return (bool(gs[row].isnan().all()) and torch.equal(gc[keep], wc[keep])
            and ref.same_bits(gs, ws) and torch.equal(cg[:, lanes], cw[:, lanes]))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("rows,cols", [(37, 128), (9, 1024)])
def test_quantize_pack_kernel_nan_row(cuda, bits, rows, cols):
    """K1 on a row holding a NaN: NaN scale, the row unnormalised (safe 1),
    every other code bit-equal, the row decodes to NaN (K4b and K2)."""
    x = _x(rows, cols, cuda, seed=bits) * 0.05
    x[2, 5] = float("nan")
    got = q.quantize_pack_2d(x, 0xA11CE, bits=bits)
    assert _nan_row_holds(got, ref.quantize_pack_2d_ref(x, 0xA11CE, bits=bits), bits, 2, 5)
    w2, s2 = got[0][2:3].contiguous(), got[1][2:3].contiguous()
    assert q.unpack_dequant_2d(w2, s2, bits=bits).isnan().all()
    assert q.unpack_dequant_axpy_2d(w2, s2, torch.zeros((1, cols), device=cuda), bits=bits,
                                    weight=1.0).isnan().all()


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
@pytest.mark.parametrize("rows,cols", [(37, 128), (64, 1024), (9, 512), (5, 8192)])
def test_quantize_kernel_bit_equal(cuda, bits, rows, cols):
    x = _x(rows, cols, cuda, seed=bits + cols)
    before = q.quantize_2d.launches
    codes, scale = q.quantize_2d(x, 0x51DE ^ bits, bits=bits)
    torch.cuda.synchronize()
    assert q.quantize_2d.launches == before + 1
    c_ref, s_ref = ref.quantize_2d_ref(x, 0x51DE ^ bits, bits=bits)
    assert torch.equal(codes, c_ref) and torch.equal(scale, s_ref)
    x[2, 5] = float("nan")
    got = q.quantize_2d(x, 3, bits=bits)
    assert _nan_row_holds(got, ref.quantize_2d_ref(x, 3, bits=bits), bits, 2, 5)
    assert q.dequantize_2d(got[0][2:3].contiguous(), got[1][2:3].contiguous(),
                           bits=bits).isnan().all()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows,cols", [(37, 1), (9, 3), (64, 32), (5, 100), (40, 1024),
                                       (3, 20000)])
def test_dequantize_kernel_bit_equal(cuda, bits, rows, cols):
    """K4a at any width (the vector path at cols % 4 == 0, the scalar path
    otherwise), a NaN and a zero scale among the rows."""
    x = _x(rows, cols, cuda, seed=cols)
    codes, scale = ref.quantize_2d_ref(x, 9, bits=bits)
    scale[1] = float("nan")
    scale[2] = 0.0
    before = q.dequantize_2d.launches
    out = q.dequantize_2d(codes, scale, bits=bits)
    torch.cuda.synchronize()
    assert q.dequantize_2d.launches == before + 1
    assert ref.same_bits(out, ref.dequantize_2d_ref(codes, scale, bits=bits))
    # an offset view: the scalar path on an unaligned pointer
    if rows > 1:
        c1, s1 = codes[1:], scale[1:]
        assert ref.same_bits(q.dequantize_2d(c1, s1, bits=bits),
                             ref.dequantize_2d_ref(c1, s1, bits=bits))


@pytest.mark.parametrize("bits,cols", [
    (bits, cols) for bits in (2, 3, 4, 5, 6, 7) for cols in (32, 96, 128, 1024, 8192, 16384)
    if cols % ref.stream_geometry(bits)[0] == 0])
def test_unpack_dequant_kernel_bit_equal(cuda, bits, cols):
    """K4b at any whole number of stream groups a row, a NaN scale among them."""
    x = _x(21, cols, cuda, seed=bits * cols)
    words, scale = ref.quantize_pack_2d_ref(x, 4, bits=bits)
    scale[3] = float("nan")
    before = q.unpack_dequant_2d.launches
    out = q.unpack_dequant_2d(words, scale, bits=bits)
    torch.cuda.synchronize()
    assert q.unpack_dequant_2d.launches == before + 1
    assert ref.same_bits(out, ref.unpack_dequant_2d_ref(words, scale, bits=bits))


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("p", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("rows,cols", [(37, 128), (6, 384), (5, 8192)])
def test_sparse_unpack_scatter_kernel_bit_equal(cuda, mode, p, rows, cols):
    """K6b on K6's payloads, f32 and f16 values: bit-equal, and a row of
    -0.0 (whose values are kept) decodes to +0.0, as the one-hot sum does."""
    x = _edge_rows(_x(rows, cols, cuda, seed=cols + 3))
    x[4] = -0.0
    for value_dtype in (torch.float32, torch.float16):
        vals, idx = q.sparse_select_pack_2d(x, 0xFACE, p=p, mode=mode, value_dtype=value_dtype)
        before = q.sparse_unpack_scatter_2d.launches
        out = q.sparse_unpack_scatter_2d(vals, idx, cols=cols)
        torch.cuda.synchronize()
        assert q.sparse_unpack_scatter_2d.launches == before + 1
        assert ref.same_bits(out, ref.sparse_unpack_scatter_2d_ref(vals, idx, cols=cols))
        assert not torch.signbit(out[4]).any()


@pytest.mark.parametrize("spec", ["quant:8", "quant:8:32", "quant:4:32", "sparse:0.25"])
def test_wire_quant8_and_dense_decode_on_card_match_cpu(cuda, spec):
    """The 8-bit encode (K3 on the gate, plain at block 32) and the dense
    decodes (K4a, K4b, K6b) of a stacked ragged leaf on the card equal the
    CPU's; so does the base receive (decode, then axpy)."""
    from repro_torch.distributed.wire import make_wire_format

    wire = make_wire_format(spec)
    leaf = _x(8, 3000, cuda, seed=13).reshape(8, 1, 3000) * 0.01
    acc = _x(8, 3000, cuda, seed=14).reshape(8, 1, 3000)
    p_gpu = wire.encode(leaf, 91)
    p_cpu = wire.encode(leaf.cpu(), 91)
    for k in p_cpu:
        assert ref.same_bits(p_gpu[k].cpu(), p_cpu[k]), k
    assert ref.same_bits(wire.decode(p_gpu, leaf).cpu(), wire.decode(p_cpu, leaf.cpu()))
    a_cpu = acc.cpu()
    wire.decode_axpy_(p_gpu, acc, 2.0, -1.0)
    wire.decode_axpy_(p_cpu, a_cpu, 2.0, -1.0)
    assert ref.same_bits(acc.cpu(), a_cpu)


# ------------------------------------------------------------ model families

def _greedy_decode(model, cfg, params, prompt, frames, device, forced=None, steps=12):
    """Greedy decode from ``prompt`` (or fed ``forced`` tokens); returns the
    (B, steps, V) float logits and the (B, steps) argmax tokens on the CPU."""
    from repro_torch.models import encdec as ed

    caches = model.init_cache(prompt.shape[0], steps + 1, device=device)
    if frames is not None:
        caches = ed.encdec_prefill_cross(cfg, params, frames.to(device), caches)
    cur, logits = prompt.to(device), []
    for t in range(steps):
        lg, caches = model.decode_step(params, caches, cur)
        logits.append(lg[:, 0].float().cpu())
        cur = lg.argmax(-1) if forced is None else forced[:, t:t + 1].to(device)
    out = torch.stack(logits, 1)
    return out, out.argmax(-1)


@pytest.mark.parametrize("arch", ["internvl2-76b", "zamba2-7b", "deepseek-moe-16b",
                                  "whisper-base", "mistral-large-123b", "deepseek-v2-lite-16b",
                                  "codeqwen1.5-7b", "starcoder2-15b", "mamba2-370m",
                                  "granite-3-2b"])
def test_family_decode_on_card_matches_cpu(cuda, arch):
    """Each family at its reduced width, the same params and prompt: the card
    fed the CPU's greedy tokens gives the CPU's logits within 5e-2 (bf16,
    as the CPU tests hold the port to JAX), and the CPU's token wherever the
    CPU's top two logits are more than 0.1 apart."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    prompt = torch.randint(2, cfg.vocab, (2, 1), generator=gen)
    frames = torch.randn((2, cfg.frontend.n_tokens, cfg.frontend.dim), generator=gen) \
        if cfg.is_encdec else None
    lc, tc = _greedy_decode(model, cfg, params, prompt, frames, "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    lg, tg = _greedy_decode(model, cfg, card, prompt, frames, cuda, forced=tc)
    top2 = lc.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 0.1
    assert float((lg - lc).abs().max()) <= 5e-2
    assert torch.equal(tg[sure], tc[sure])


def test_chunked_prefill_on_card_matches_unchunked(cuda, monkeypatch):
    """Reduced granite at S 4096: the prefill through ``_sdpa_chunked`` and
    through the unchunked ``_sdpa`` agree within 5e-2 per 0.3 of the logits'
    std (bf16, ``chip_smoke.DECODE_REL``); ``_sdpa_chunked`` on the card
    equals the CPU's in float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.api import build_model

    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, attn.FLASH_THRESHOLD), device=cuda)
    with torch.no_grad():
        chunked = model.prefill(params, {"tokens": toks}).float()
        monkeypatch.setattr(attn, "FLASH_THRESHOLD", attn.FLASH_THRESHOLD + 1)
        plain = model.prefill(params, {"tokens": toks}).float()
    assert float((chunked - plain).abs().max()) <= 5e-2 / 0.3 * float(plain.std())
    g = torch.Generator()
    g.manual_seed(5)
    q, k, v = (torch.randn((2, 37, n, 8), generator=g) for n in (4, 2, 2))
    want = attn._sdpa_chunked(q, k, v, window=5, chunk=8)
    got = attn._sdpa_chunked(q.to(cuda), k.to(cuda), v.to(cuda), window=5, chunk=8).cpu()
    assert float((got - want).abs().max()) <= 1e-5


_OFFSET_KERNELS = {
    "K1": (q.quantize_pack_2d, ref.quantize_pack_2d_ref, dict(bits=4)),
    "K3": (q.quantize_2d, ref.quantize_2d_ref, dict(bits=8)),
    "K6-randk": (q.sparse_select_pack_2d, ref.sparse_select_pack_2d_ref,
                 dict(p=0.05, mode="randk")),
    "K6-randk-regs": (q.sparse_select_pack_2d, ref.sparse_select_pack_2d_ref,
                      dict(p=0.25, mode="randk")),
}


@pytest.mark.parametrize("kernel", list(_OFFSET_KERNELS))
@pytest.mark.parametrize("rows,cols", [(64, 128), (16, 1024), (8, 2048)])
@pytest.mark.parametrize("base", [0, 2**32 - 5 * 128 - 3])
def test_send_kernels_with_a_counter_offset(cuda, kernel, rows, cols, base):
    """K1, K3 and K6 random-k with an offset: equal to the plain version at
    that offset, and rows ``r0:`` at ``base + r0*cols`` equal to those rows
    of the whole fold at ``base`` (the second base wraps past 2^32)."""
    launch, plain, kw = _OFFSET_KERNELS[kernel]
    x = _x(rows, cols, cuda, seed=cols + base % 7)
    whole = launch(x, 0xC0FFEE, offset=base, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, plain(x, 0xC0FFEE, offset=base, **kw)))
    for r0 in (1, rows // 2):
        off = (base + r0 * cols) % 2**32
        part = launch(x[r0:].contiguous(), 0xC0FFEE, offset=off, **kw)
        assert all(torch.equal(a[r0:], b) for a, b in zip(whole, part)), r0


def test_rank_runtime_on_card_matches_stacked(cuda, tmp_path):
    """Two ranks share the card over gloo: DCD ``quant:4`` and CHOCO
    ``sparse:0.05:randk`` on tiny granite, the checkpoints equal the stacked
    runs' on the card bit for bit."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainConfig, run_training, spawn_training

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=1)
    runs = [dict(algo="dcd", wire="quant:4"), dict(algo="choco", wire="sparse:0.05:randk")]
    tcs = {mode: [TrainConfig(arch="granite-3-2b", n_nodes=2, seq_len=32, global_batch=4,
                              steps=2, log_every=1, ckpt_every=2,
                              ckpt_dir=str(tmp_path / f"{mode}{i}"), **r)
                  for i, r in enumerate(runs)] for mode in ("stacked", "ranks")}
    stacked = [run_training(cfg, tc, device="cuda") for tc in tcs["stacked"]]
    ranked = spawn_training(cfg, tcs["ranks"], "gloo", device="cuda", timeout_s=300)
    for s_tc, r_tc, s_h, r_h in zip(tcs["stacked"], tcs["ranks"], stacked, ranked):
        with np.load(f"{s_tc.ckpt_dir}/ckpt_{2:08d}.npz") as a, \
                np.load(f"{r_tc.ckpt_dir}/ckpt_{2:08d}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert all(h["losses"] == s_h["losses"] for h in r_h)


def _bf16_acc(rows, cols, device, seed=0):
    """A bf16 accumulator with a zero row, -0.0 entries and a NaN."""
    a = _x(rows, cols, device, seed=seed + 100).to(torch.bfloat16)
    a[min(2, rows - 1), 3] = float("nan")
    return a


def _bf16_case(fn, plain, acc, counter):
    """``fn(acc)`` (the bf16-accumulator kernel) and ``fn(acc, out=acc)``
    bit-equal to ``plain(acc)``, with one launch each on ``counter``."""
    before = counter.launches
    got = fn(acc)
    torch.cuda.synchronize()
    want = plain(acc)
    assert got.dtype == torch.bfloat16 and ref.same_bits(got, want)
    inplace = acc.clone()
    fn(inplace, out=inplace)
    torch.cuda.synchronize()
    assert ref.same_bits(inplace, want)
    assert counter.launches == before + 2


@pytest.mark.parametrize("rows,cols", [(64, 1024), (37, 256)])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (0.75, -0.5)])
def test_bf16_accumulator_kernels_bit_equal(cuda, rows, cols, acc_weight, weight):
    """K2, K5b, K6c and K7b with a bf16 accumulator against their plain
    versions (the f32 plain version on the widened accumulator, rounded to
    bf16), at a whole and a ragged fold; each counts under its own name."""
    x = _x(rows, cols, cuda, seed=cols)
    acc = _bf16_acc(rows, cols, cuda)
    kw = dict(weight=weight, acc_weight=acc_weight)
    words, scale = q.quantize_pack_2d(x, 7, bits=4)
    _bf16_case(lambda a, out=None: q.unpack_dequant_axpy_2d(words, scale, a, bits=4, out=out,
                                                            **kw),
               lambda a: ref.unpack_dequant_axpy_2d_ref(words, scale, a, bits=4, **kw),
               acc, q.UNPACK_DEQUANT_AXPY_2D_BF16)
    signs, sscale = q.sign_pack_2d(x)
    _bf16_case(lambda a, out=None: q.unpack_sign_axpy_2d(signs, sscale, a, out=out, **kw),
               lambda a: ref.unpack_sign_axpy_2d_ref(signs, sscale, a, **kw),
               acc, q.UNPACK_SIGN_AXPY_2D_BF16)
    vals, idx = q.sparse_select_pack_2d(x, 7, p=0.05, mode="topk")
    _bf16_case(lambda a, out=None: q.sparse_scatter_axpy_2d(vals, idx, a, out=out, **kw),
               lambda a: ref.sparse_scatter_axpy_2d_ref(vals, idx, a, **kw),
               acc, q.SPARSE_SCATTER_AXPY_2D_BF16)
    v = torch.rand((cols, 2), device=cuda) - 0.5
    p = lk.lowrank_project_2d(x, v)
    _bf16_case(lambda a, out=None: lk.lowrank_axpy_2d(p, v, a, out=out, **kw),
               lambda a: ref.lowrank_axpy_2d_ref(p, v, a, **kw),
               acc, lk.LOWRANK_AXPY_2D_BF16)
    with pytest.raises(TypeError):
        q.unpack_dequant_axpy_2d(words, scale, acc.half(), bits=4, weight=1.0)


def test_dryrun_smoke_on_card(cuda, capsys):
    """``dryrun_smoke`` executes its 2 steps on the card."""
    from repro_torch.launch.dryrun import dryrun_smoke
    rec = dryrun_smoke("granite-3-2b", device="cuda")
    out = capsys.readouterr().out
    assert "[SMOKE OK] " in out and rec["n_devices"] == 1 and rec["steps"] == 2
    assert torch.isfinite(torch.tensor(rec["loss"]))


def test_gossip_reference_on_card_matches_cpu(cuda):
    """``GossipReference`` DCD ``quant:4`` on a ring of 8 at drop 0.2, three
    steps on the card (K1 sends, K4b dense decodes) and on the CPU (their
    plain versions) from the same params and gradients: params, replicas
    and freshness within 1e-5, with one K1 and one K4b a leaf and step."""
    from repro_torch.core import GossipReference
    from repro_torch.distributed.gossip import make_gossip_plan

    n, shapes = 8, {"b": (1024,), "w": (4, 2048)}
    gen = torch.Generator().manual_seed(0)
    p0 = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    c = {k: torch.randn((n,) + s, generator=gen) for k, s in shapes.items()}
    ref = GossipReference(name="dcd", plan=make_gossip_plan("ring", n), wire="quant:4",
                          drop="0.2:4")
    states = {dev: ref.init({k: v.to(dev) for k, v in p0.items()}) for dev in ("cpu", cuda)}
    step = ref.step_fn()
    q.reset_launch_counts()
    for t in range(3):
        e = {k: 0.1 * torch.randn((n,) + s, generator=gen) for k, s in shapes.items()}
        for dev, st in states.items():
            g = {k: st.params[k] - c[k].to(dev) + e[k].to(dev) for k in shapes}
            step(st, g, None, 0.05)
    torch.cuda.synchronize()
    counts = {k: v for k, v in q.launch_counts().items() if v}
    assert counts == {"quantize_pack_2d": 6, "unpack_dequant_2d": 6}, counts
    cpu, card = states["cpu"], states[cuda]
    for a in ("params", *sorted(cpu.aux)):
        x, y = (cpu.params, card.params) if a == "params" else (cpu.aux[a], card.aux[a])
        for k in (shapes if isinstance(x, dict) else [None]):
            xa, ya = (x, y) if k is None else (x[k], y[k])
            torch.testing.assert_close(ya.cpu(), xa, rtol=0, atol=1e-5, msg=f"{a} {k}")


@pytest.mark.parametrize("case", sc.DEFAULT_GRID, ids=lambda c: "-".join(str(x) for x in c))
def test_analysis_sweep_on_card(cuda, case):
    """One step of each grid case on the card: ``ok`` (every wrapper's
    launches equal its calls, no f64, no host read of a card tensor, the
    whitelist), and the receive launches equal to the decode-site formula."""
    rep = sc.analyze_case(*case, device="cuda")
    assert rep.ok, rep.violations
    assert rep.host_reads == 0
    assert rep.launches == rep.kernel_calls == rep.expected_kernels
    assert (rep.expected_kernels > 0) == (case[2] is not None)


def test_no_wrapper_takes_its_plain_version_in_a_card_step(cuda):
    """A DCD ``quant:4`` step of the toy testbed on the card: each wrapper's
    calls equal its launches, K1 once a leaf, K2 on the two leaves on the
    lane gate and K4b on the 32-wide one, 3 decode sites each."""
    from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant

    step = make_dist_train_step(sc._toy_loss, "dcd", sgd(), "quant:4", 8, constant(0.05))
    state = init_dist_state("dcd", sc._toy_params(cuda), 8, sgd())
    calls, launches = q.call_counts(), q.launch_counts()
    step(state, sc._toy_batch(8, device=cuda))
    torch.cuda.synchronize()
    dc = {k: v - calls[k] for k, v in q.call_counts().items() if v != calls[k]}
    dl = {k: v - launches[k] for k, v in q.launch_counts().items() if v != launches[k]}
    assert dc == dl == {"quantize_pack_2d": 2, "unpack_dequant_axpy_2d": 6,
                        "unpack_dequant_2d": 3}, (dc, dl)


# ------------------------------------------------------------ the Markov walk

# (rows, vocab, length): both cells' batches, a rank's rows, one row, a vocab
# below the cluster size, one under a thread's candidate, slices of 512 and
# 513 candidates a CTA (one or two a thread), and vocabs no power of two divides
MARKOV_WALK_SHAPES = [(32, 49155, 256), (8, 50280, 1024), (4, 49155, 256), (1, 5000, 64),
                      (3, 7, 40), (8, 300, 48), (8, 8192, 48), (8, 8193, 48), (32, 2049, 48),
                      (6, 10007, 64)]
# (seed, step): past 2^31 and 2^32 as the benchmark's seeds are
MARKOV_SEED_STEPS = [(3_000_000_000 + 7919 * i + (i % 3) * 2 ** 33, 5 * i + i % 4)
                     for i in range(16)]


def _markov_keys(rows: int, seed: int, step: int, device) -> torch.Tensor:
    from repro_torch.data import DataConfig
    from repro_torch.data import pipeline

    nodes = math.gcd(rows, 8)
    cfg = DataConfig(vocab=2, seq_len=1, global_batch=rows, n_shards=nodes, seed=seed)
    return pipeline._row_keys(cfg, step, range(nodes), device)


@pytest.mark.parametrize("rows,vocab,length", MARKOV_WALK_SHAPES,
                         ids=lambda v: str(v))
def test_markov_walk_kernel_token_equal(cuda, rows, vocab, length):
    """The walk kernel's tokens against the eager walk on the card
    (``ref.markov_walk_ref``, what the data pipeline runs for a CPU key),
    token for token, at 16 (seed, step) pairs."""
    from repro_torch.kernels import markov as mk

    conc = 0.3 if vocab > 10007 else 0.7
    for seed, step in MARKOV_SEED_STEPS:
        key = _markov_keys(rows, seed, step, cuda)
        before = mk.markov_walk.launches
        got = mk.markov_walk(key, vocab=vocab, length=length, seed=seed, concentration=conc)
        want = ref.markov_walk_ref(key, vocab=vocab, length=length, seed=seed,
                                   concentration=conc)
        torch.cuda.synchronize()
        assert mk.markov_walk.launches == before + 1
        bad = (got != want).nonzero()
        assert bad.numel() == 0, (seed, step, bad.shape[0], bad[:4].tolist())


@pytest.mark.parametrize("rows,vocab,pos", [(32, 49155, 0), (32, 49155, 255), (8, 50280, 1023),
                                            (3, 7, 5), (5, 10007, 17)])
@pytest.mark.parametrize("conc", [0.3, 0.7])
def test_markov_scores_bit_equal(cuda, rows, vocab, pos, conc):
    """One position's scores from the walk kernel's device function equal
    the eager walk's ``logits + gumbel`` bit for bit: a rounding difference
    could hide behind an unchanged argmax."""
    from repro_torch.kernels import markov as mk

    cand = torch.arange(vocab, dtype=torch.int64, device=cuda)
    for seed, step in MARKOV_SEED_STEPS[:4]:
        key = _markov_keys(rows, seed, step, cuda)
        tok = ref.pcg_hash(key ^ 0x5EED) % vocab
        got = mk.markov_scores(key, tok, pos, vocab=vocab, seed=seed, concentration=conc)
        want = (ref.markov_logits_ref(tok, cand, seed=seed, concentration=conc)
                + ref.markov_gumbel_ref(key, pos, cand))
        torch.cuda.synchronize()
        assert ref.same_bits(got, want), (seed, step, (got != want).sum().item())


def test_markov_walk_launches_equal_calls_in_a_batch(cuda):
    """A stacked batch and a shard's batch each take the kernel once."""
    from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
    from repro_torch.kernels import markov as mk

    cfg = DataConfig(vocab=49155, seq_len=32, global_batch=32, n_shards=8, seed=2 ** 33 + 1)
    calls, launches = mk.markov_walk.calls, mk.markov_walk.launches
    stacked = stacked_node_batches(cfg, 4, device=cuda)
    one = sample_batch(cfg, 4, 3, device=cuda)
    torch.cuda.synchronize()
    assert mk.markov_walk.calls - calls == mk.markov_walk.launches - launches == 2
    assert torch.equal(one["tokens"], stacked["tokens"][3])
    assert torch.equal(stacked["labels"][..., :-1], stacked["tokens"][..., 1:])



# ------------------------------------------------------------ the AdamW update

ADAMW_KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
# 2-D and 3-D stacked leaves, whole vectors of 4 and not, and one whose
# threads take several trips of the grid-stride loop
ADAMW_SHAPES = [(8, 1000), (8, 1001), (4, 3, 256), (4, 3, 257), (8, (1 << 20) + 3)]


def _adamw_leaf(shape, dtype, device, seed):
    """(g, m, v, p): g holds NaN, +-inf, -0.0 and a subnormal, a few moments
    are fresh zeros."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.randn(shape, generator=gen, device=device).mul_(1e-2)
    g.view(-1)[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 1e-40])
    m = torch.randn(shape, generator=gen, device=device).mul_(1e-3)
    v = torch.rand(shape, generator=gen, device=device).mul_(1e-4)
    m.view(-1)[5:9], v.view(-1)[5:9] = 0.0, 0.0
    p = torch.randn(shape, generator=gen, device=device)
    return g.to(dtype), m, v, p.to(dtype)


@pytest.mark.parametrize("shape", ADAMW_SHAPES, ids=str)
@pytest.mark.parametrize("t", [1, 2, 300])
@pytest.mark.parametrize("lr", [0.0, 3e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_adamw_kernel_bit_equal(cuda, shape, t, lr, dtype):
    """The AdamW kernel's update, ``m`` and ``v`` against the plain version
    on the card (the eager body), bit for bit; at lr 0 the update's zeros
    keep the eager body's signs.  bf16 ``g`` and ``p`` meet f32 moments."""
    from repro_torch.kernels import adamw as ak

    g, m, v, p = _adamw_leaf(shape, dtype, cuda, seed=t + len(shape))
    mr, vr = m.clone(), v.clone()
    calls, launches = ak.adamw_update.calls, ak.adamw_update.launches
    got = ak.adamw_update(g, m, v, p, lr=lr, t=t, **ADAMW_KW)
    want = ref.adamw_update_ref(g, mr, vr, p, lr=lr, t=t, **ADAMW_KW)
    torch.cuda.synchronize()
    assert ak.adamw_update.calls - calls == ak.adamw_update.launches - launches == 1
    for name, a, b in (("update", got, want), ("m", m, mr), ("v", v, vr)):
        assert ref.same_bits(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("view", ["row1", "off1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_adamw_kernel_on_views_bit_equal(cuda, view, dtype):
    """Leaves that are contiguous views into larger buffers: one row in
    (aligned: the vector loop) and one element in (off the vectors'
    alignment: one element a trip)."""
    from repro_torch.kernels import adamw as ak

    g, m, v, p = _adamw_leaf((8, 1000), dtype, cuda, seed=5)
    gv, mv, vv, pv = (ref.offset_views(x)[view] for x in (g, m, v, p))
    got = ak.adamw_update(gv, mv, vv, pv, lr=3e-3, t=2, **ADAMW_KW)
    want = ref.adamw_update_ref(g, m, v, p, lr=3e-3, t=2, **ADAMW_KW)
    torch.cuda.synchronize()
    for name, a, b in (("update", got, want), ("m", mv, m), ("v", vv, v)):
        assert ref.same_bits(a, b), (name, view)


def test_adamw_launches_equal_calls_in_a_card_step(cuda):
    """Two steps of reduced granite, DCD ``quant:4`` through
    ``run_training`` on the card: AdamW takes its kernel once a leaf a
    step, every call a launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as ak
    from repro_torch.launch.train import TrainConfig, run_training
    from repro_torch.tree import tree_leaves

    cfg = get_config("granite-3-2b").reduced()
    tc = TrainConfig(algo="dcd", wire="quant:4", n_nodes=4, seq_len=16, global_batch=8,
                     steps=2, log_every=1)
    calls, launches = ak.adamw_update.calls, ak.adamw_update.launches
    hist = run_training(cfg, tc, device=cuda)
    torch.cuda.synchronize()
    leaves = len(tree_leaves(hist["state"].params))
    assert ak.adamw_update.calls - calls == ak.adamw_update.launches - launches == leaves * 2
    assert all(math.isfinite(x) for x in hist["losses"])


# ---------------------------------------------- the nodes' gradients

def _indexed_node_grads(loss_fn, params, batch):
    """``_node_grads`` with node ``i``'s slice taken as ``leaf[i]``: its
    backward zero-fills a tensor of the whole stacked leaf a node and adds
    them up."""
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_leaves(params)
    for l in leaves:
        l.requires_grad_(True)
    try:
        losses = torch.stack([loss_fn(tree_map(lambda l: l[i], params),
                                      {k: v[i] for k, v in batch.items()})[0]
                              for i in range(leaves[0].shape[0])])
        losses.sum().backward()
        grads = [l.grad for l in leaves]
    finally:
        for l in leaves:
            l.grad = None
            l.requires_grad_(False)
    return losses.detach(), grads


def test_node_grads_peak_memory_no_higher_than_indexing(cuda):
    """A stacked leaf of 1 GiB (8 nodes of 4,096 x 8,192 f32) beside a small
    one: ``_node_grads`` (one ``unbind`` a leaf) allocates at its peak no
    more than the per-node indexing version, and its losses and gradients
    are bit-equal to that version's."""
    from repro_torch.distributed.decentralized import _node_grads

    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    params = {"w": torch.randn((8, 4096, 8192), generator=gen, device=cuda).mul_(1e-2),
              "g": torch.randn((8, 8192), generator=gen, device=cuda)}
    assert params["w"].numel() * params["w"].element_size() >= 1 << 30
    batch = {"x": torch.randn((8, 64, 4096), generator=gen, device=cuda)}

    def loss_fn(p, b):
        return torch.tanh(b["x"] @ p["w"] * p["g"]).square().mean(), {}

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(loss_fn, params, batch)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    peak(_node_grads)                       # warm the kernels and cuBLAS's workspace
    got_peak, (losses, _, grads) = peak(_node_grads)
    want_peak, (want_losses, want_grads) = peak(_indexed_node_grads)
    assert got_peak <= want_peak, (got_peak, want_peak)
    assert torch.equal(losses, want_losses)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)


# ------------------------------------------- latent attention and dropless MoE

def test_mla_moe_step_on_card_reads_nothing_on_the_host(cuda, tmp_path):
    """One DCD ``quant:4`` step of the small DeepSeek-V2-Lite cell
    (``test_torch_mla_moe.SMALL``: latent norm, YaRN, 8 of 16 experts held,
    dropless) as the benchmark's harness builds it, under ``StepWatch``
    after a warm-up step: no host read of a card tensor and no float64, in
    the expert layer's grouped products or anywhere else in the step."""
    from bench import cells, harness
    from test_torch_mla_moe import SMALL_CELL, small_cell_root

    cell = cells.find(small_cell_root(tmp_path), SMALL_CELL)
    prog = harness.Program(cell, 2 ** 31 + 3, cuda)
    prog.step(prog.batch())
    batch = prog.batch()
    watch = sc.StepWatch(cuda)
    with watch:
        prog.state, met = prog.step_fn(prog.state, batch)
    torch.cuda.synchronize()
    assert watch.host_reads == [] and watch.f64_ops == []
    assert math.isfinite(float(met["loss"])) and float(met["moe_held_rows"]) > 0


# ------------------------------------- Nemotron-H: Mamba2, sigmoid relu^2 experts, NoPE

NEMOTRON_CELL = "nemotron-3-nano-l7e8.dcd-q4.ring4.s4096"


def test_nemotron_h_at_published_widths_matches_the_reference_on_card(cuda):
    """One node of the benchmark's Nemotron 3 Nano configuration (layers
    ``MEMEM*E`` at d_model 2688, 8 of 128 experts held, 16,384 ids) on two
    sequences of 512: the program's bf16 loss and gradient against the
    reference's (float32, TF32 off), the loss within 2e-3 and every leaf's
    gradient norm, by the harness's gap (``bench.compare``), within 3e-2
    (the cell's own limits are tighter: they hold three steps over four
    nodes of 4,096 positions, which average the rounding out).  The
    program's forward and backward under ``StepWatch``: no host read of a
    card tensor and no float64, the expert layers' grouped products
    included."""
    from repro_torch.models.api import build_model
    from repro_torch.tree import leaf_items

    from bench import cells, compare, harness, weights
    from bench.reference import model as ref

    cell = cells.find(pathlib.Path(__file__).resolve().parents[1], NEMOTRON_CELL)
    cfg = cell.config
    params = weights.make(cfg, 2 ** 31 + 5, cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    tokens, labels = (torch.randint(0, cfg["vocab"], (2, 512), generator=gen, device=cuda)
                      for _ in range(2))
    items = leaf_items(params)
    for _, leaf in items:
        leaf.requires_grad_(True)
    model = build_model(harness.arch_config(cell))
    model.loss(params, {"tokens": tokens, "labels": labels})[0].backward()   # warm up
    for _, leaf in items:
        leaf.grad = None
    watch = sc.StepWatch(cuda)
    with watch:
        loss, met = model.loss(params, {"tokens": tokens, "labels": labels})
        loss.backward()
    torch.cuda.synchronize()
    assert watch.host_reads == [] and watch.f64_ops == []
    assert float(met["moe_held_rows"]) > 0
    got = {p: float(leaf.grad.norm()) for p, leaf in items}
    for _, leaf in items:
        leaf.grad = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want_loss = ref.loss(cfg, params, tokens, labels)
    want_loss.backward()
    want = {p: float(leaf.grad.norm()) for p, leaf in items}
    gap = abs(float(loss) - float(want_loss)) / float(want_loss)
    gaps = compare.leaf_gaps(got, want)
    print(f"nemotron-h on card: loss gap {gap:.3e}, largest gradient gap "
          f"{max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
    assert gap <= 2e-3
    assert max(gaps.values()) <= 3e-2, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
