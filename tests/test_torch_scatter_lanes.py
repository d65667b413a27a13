"""A numpy model of K6c's rows path (``kernels/csrc/sparse.cu``), on the CPU.

The CUDA kernel runs only on the card; this model replays its scheme at the
wire's block (128 columns, one index group, k <= 8), so that its decode,
slot and lane logic is checked where there is none:

- sixteen threads share a row, thread t owning columns 8t..8t+7; a warp's
  step holds rows r0 + 2u + h (u < 8 rows in flight, h the half-warp), and
  a row past the last is computed on the last row and not stored;
- each thread reads the row's first index word, and the second when k > 4, and
  decodes entry e from stream bit 7e (a funnel shift of the two words below
  bit 32, the second word alone past it);
- an entry whose index falls in the thread's span sets that column's 4-bit
  slot to e + 1 (a later entry overwrites, as a duplicate would);
- thread e < k of the row holds ``w * value[e]``; each column fetches it by
  shuffle from lane ``16h + slot - 1``, and a column with no slot adds
  +0.0.

The model's outputs are held bit for bit (signed zeros included) against
``ref.sparse_scatter_axpy_2d_ref`` on K6's own payloads (the plain version's,
numpy-seeded rows with the selection edges), and against the JAX package's
Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro_torch.kernels import ref as tref

COLS, THREADS, SPAN, IN_FLIGHT = 128, 16, 8, 8
WEIGHTS = [(1.0, 1.0), (0.75, -0.5), (1.0, -1.0)]      # (acc_weight, weight)


def decode_entry(w0: np.ndarray, w1: np.ndarray, e: int) -> np.ndarray:
    """Entry e's 7-bit index from the row's first two words (uint64 arrays
    holding uint32 values), as the kernel's funnel shift or plain shift."""
    shift = 7 * e
    if shift < 32:
        u = (w0 >> np.uint64(shift)) | (w1 << np.uint64(32 - shift))
    else:
        u = w1 >> np.uint64(shift - 32)
    return (u & np.uint64(0x7F)).astype(np.int64)


def rows_path_model(vals: torch.Tensor, words: torch.Tensor, acc: torch.Tensor, *,
                    weight, acc_weight) -> torch.Tensor:
    """K6c's rows path: (rows, k) values, (rows, words) int32 index words and
    a (rows, 128) f32 or bf16 accumulator -> the kernel's output."""
    rows, k = vals.shape
    assert acc.shape == (rows, COLS) and 1 <= k <= 8
    aw, w = np.float32(tref.f32_scalar(acc_weight)), np.float32(tref.f32_scalar(weight))
    u = words.numpy().view(np.uint32).astype(np.uint64)
    w0 = u[:, 0]
    w1 = u[:, 1] if k > 4 else np.zeros_like(w0)
    a = acc.float().numpy()
    wv = np.zeros((rows, THREADS), np.float32)           # thread t's w * value[t]
    wv[:, :k] = w * vals.float().numpy()
    out = np.empty((rows, COLS), np.float32)
    lanes = np.arange(rows)
    for t in range(THREADS):
        slots = np.zeros(rows, np.int64)                  # nibble c: entry + 1
        for e in range(k):
            c = decode_entry(w0, w1, e) - SPAN * t
            hit = (c >= 0) & (c < SPAN)
            sh = 4 * np.where(hit, c, 0)
            slots = np.where(hit, (slots & ~(0xF << sh)) | ((e + 1) << sh), slots)
        for c in range(SPAN):
            nib = (slots >> (4 * c)) & 0xF
            src = np.where(nib > 0, nib - 1, t)           # the lane the shuffle reads
            d = np.where(nib > 0, wv[lanes, src], np.float32(0.0))
            out[:, SPAN * t + c] = aw * a[:, SPAN * t + c] + d
    return torch.from_numpy(out).to(acc.dtype)


def stored_rows(rows: int, grid_warps: int) -> np.ndarray:
    """How often the rows path's persistent loop stores each row, for
    ``grid_warps`` warps in all; asserts every row it loads exists."""
    steps = -(-rows // (2 * IN_FLIGHT))
    count = np.zeros(rows, np.int64)
    for warp in range(grid_warps):
        for g in range(warp, steps, grid_warps):
            for u in range(IN_FLIGHT):
                for h in (0, 1):
                    row = g * 2 * IN_FLIGHT + 2 * u + h
                    assert 0 <= min(row, rows - 1) < rows
                    if row < rows:
                        count[row] += 1
    return count


def _payload(k: int, mode: str, value_dtype, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((40, COLS)) * 0.02).astype(np.float32)
    x[0] = 0.0
    x[1, :9] = -0.0
    tref.sparse_selection_edge_rows(x, 2)
    x[7] = 0.75
    x[7, 1::2] = -0.75
    vals, words = tref.sparse_select_pack_2d_ref(torch.from_numpy(x), 0xC0DE, p=k / COLS,
                                                 mode=mode, value_dtype=value_dtype)
    assert vals.shape[1] == k and words.shape[1] == 7
    acc = torch.from_numpy(rng.standard_normal((40, COLS)).astype(np.float32))
    acc[0] = -0.0
    acc[3, 5] = float("nan")
    return vals, words, acc


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("k", range(1, 9))
def test_rows_path_matches_plain_version(k, mode, value_dtype):
    vals, words, acc = _payload(k, mode, value_dtype, seed=k)
    for acc_dtype in (torch.float32, torch.bfloat16):
        a = acc.to(acc_dtype)
        for aw, w in WEIGHTS:
            got = rows_path_model(vals, words, a, weight=w, acc_weight=aw)
            want = tref.sparse_scatter_axpy_2d_ref(vals, words, a, weight=w, acc_weight=aw)
            assert tref.same_bits(got, want), (acc_dtype, aw, w)


@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (1.0, -1.0), (0.5, 1.0 / 3.0)])
def test_rows_path_matches_pallas_kernel(acc_weight, weight):
    """At the wire's p 0.05 (k 7): the model against the JAX kernel in
    interpret mode on the same payload (equal up to the sign of a zero, as
    the plain versions are).  Its acc weights are powers of two, as in
    ``test_torch_codecs.py``: XLA on the CPU contracts ``aw*acc + d`` into
    an FMA, which rounds once where the kernels round twice."""
    vals, words, acc = _payload(7, "topk", torch.float32, seed=70)
    got = rows_path_model(vals, words, acc, weight=weight, acc_weight=acc_weight)
    jo = jq.sparse_scatter_axpy_2d(jnp.asarray(vals.numpy()),
                                   jnp.asarray(words.numpy().view(np.uint32)),
                                   jnp.asarray(acc.numpy()), weight=weight,
                                   acc_weight=acc_weight, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jo))


def test_rows_path_lets_a_later_duplicate_win():
    """A constructed row whose two entries name one column (K6 never sends
    one): the later entry's value lands there, each other entry at its own
    column.  (The 7-bit indices of 128 columns cannot name a column past
    the row; the slot-map path's drop is checked on the card.)"""
    idx = torch.tensor([[5, 127, 64, 5]])
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    words = tref.sparse_pack_idx(idx, block=COLS, kpad=32)
    for acc_dtype in (torch.float32, torch.bfloat16):
        acc = torch.zeros((1, COLS), dtype=acc_dtype)
        got = rows_path_model(vals, words, acc, weight=1.0, acc_weight=1.0)
        assert got[0, 5] == 4.0 and got[0, 127] == 2.0 and got[0, 64] == 3.0
        assert int((got != 0).sum()) == 3


@pytest.mark.parametrize("rows", [1, 2, 7, 8, 9, 15, 17, 1000, 20003])
@pytest.mark.parametrize("grid_warps", [1, 3, 8 * 132])
def test_rows_path_stores_every_row_once(rows, grid_warps):
    assert (stored_rows(rows, grid_warps) == 1).all()
