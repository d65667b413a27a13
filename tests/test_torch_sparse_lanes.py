"""Numpy models of K6's two selection schemes (``kernels/csrc/sparse.cu``), on the CPU.

The CUDA kernel runs only on the card; these models replay its schemes step
by step, so that their tie and sentinel logic is checked where there is none.

The rounds (k > 8 at 128 columns, and every other width):

- the lanes of a row own contiguous spans, lane l the columns [l*C, (l+1)*C)
  (16 lanes of 8 columns at 128 columns, else 32 lanes of cols/32);
- each lane orders its span once by the kernel's odd-even transposition
  (neighbours swap on a strictly larger key only);
- a round takes the maximum over the live heads (a used-up lane offers 0 and
  does not vote), and the lowest lane holding it wins and advances its head;
- rounds go in chunks of one round a lane: lane t keeps round t's ballot and
  fetches entry t from the winner, at the span position given by the
  winner's wins before the chunk and in the chunk before round t;
- each entry's column is OR-ed into the row's index words.

The thread-a-row path (128 columns, k <= 8):

- keys one above the plain version's for topk, so that 0 is an empty slot;
- the bound lo: the smallest of the k largest maxima of 16 groups of 8;
- the candidates, key >= lo; past 32 of them, those above lo and only the
  first ties at lo the row needs;
- the candidates in ascending column into a sorted list of 8, where only a
  strictly larger key moves ahead.

Their entries and words are held against ``ref.sparse_select_pack_2d_ref`` (the
canonical order: key descending, ties to the smaller column) over
hypothesis-drawn rows with the selection edges, and on a few rows against the
JAX package's Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import quant as jq
from repro_torch.kernels import ref as tref

SEED = 0xBEEF
EDGE_KINDS = ("all_nan", "nan_many", "inf", "tie_boundary", "tie_long")
ROW_KINDS = ("normal", *EDGE_KINDS, "zeros", "few_values")


def lanes_of(cols: int) -> int:
    return 16 if cols == 128 else 32


def make_row(kind: str, cols: int, seed: int) -> np.ndarray:
    """One f32 row at a selection edge (``kind``), from a numpy seed; the
    edges of ``EDGE_KINDS`` are the card tests' (``sparse_selection_edge_rows``)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((len(EDGE_KINDS), cols)) * 0.02).astype(np.float32)
    if kind in EDGE_KINDS:
        return tref.sparse_selection_edge_rows(x, 0)[EDGE_KINDS.index(kind)]
    x = x[0]
    if kind == "zeros":
        x[:] = 0.0
        x[rng.random(cols) < 0.5] = -0.0
    elif kind == "few_values":
        x = rng.choice(np.float32([-1.0, -0.5, -0.0, 0.0, 0.5, 1.0]), cols)
    return x


def lane_order(keys: list) -> list:
    """Span positions in the kernel's order: odd-even transposition that swaps
    neighbours on a strictly larger key only."""
    key, at = list(keys), list(range(len(keys)))
    for ph in range(len(key)):
        for j in range(ph & 1, len(key) - 1, 2):
            if key[j + 1] > key[j]:
                key[j], key[j + 1] = key[j + 1], key[j]
                at[j], at[j + 1] = at[j + 1], at[j]
    return at


def model_select(keys: np.ndarray, k: int) -> list:
    """The row's k columns in the order the kernel's rounds emit them."""
    cols = keys.size
    lanes = lanes_of(cols)
    span = cols // lanes
    order = [[l * span + a for a in lane_order([int(keys[l * span + j]) for j in range(span)])]
             for l in range(lanes)]
    taken, entries = [0] * lanes, []
    for r0 in range(0, k, lanes):
        n = min(lanes, k - r0)
        before, won, tops_of = list(taken), [0] * lanes, []
        for t in range(n):
            live = [taken[l] < span for l in range(lanes)]
            heads = [int(keys[order[l][taken[l]]]) if live[l] else 0 for l in range(lanes)]
            m = max(heads)
            tops = [l for l in range(lanes) if live[l] and heads[l] == m]
            tops_of.append(tops)
            won[tops[0]] |= 1 << t
            taken[tops[0]] += 1
        for t in range(n):                    # lane t fetches entry r0 + t
            owner = tops_of[t][0]
            pos = before[owner] + bin(won[owner] & ((1 << t) - 1)).count("1")
            entries.append(order[owner][pos])
    return entries


def model_select_row(keys: np.ndarray, k: int, mode: str) -> list:
    """The row's k columns in the order the thread-a-row path emits them
    (128 columns, k <= 8)."""
    key = [int(v) + (mode == "topk") for v in keys]    # 0: an empty slot
    top = sorted((max(key[8 * g:8 * g + 8]) for g in range(16)), reverse=True)
    lo = min(top[:k])
    cand = [c for c in range(128) if key[c] >= lo]
    if len(cand) > 32:
        above = [c for c in cand if key[c] > lo]
        ties = [c for c in cand if key[c] == lo][:max(k - len(above), 0)]
        cand = sorted(above + ties)
    lk, lc = [0] * 8, [0] * 8
    for c in cand:
        i = next((i for i in range(8) if key[c] > lk[i]), 8)
        if i < 8:
            lk[i:], lc[i:] = [key[c]] + lk[i:7], [c] + lc[i:7]
    return lc[:k]


def model_words(entries: list, cols: int, p: float) -> np.ndarray:
    """The row's index words as the kernel ORs them: entry e in group e % G at
    stream position e // G, a field that crosses a word spilling into the
    group's next word."""
    k, bits, kpad, n_words = tref.sparse_geometry(cols, p)
    cpg, _ = tref.stream_geometry(bits)
    groups = kpad // cpg
    words = [0] * n_words
    for e, col in enumerate(entries):
        j, g = divmod(e, groups)
        bit = j * bits
        w, off = (bit >> 5) * groups + g, bit & 31
        words[w] |= (col << off) & 0xFFFFFFFF
        if off + bits > 32:
            words[w + groups] |= col >> (32 - off)
    return np.array(words, dtype=np.uint32)


def keys_of(x: np.ndarray, mode: str, row0: int = 0) -> np.ndarray:
    return tref.sparse_keys_2d(torch.from_numpy(x), SEED, mode=mode, row0=row0).numpy()


@pytest.mark.parametrize("p", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("cols", [128, 384, 1024])
@settings(max_examples=20, deadline=None)
@given(kind=st.sampled_from(ROW_KINDS), seed=st.integers(0, 2**31 - 1),
       mode=st.sampled_from(["topk", "randk"]), row=st.integers(0, 5000))
def test_lane_rounds_match_canonical_order(cols, p, kind, seed, mode, row):
    x = make_row(kind, cols, seed)[None, :]
    k, _, kpad, _ = tref.sparse_geometry(cols, p)
    entries = model_select(keys_of(x, mode, row0=row)[0], k)
    want = tref.sparse_order_2d_ref(torch.from_numpy(x), SEED, mode=mode, row0=row)[0, :k]
    assert entries == want.tolist()
    packed = tref.sparse_pack_idx(want[None, :], block=cols, kpad=kpad)[0].numpy()
    np.testing.assert_array_equal(model_words(entries, cols, p), packed.view(np.uint32))


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("cols,p", [(128, 0.05), (128, 0.25), (128, 1.0), (384, 0.05)])
def test_lane_rounds_match_pallas_kernel(cols, p, mode):
    """Edge rows of one fold: the model's entries, values and words against
    the JAX package's K6 in interpret mode (which sums each kept value into
    zeros, so values compare as numbers)."""
    x = np.stack([make_row(kind, cols, 7 + i) for i, kind in enumerate(ROW_KINDS)])
    k = tref.sparse_geometry(cols, p)[0]
    jv, jw = jq.sparse_select_pack_2d(jnp.asarray(x), jnp.asarray([SEED], jnp.uint32), p=p,
                                      mode=mode, interpret=True)
    jv, jw = np.asarray(jv), np.asarray(jw)
    keys = keys_of(x, mode)
    scale = np.float32(tref.f32_scalar(cols / k))
    for r in range(x.shape[0]):
        entries = model_select(keys[r], k)
        np.testing.assert_array_equal(model_words(entries, cols, p), jw[r])
        vals = x[r, entries] * scale if mode == "randk" else x[r, entries]
        np.testing.assert_array_equal(vals, jv[r])    # NaN matches NaN, -0.0 matches +0.0


@pytest.mark.parametrize("p", [1 / 128, 0.05, 8 / 128])
@settings(max_examples=40, deadline=None)
@given(kind=st.sampled_from(ROW_KINDS), seed=st.integers(0, 2**31 - 1),
       mode=st.sampled_from(["topk", "randk"]), row=st.integers(0, 5000))
def test_row_path_matches_canonical_order(p, kind, seed, mode, row):
    x = make_row(kind, 128, seed)[None, :]
    k = tref.sparse_geometry(128, p)[0]
    entries = model_select_row(keys_of(x, mode, row0=row)[0], k, mode)
    want = tref.sparse_order_2d_ref(torch.from_numpy(x), SEED, mode=mode, row0=row)[0, :k]
    assert entries == want.tolist()


@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_row_path_matches_pallas_kernel(mode):
    """The thread-a-row model's entries and words on the edge rows, against
    the JAX package's K6 in interpret mode at 128 columns and p 0.05."""
    x = np.stack([make_row(kind, 128, 11 + i) for i, kind in enumerate(ROW_KINDS)])
    k = tref.sparse_geometry(128, 0.05)[0]
    jv, jw = jq.sparse_select_pack_2d(jnp.asarray(x), jnp.asarray([SEED], jnp.uint32), p=0.05,
                                      mode=mode, interpret=True)
    jv, jw = np.asarray(jv), np.asarray(jw)
    keys = keys_of(x, mode)
    scale = np.float32(tref.f32_scalar(128 / k))
    for r in range(x.shape[0]):
        entries = model_select_row(keys[r], k, mode)
        np.testing.assert_array_equal(model_words(entries, 128, 0.05), jw[r])
        vals = x[r, entries] * scale if mode == "randk" else x[r, entries]
        np.testing.assert_array_equal(vals, jv[r])
