"""The data layer's Markov walk wrapper (``kernels/markov.py``) on the CPU.

A CPU key takes the plain version (``ref.markov_walk_ref``, the eager walk)
and counts a call without a launch, in the registry that reads and resets
every kernel's counts; the wrapper refuses a wrong dtype, device or shape.  The CUDA kernel (``kernels/csrc/markov.cu``) runs only on
the card (``tests/test_torch_cuda.py``); here numpy models replay its two
departures from the eager code: the hash in native uint32 arithmetic, and
the argmax split over a cluster's CTAs, threads and warps.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.data import pipeline
from repro_torch.kernels import markov as mk
from repro_torch.kernels import ref


def _keys(rows: int, seed: int = 3, step: int = 5) -> torch.Tensor:
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=rows, n_shards=1, seed=seed)
    return pipeline._row_keys(cfg, step, [0], "cpu")


def test_cpu_key_takes_the_plain_walk_and_counts_a_call():
    key = _keys(6)
    calls, launches = mk.markov_walk.calls, mk.markov_walk.launches
    walk = mk.markov_walk(key, vocab=101, length=9, seed=11, concentration=0.3)
    assert (mk.markov_walk.calls, mk.markov_walk.launches) == (calls + 1, launches)
    want = ref.markov_walk_ref(key, vocab=101, length=9, seed=11, concentration=0.3)
    assert walk.dtype == torch.int64 and walk.shape == (6, 10)
    assert torch.equal(walk, want)
    assert int(walk.min()) >= 0 and int(walk.max()) < 101


def test_walk_counts_are_read_and_reset_with_the_wire_kernels():
    """The walk is one of the registry's wrappers, so the step analyzer's
    check that calls equal launches on the card, and every reset, cover it."""
    from repro_torch.kernels import quant

    assert mk.markov_walk in quant.KERNEL_WRAPPERS
    calls = quant.call_counts()["markov_walk"]
    stacked_node_batches(DataConfig(vocab=31, seq_len=4, global_batch=4, n_shards=2, seed=1),
                         0, device="cpu")
    assert quant.call_counts()["markov_walk"] == calls + 1
    assert quant.launch_counts()["markov_walk"] == mk.markov_walk.launches
    quant.reset_call_counts()
    quant.reset_launch_counts()
    assert (mk.markov_walk.calls, mk.markov_walk.launches) == (0, 0)


@pytest.mark.parametrize("stacked", [True, False])
def test_batch_call_is_one_walk_call(stacked):
    cfg = DataConfig(vocab=53, seq_len=12, global_batch=8, n_shards=4, seed=9)
    calls, launches = mk.markov_walk.calls, mk.markov_walk.launches
    if stacked:
        stacked_node_batches(cfg, 2, device="cpu")
    else:
        sample_batch(cfg, 2, 1, device="cpu")
    assert (mk.markov_walk.calls, mk.markov_walk.launches) == (calls + 1, launches)


@pytest.mark.parametrize("bad,err", [
    (lambda k: k.to(torch.int32), TypeError),
    (lambda k: k.reshape(-1), ValueError),
    (lambda k: k.reshape(1, -1), ValueError),
    (lambda k: torch.cat([k, k], dim=1)[:, :1], ValueError),      # not contiguous
    (lambda k: k.to("meta"), ValueError),
])
def test_wrapper_refuses_bad_keys(bad, err):
    calls = mk.markov_walk.calls
    with pytest.raises(err):
        mk.markov_walk(bad(_keys(4)), vocab=50, length=3, seed=0, concentration=0.3)
    assert mk.markov_walk.calls == calls


@pytest.mark.parametrize("vocab,length,conc", [(0, 3, 0.3), (2 ** 31, 3, 0.3), (50, -1, 0.3),
                                                (50, 3, 0.0)])
def test_wrapper_refuses_bad_arguments(vocab, length, conc):
    with pytest.raises(ValueError):
        mk.markov_walk(_keys(2), vocab=vocab, length=length, seed=0, concentration=conc)


def test_scores_entry_refuses_a_cpu_key():
    key = _keys(2)
    with pytest.raises(ValueError):
        mk.markov_scores(key, key % 7, 0, vocab=7, seed=0, concentration=0.3)


@pytest.mark.parametrize("rows,sms,want", [
    (32, 132, 4),     # granite's cells: 128 CTAs
    (8, 132, 16),     # mamba's cells: 128 CTAs
    (4, 132, 16),     # a rank's rows (granite on 8 ranks)
    (1, 132, 16),
    (33, 132, 4),
    (34, 132, 2),
    (66, 132, 2),
    (67, 132, 1),
    (500, 132, 1),
    (8, 114, 8),
])
def test_cluster_size_follows_the_rows(rows, sms, want):
    assert mk.cluster_size(rows, sms) == want


@pytest.mark.parametrize("conc", [0.3, 0.7, 1.0, 1e-3])
def test_inv_concentration_is_the_f32_reciprocal(conc):
    inv = mk.inv_concentration(conc)
    assert inv == float(np.float32(1) / np.float32(conc))
    assert np.float32(inv) == inv


# ----------------------------------------------------------------- models

def _pcg_u32(x: np.ndarray) -> np.ndarray:
    """The kernel's ``pcg``: native uint32 wraparound."""
    x = x.astype(np.uint32)
    state = x * np.uint32(747796405) + np.uint32(2891336453)
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3, -5])
def test_kernel_hashes_in_uint32_equal_the_masked_int64_chain(seed):
    """``position_seed``/``token_seed`` and the three hashes a candidate,
    in uint32 as the kernel has them, against the eager walk's int64 chain."""
    key = _keys(5, seed=seed)
    cand = torch.arange(0, 3000, 7, dtype=torch.int64)
    tok = key % 3000
    pos = 77
    k32 = key.numpy().astype(np.uint32)
    c32 = cand.numpy().astype(np.uint32)
    seed_word = np.uint32(seed & ref.MASK32)
    with np.errstate(over="ignore"):
        a = _pcg_u32(_pcg_u32(_pcg_u32(k32) ^ np.uint32(pos)))
        b = _pcg_u32(_pcg_u32(_pcg_u32(seed_word + np.uint32(ref.MARKOV_SALT))
                              ^ tok.numpy().astype(np.uint32)))
        noise_h = _pcg_u32(a ^ c32)
        h = _pcg_u32(b ^ c32)
        h2 = _pcg_u32(h ^ np.uint32(0x9E3779B9))
        first = _pcg_u32(k32) % np.uint32(3000)
    assert np.array_equal(noise_h, ref.mix_hash(ref.mix_hash(key, pos), cand).numpy())
    full = torch.full_like(tok, (seed + ref.MARKOV_SALT) & ref.MASK32)
    want_h = ref.mix_hash(ref.mix_hash(full, tok), cand)
    assert np.array_equal(h, want_h.numpy())
    assert np.array_equal(h2, ref.pcg_hash(want_h ^ 0x9E3779B9).numpy())
    assert np.array_equal(first, (ref.pcg_hash(key) % 3000).numpy())


def _cluster_argmax(scores: np.ndarray, cluster: int, threads: int) -> int:
    """The kernel's argmax of one row at one position: CTA k scans its
    contiguous slice, thread t every ``threads``-th candidate from t keeping
    strictly larger scores; (score, index) pairs reduce lexicographically
    over lanes, warps and the cluster's slots (empty slices offer -inf at
    INT_MAX)."""
    vocab = scores.shape[0]
    span = -(-vocab // cluster)
    sentinel = (-np.inf, np.iinfo(np.int32).max)

    def best(pairs):
        return max(pairs, key=lambda p: (p[0], -p[1]))

    slots = []
    for k in range(cluster):
        lo = min(k * span, vocab)
        hi = min(lo + span, vocab)
        per_thread = []
        for t in range(threads):
            bs, bi = sentinel
            for c in range(lo + t, hi, threads):
                if scores[c] > bs:
                    bs, bi = scores[c], c
            per_thread.append((bs, bi))
        warps = [best(per_thread[w:w + 32]) for w in range(0, threads, 32)]
        slots.append(best(warps))
    return best(slots)[1]


@pytest.mark.parametrize("vocab,cluster", [(7, 16), (8191, 16), (8193, 16), (8192, 16),
                                           (1000, 4), (4099, 1), (1, 16)])
def test_cluster_argmax_keeps_the_first_of_equal_maxima(vocab, cluster):
    rng = np.random.default_rng(vocab * 31 + cluster)
    threads = 64                 # the model at a smaller CTA; the scheme is the same
    for trial in range(6):
        scores = rng.integers(-3, 3, vocab).astype(np.float32)   # many ties
        if trial % 2:
            scores[rng.integers(0, vocab, 3)] = np.inf           # a uniform of 1.0
        assert _cluster_argmax(scores, cluster, threads) == int(np.argmax(scores))
    assert _cluster_argmax(np.zeros(vocab, np.float32), cluster, threads) == 0
