"""The rank-per-node runtime on the CPU: one process a gossip node over gloo.

Each run spawns ``n`` ranks (``spawn_training``, a ``file://`` rendezvous in
a fresh temporary directory, one thread a rank) that run every case of
:data:`CASES` in turn, each writing its final state through the rank-0
gather; the same cases run stacked in this process.  At n 4 and n 8 the
rank runtime must be bit-equal to the stacked mode after 2 steps: every
leaf of the checkpoint (params, replicas, estimates, hats, residuals, the
optimizer moments, lowrank-warm factors, freshness) and every per-step
loss.  C-PSGD's node mean is an all-reduce: its params agree with the
stacked mean to ``CPSGD_ATOL`` and its replicas are identical.

Held against JAX itself: the containers a rank sends for ``quant:4``,
``quant:8`` and ``sparse:...:randk`` are rows ``i`` of the JAX wire's encode
of the whole stacked leaf, and the plain K1, K3 and K6 random-k with a
counter offset are the matching rows of a whole-fold encode (also past
2^32).  The whitelist, resume and failure paths are below.

The model is granite-3-2b's reduced config cut further (one layer, width
64, vocabulary 128), so that a case takes well under a second.
"""
import concurrent.futures
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.distributed import wire as jw
from repro.optim import make_optimizer as jmake
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.distributed import wire as tw
from repro_torch.distributed.failures import edge_drop_mask, make_drop_spec
from repro_torch.distributed.gossip import make_gossip_plan
from repro_torch.distributed.transport import RankTransport, wire_refused_shapes
from repro_torch.kernels import ref
from repro_torch.launch.mesh import NodeGroup, init_node_group
from repro_torch.launch.train import TrainConfig, run_training, spawn_training
from repro_torch.models.api import build_model
from repro_torch.tree import leaf_items
from test_torch_families import one_torch_thread  # noqa: F401

TINY = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=1, d_model=64,
                           n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab=128)
ADAPTIVE = "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"
STEPS = 2
TIMEOUT_S = 120
# the cases held bit-equal to the stacked mode: TrainConfig fields
CASES = {
    "dcd-quant4": dict(algo="dcd", wire="quant:4"),
    "dcd-quant8": dict(algo="dcd", wire="quant:8"),
    "ecd-quant4": dict(algo="ecd", wire="quant:4"),
    "choco-sign": dict(algo="choco", wire="sign"),
    "choco-randk": dict(algo="choco", wire="sparse:0.05:randk"),
    "deepsqueeze-topk": dict(algo="deepsqueeze", wire="sparse:0.05:topk"),
    "dcd-lowrank-warm": dict(algo="dcd", wire="lowrank:2:warm"),
    "choco-adaptive": dict(algo="choco", wire=ADAPTIVE),
    "naive-chain-drops": dict(algo="naive", wire="quant:4", topology="chain", drop_rate=0.1),
    "dpsgd-chain-drops": dict(algo="dpsgd", topology="chain", drop_rate=0.1),
    "dcd-exp": dict(algo="dcd", wire="quant:4", topology="exp"),
    "dcd-full_logn": dict(algo="dcd", wire="quant:4", topology="full_logn"),
    "dcd-full_logn-drops": dict(algo="dcd", wire="quant:8", topology="full_logn", drop_rate=0.1),
    "dcd-phase-plan": dict(algo="dcd", phase_plan="0@ring@quant:8;1@full_logn@quant:4"),
}
# C-PSGD's all-reduce sums in another order than the stacked mean: its
# params stay within this of the stacked run's after 2 AdamW steps
CPSGD_ATOL = 1e-6
RUNS = {**CASES, "cpsgd": dict(algo="cpsgd")}


def _tc(n: int, name: str, root, ckpt_every: int = STEPS) -> TrainConfig:
    """Run ``name`` of ``RUNS`` (``through``: the resume test's DCD
    ``quant:4`` run-through) at ``n`` nodes, checkpointed under ``root``."""
    fields = CASES["dcd-quant4"] if name == "through" else RUNS[name]
    return TrainConfig(arch="granite-3-2b", n_nodes=n, seq_len=8, global_batch=n,
                       steps=STEPS, log_every=1, ckpt_every=ckpt_every,
                       ckpt_dir=str(root / name), **fields)


def _ckpt(tc: TrainConfig, step: int = STEPS) -> dict:
    with np.load(f"{tc.ckpt_dir}/ckpt_{step:08d}.npz") as f:
        return {k: f[k] for k in f.files}


def _rank_runs(n: int, root) -> dict:
    """Every run of ``RUNS`` on ``n`` spawned ranks; at n 4 also the
    resume test's run-through (a checkpoint every step) and, from its step-1
    checkpoint, the resumed run."""
    names = list(RUNS) + (["through"] if n == 4 else [])
    tcs = [_tc(n, name, root, ckpt_every=1 if name == "through" else STEPS) for name in names]
    out = {name: (tc, h) for name, tc, h in zip(
        names, tcs, spawn_training(TINY, tcs, "gloo", device="cpu", timeout_s=TIMEOUT_S))}
    if n == 4:
        tc = dataclasses.replace(out["through"][0], ckpt_dir=str(root / "resumed"))
        os.makedirs(tc.ckpt_dir)
        for suffix in (".npz", ".npz.json"):
            shutil.copy(f"{out['through'][0].ckpt_dir}/ckpt_{1:08d}{suffix}", tc.ckpt_dir)
        out["resumed"] = (tc, spawn_training(TINY, [tc], "gloo", device="cpu",
                                             timeout_s=TIMEOUT_S)[0])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{n: {name: {"ranks": (tc, every rank's history), "stacked": (tc,
    history)}}}`` at n 4 and n 8; the two rank groups run side by side (their
    ranks mostly wait on each other) while the stacked runs go here."""
    torch.set_num_threads(1)
    roots = {n: tmp_path_factory.mktemp(f"ranks{n}") for n in (4, 8)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranked = {n: pool.submit(_rank_runs, n, roots[n] / "ranks") for n in (4, 8)}
        stacked = {n: {name: run_training(TINY, tc, device="cpu") for name, tc in
                       ((name, _tc(n, name, roots[n] / "stacked")) for name in RUNS)}
                   for n in (4, 8)}
        out = {}
        for n in (4, 8):
            out[n] = {name: {"ranks": r} for name, r in ranked[n].result().items()}
            for name, h in stacked[n].items():
                out[n][name]["stacked"] = (_tc(n, name, roots[n] / "stacked"), h)
    return out


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_rank_runtime_bit_equal_to_stacked(runs, name, n):
    (stc, shist), (rtc, rhists) = runs[n][name]["stacked"], runs[n][name]["ranks"]
    want, got = _ckpt(stc), _ckpt(rtc)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for h in rhists:                 # every rank reports every node's losses
        assert h["losses"] == shist["losses"]
        np.testing.assert_allclose(h["consensus"], shist["consensus"], rtol=1e-4, atol=1e-6)
    assert any(k.startswith(".aux/") for k in want) or RUNS[name]["algo"] in ("naive", "dpsgd")


@pytest.mark.parametrize("n", [4, 8])
def test_drop_cases_drop_edges(n):
    """The drop cases above do lose edges in their 2 steps."""
    for name in ("naive-chain-drops", "dpsgd-chain-drops", "dcd-full_logn-drops"):
        f = RUNS[name]
        sched = make_gossip_plan(f["topology"], n)
        rounds = getattr(sched, "rounds", (sched,))
        drop = make_drop_spec(f["drop_rate"])
        lost = sum(float((1 - edge_drop_mask(n, s, t * len(rounds) + r, drop)).sum())
                   for t in range(STEPS) for r, rnd in enumerate(rounds) for s in rnd.shift_list)
        assert lost > 0, name


@pytest.mark.parametrize("n", [4, 8])
def test_cpsgd_all_reduce_within_tolerance(runs, n):
    (stc, shist), (rtc, rhists) = runs[n]["cpsgd"]["stacked"], runs[n]["cpsgd"]["ranks"]
    want, got = _ckpt(stc), _ckpt(rtc)
    params = [k for k in want if k.startswith(".params/")]
    worst = max(np.abs(got[k] - want[k]).max() for k in params)
    assert worst <= CPSGD_ATOL, worst
    for k in params:                 # the replicas stay exactly identical
        assert all(np.array_equal(got[k][i], got[k][0]) for i in range(n)), k
    for h in rhists:
        assert h["consensus"] == [0.0] * STEPS
        assert h["transport"]["sent"]["allreduce"] > 0
        np.testing.assert_allclose(h["losses"], shist["losses"], rtol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", ["dcd-quant4", "dcd-quant8", "choco-randk", "choco-adaptive",
                                  "dcd-lowrank-warm"])
def test_wire_runs_send_only_wire_containers(runs, name, n):
    """JAX's whitelist, on what each rank sent: no dense leaf on the wire
    label (the exchange raises on one, so the run finishing shows it), no
    D-PSGD traffic, and every non-float32 container dtype of the wire sent."""
    rtc, rhists = runs[n][name]["ranks"]
    wire = tw.make_wire_format(rtc.wire)
    want = set()
    for path, p in leaf_items(build_model(TINY).init(0, device="cpu")):
        shape = (1,) + tuple(p.shape)           # a rank's leaf
        payload = wire.route(path, shape).encode(torch.empty(shape, device="meta"), 0)
        want |= {str(t.dtype).removeprefix("torch.") for t in payload.values()}
    want.discard("float32")
    for h in rhists:
        sent = h["transport"]["sent"]
        assert sent["wire"] > 0 and "dense" not in sent and "allreduce" not in sent
        assert want <= set(h["transport"]["dtypes"]["wire"]), (want, h["transport"]["dtypes"])


@pytest.mark.parametrize("n", [4, 8])
def test_dpsgd_sends_dense_traffic_labelled(runs, n):
    _, rhists = runs[n]["dpsgd-chain-drops"]["ranks"]
    for h in rhists:
        assert h["transport"]["sent"]["dense"] > 0 and "wire" not in h["transport"]["sent"]


def test_transport_refuses_a_dense_leaf():
    """A wire exchange handed a float32 tensor of a param leaf's shape
    raises; the identity wire, whose container is the leaf, may send it."""
    leaf = torch.zeros((1, 4, 256))
    group = NodeGroup(rank=0, n=4, device=torch.device("cpu"), backend="gloo")
    tp = RankTransport(group)
    refuse = wire_refused_shapes([leaf], [tw.QuantWire(bits=4)])
    assert (1, 4, 256) in refuse
    with pytest.raises(ValueError, match="dense"):
        tp.exchange({"values": leaf}, (1,), refuse=refuse)
    assert not wire_refused_shapes([leaf], [tw.IdentityWire()])
    with pytest.raises(ValueError, match="dense"):
        tp.exchange({"codes": torch.zeros((1, 4, 1, 32), dtype=torch.int32), "x": leaf}, (1, -1),
                    refuse=refuse)


def test_nccl_with_more_ranks_than_gpus_raises(tmp_path):
    with pytest.raises(ValueError, match="gloo"):
        init_node_group("nccl", rank=0, n=torch.cuda.device_count() + 3,
                        init_method=f"file://{tmp_path}/rendezvous")
    with pytest.raises(ValueError, match="gloo"):
        init_node_group("nccl", rank=0, n=2, init_method=f"file://{tmp_path}/r2", device="cpu")


def test_resumed_rank_run_equals_run_through(runs):
    """A rank run checkpointed at step 1 and resumed equals the run-through
    bit for bit; the stacked loader reads the rank file."""
    (through_tc, through), (tc, resumed) = runs[4]["through"]["ranks"], runs[4]["resumed"]["ranks"]
    want, got = _ckpt(through_tc), _ckpt(tc)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [h["losses"] for h in resumed] == [through[0]["losses"][1:]] * 4
    from repro_torch.checkpoint import restore
    template = run_training(TINY, dataclasses.replace(tc, steps=0, ckpt_dir=None),
                            device="cpu")["state"]
    state, manifest = restore(tc.ckpt_dir, template, STEPS)
    assert manifest["step"] == STEPS and state.step == STEPS
    for path, leaf in leaf_items(state.params):
        np.testing.assert_array_equal(leaf.numpy(), want[".params/" + path])


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-76b"])
def test_rank_batch_is_the_stacked_row(arch):
    cfg = get_config(arch).reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=16, n_shards=8, seed=3)
    for t in (0, 5):
        stacked = stacked_node_batches(dc, t, cfg, device="cpu")
        for i in range(8):
            one = sample_batch(dc, t, i, cfg, device="cpu")
            assert sorted(one) == sorted(stacked)
            for k in one:
                assert torch.equal(one[k], stacked[k][i]), (k, i)


# --- the containers against the JAX wire -------------------------------------

@pytest.mark.parametrize("spec", ["quant:4", "quant:8", "quant:3:256", "sparse:0.05:randk",
                                  "sparse:0.25:randk:128"])
@pytest.mark.parametrize("shape", [(4, 3, 1000), (8, 2, 256), (4, 5, 2, 40)])
def test_rank_containers_are_rows_of_the_jax_encode(spec, shape):
    """Node ``i``'s ``(1, ...)`` slice, encoded with its counter offset, is
    rows ``i`` of the JAX wire's encode of the whole stacked leaf (jitted:
    the send side has no product to contract, so jit moves no code)."""
    rng = np.random.default_rng(sum(shape) + len(spec))
    leaf = rng.standard_normal(shape).astype(np.float32)
    jwire = {"quant": jw.QuantWire, "sparse": jw.SparseWire}[spec.split(":")[0]]
    twire = tw.make_wire_format(spec)
    jwire = jwire(**{f.name: getattr(twire, f.name) for f in dataclasses.fields(twire)})
    seed = 0x5EED ^ shape[0]
    want = jax.jit(lambda x: jwire.encode(x, jnp.uint32(seed)))(jnp.asarray(leaf))
    want = {k: np.asarray(v) for k, v in want.items()}
    for i in range(shape[0]):
        got = twire.encode(torch.from_numpy(leaf[i:i + 1].copy()), seed,
                           twire.node_offset(shape, i))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            v = v.numpy()
            w = want[k][i:i + 1]
            np.testing.assert_array_equal(v.view(w.dtype) if v.dtype != w.dtype else v, w,
                                          err_msg=f"{k} row {i}")


OFFSET_FOLDS = [(40, 128), (12, 1024)]


def _encoders():
    return {
        "K1": lambda x, s, o: ref.quantize_pack_2d_ref(x, s, bits=4, offset=o),
        "K3": lambda x, s, o: ref.quantize_2d_ref(x, s, bits=8, offset=o),
        "K6-randk": lambda x, s, o: ref.sparse_select_pack_2d_ref(x, s, p=0.25, mode="randk",
                                                                  offset=o),
    }


@pytest.mark.parametrize("kernel", ["K1", "K3", "K6-randk"])
@pytest.mark.parametrize("rows,cols", OFFSET_FOLDS)
@pytest.mark.parametrize("base", [0, 2**32 - 3 * 128 - 5])
def test_plain_offset_is_rows_of_the_whole_fold(kernel, rows, cols, base):
    """The plain K1, K3 and K6 random-k over rows ``r0:`` of a fold with
    offset ``base + r0*cols`` are those rows of the whole fold encoded at
    ``base`` (the second base wraps past 2^32 inside the fold); at base 0
    the whole fold is the JAX kernels' reference."""
    rng = np.random.default_rng(rows * cols)
    x = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    enc = _encoders()[kernel]
    whole = enc(x, 77, base)
    for r0 in (1, 3, rows // 2):
        part = enc(x[r0:].contiguous(), 77, (base + r0 * cols) % 2**32)
        for w, p in zip(whole, part):
            assert torch.equal(w[r0:], p), (kernel, r0)
    if base == 0:
        from repro.kernels import ref as jref
        xj = jnp.asarray(x.numpy())
        want = jax.jit({
            "K1": lambda x: jref.quantize_pack_2d_ref(x, jnp.uint32(77), bits=4),
            "K3": lambda x: jref.quantize_2d_ref(x, jnp.uint32(77), bits=8),
            "K6-randk": lambda x: jref.sparse_select_pack_2d_ref(x, jnp.uint32(77), p=0.25,
                                                                 mode="randk")}[kernel])(xj)
        for w, j in zip(whole, want):
            j = np.asarray(j)
            w = w.numpy()
            np.testing.assert_array_equal(w.view(j.dtype) if w.dtype != j.dtype else w, j)


def test_dist_state_from_jax_takes_a_node_slice():
    rng = np.random.default_rng(5)
    p = {"blk": {"w": jnp.asarray(rng.standard_normal((6, 256)).astype(np.float32))}}
    st = jd.init_dist_state("dcd", p, jg.GossipPlan.ring(4), jmake("adamw"), drop="0.2",
                            wire="lowrank:2:warm")
    leaves, tdef = jax.tree.flatten(st)
    st = jax.tree.unflatten(tdef, [l if l.ndim == 0 else l + jnp.asarray(
        rng.standard_normal(l.shape), l.dtype) for l in leaves])
    whole = convert.dist_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    for i in range(4):
        one = convert.dist_state_from_jax(jax.tree.map(np.asarray, st), device="cpu", node=i)
        assert torch.equal(one.params["blk"]["w"], whole.params["blk"]["w"][i:i + 1])
        assert torch.equal(one.opt.m["blk"]["w"], whole.opt.m["blk"]["w"][i:i + 1])
        for k, v in whole.aux.items():
            if k.startswith("fresh"):
                assert torch.equal(one.aux[k], v)
            else:
                for (_, a), (_, b) in zip(leaf_items(one.aux[k]), leaf_items(v)):
                    assert torch.equal(a, b[i:i + 1]), k
