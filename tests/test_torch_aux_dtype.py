"""bfloat16 replicas and estimates (``aux_dtype``) in the port against the
JAX runtime run eagerly at ``aux_dtype=jnp.bfloat16``, on the CPU.

Both runtimes build their state with ``init_dist_state(...,
aux_dtype=bf16)`` from the same float32 params and take three steps with
the same updates: the per-node loss is linear, ``sum(p * g)``, so SGD turns
a numpy tree ``g`` into ``-lr * g``.  The JAX step runs eagerly: jit's FMA
contraction moves last bits and, through them, later rounds' stochastic
codes.  After each step every bf16 aux leaf is held to JAX's bit for bit,
and the params to atol 1e-5, for DCD, ECD, CHOCO and DeepSqueeze over
``quant:4``, ``quant:8``, ``sign``, ``sparse:0.05:topk`` and
``lowrank:2:warm`` on a ring, and over ``quant:4`` on a chain (per-node
weights) with drops at 0.1.  The dtypes follow JAX's promotion: ECD's
params become bf16 (``X_next`` mixes bf16 estimates), DeepSqueeze's
residual float32 after the first step (``V = X_half + err`` is float32).

Two wires do not give JAX's words to the bit in float32 either, and so not
their bf16 trees: the sign scale is a sum the port takes in its kernel's
order (rtol 1e-5, ``test_torch_codecs.py``) and the low-rank factors agree
to rounding (``test_torch_lowrank.py``).  For them a bf16 leaf may differ
from JAX's where a float32 value
a few ulps apart rounds to the other side: within ``rtol`` 2^-7 (one bf16
ulp) or ``ATOL`` near zero.

The JAX receive kernels run in interpret mode, each jitted once (the kernel
alone: the wire's ops around it stay eager).  As in
``test_torch_runtime_plans.py``, the JAX wire scales the accumulator
by ECD's decay ``aw`` in its own float32 op and adds at weight 1: the
interpret-mode Pallas receive contracts ``aw*acc + value`` into an FMA at
``aw`` other than +-1, the port's kernels round ``aw*acc`` first.

Also here: ``rekey_dist_state(aux_dtype=)``, a bf16-aux checkpoint read
both ways, ``dist_state_from_jax(node=)``, a 2-rank gloo run bit-equal to
the stacked bf16 run, and the four receives' plain versions with a bf16
accumulator against the JAX wire's ``decode_axpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.distributed import wire as jw
from repro.kernels import lowrank as jlowrank
from repro.optim import sgd as jsgd
from repro.optim.schedules import constant as jconstant
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.convert import dist_state_from_jax
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.distributed import wire as tw
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.schedules import constant as tconstant
from repro_torch.tree import leaf_items
from test_torch_families import one_torch_thread  # noqa: F401  (autouse fixture)

N, LR, STEPS, ATOL = 4, 0.05, 3, 1e-5
SHAPES = {"w": (2, 1024), "b": (384,)}      # one matrix leaf, one 1-D leaf off a whole block
WIRES = ("quant:4", "quant:8", "sign", "sparse:0.05:topk", "lowrank:2:warm")
ALGOS = ("dcd", "ecd", "choco", "deepsqueeze")
LOOSE_WIRES = ("sign", "lowrank:2:warm")    # float32 words to rounding, see above
CASES = [(a, w, "ring", None) for a in ALGOS for w in WIRES] + \
    [(a, "quant:4", "chain", "0.1:3") for a in ALGOS]


# the JAX receive kernels jitted once (interpret mode): called eagerly, each
# call lowers its pallas_call anew, a second apiece on the CPU
_JAX_RECEIVES = {name: jax.jit(getattr(jw, name), static_argnames=static)
                 for name, static in (("unpack_dequant_axpy_2d", ("bits", "interpret")),
                                      ("unpack_sign_axpy_2d", ("interpret",)),
                                      ("sparse_scatter_axpy_2d", ("interpret",)))}
_JAX_LOWRANK_AXPY = jax.jit(jlowrank.lowrank_axpy_2d, static_argnames=("interpret",))


@pytest.fixture(autouse=True)
def jitted_jax_receives(monkeypatch):
    for name, fn in _JAX_RECEIVES.items():
        monkeypatch.setattr(jw, name, fn)
    monkeypatch.setattr(jlowrank, "lowrank_axpy_2d", _JAX_LOWRANK_AXPY)


_PRESCALED = {}


def _prescaled(jwire):
    """The JAX wire with ``decode_axpy``'s ``aw*acc`` rounded in its own
    float32 op (the port's association), the result in ``acc``'s dtype.
    One subclass a wire class, so that JAX's caches serve every case."""
    base = type(jwire)
    if base not in _PRESCALED:
        class Prescaled(base):
            def decode_axpy(self, payload, acc, weight, acc_weight=1.0):
                scaled = jnp.float32(acc_weight) * acc.astype(jnp.float32)
                return base.decode_axpy(self, payload, scaled, weight, 1.0).astype(acc.dtype)

        Prescaled.__name__ = base.__name__
        _PRESCALED[base] = Prescaled
    return _PRESCALED[base](**{f.name: getattr(jwire, f.name)
                               for f in dataclasses.fields(jwire)})


def _linear_loss_jax(p, batch):
    return jnp.sum(p["w"] * batch["gw"]) + jnp.sum(p["b"] * batch["gb"]), {}


def _linear_loss_torch(p, batch):
    return torch.sum(p["w"] * batch["gw"]) + torch.sum(p["b"] * batch["gb"]), {}


def _bits(a) -> np.ndarray:
    """A leaf's values for exact comparison: bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_leaf(t, j, what: str, loose: bool = False) -> None:
    """A port leaf against JAX's: the same dtype; bf16 bit-equal (``loose``:
    to one bf16 ulp), float32 to ``ATOL``."""
    jn = np.asarray(j)
    assert str(t.dtype).split(".")[-1] == jn.dtype.name, (what, t.dtype, jn.dtype)
    if t.dtype == torch.bfloat16 and not loose:
        np.testing.assert_array_equal(_bits(t), _bits(jn), err_msg=what)
    elif t.dtype == torch.bfloat16:
        # one bf16 ulp of the value (2^-7 relative), or ATOL near zero
        np.testing.assert_allclose(t.float().numpy(), jn.astype(np.float32), rtol=2.0 ** -7,
                                   atol=ATOL, err_msg=what)
    else:
        np.testing.assert_allclose(t.numpy(), jn, rtol=0, atol=ATOL, err_msg=what)


def _params(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(algo, spec, topo, drop, rng, steps=STEPS, check_each=True):
    jplan, tplan = jg.make_gossip_plan(topo, N), tg.make_gossip_plan(topo, N)
    p0 = _params(rng)
    jwire = _prescaled(jw.make_wire_format(spec))
    twire = tw.make_wire_format(spec)
    jstate = jd.init_dist_state(algo, jax.tree.map(jnp.asarray, p0), jplan, jsgd(),
                                aux_dtype=jnp.bfloat16, drop=drop, wire=jwire)
    tstate = td.init_dist_state(algo, {k: torch.from_numpy(v) for k, v in p0.items()}, tplan,
                                tsgd(), aux_dtype=torch.bfloat16, drop=drop, wire=twire)
    jstep = jd.make_dist_train_step(_linear_loss_jax, algo, jsgd(), jwire, jplan,
                                    jconstant(LR), drop=drop)
    tstep = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), twire, tplan,
                                    tconstant(LR), drop=drop)
    for t in range(steps):
        g = {"gw": rng.standard_normal((N,) + SHAPES["w"]).astype(np.float32),
             "gb": rng.standard_normal((N,) + SHAPES["b"]).astype(np.float32)}
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, g))
        tstate, _ = tstep(tstate, {k: torch.from_numpy(v) for k, v in g.items()})
        if check_each or t == steps - 1:
            _assert_states(jstate, tstate, f"{algo} {spec} {topo} step {t}",
                           spec in LOOSE_WIRES)
    return jstate, tstate


def _assert_states(jstate, tstate, what, loose=False):
    for k in SHAPES:
        _assert_leaf(tstate.params[k], jstate.params[k], f"{what} params {k}", loose)
    assert sorted(tstate.aux) == sorted(jstate.aux), what
    for a, jt in jstate.aux.items():
        if a.startswith("fresh"):
            np.testing.assert_array_equal(tstate.aux[a].numpy(), np.asarray(jt), err_msg=a)
        elif a.startswith("wire_"):
            continue        # the low-rank codec state: float32 factors, to rounding
        else:
            for k in SHAPES:
                _assert_leaf(tstate.aux[a][k], jt[k], f"{what} {a}/{k}", loose)


@pytest.mark.parametrize("algo,spec,topo,drop", CASES)
def test_bf16_aux_runtime_matches_jax(algo, spec, topo, drop):
    rng = np.random.default_rng(sum(map(ord, f"{algo}{spec}{topo}")))
    jstate, tstate = _run_both(algo, spec, topo, drop, rng)
    bf16 = [l for a, t in tstate.aux.items() if not a.startswith(("fresh", "wire_"))
            for _, l in leaf_items(t)]
    if algo == "deepsqueeze":       # the residual is float32 after a step, as in JAX
        assert all(l.dtype == torch.float32 for l in bf16)
    else:
        assert bf16 and all(l.dtype == torch.bfloat16 for l in bf16)
    want = torch.bfloat16 if algo == "ecd" else torch.float32
    assert all(tstate.params[k].dtype == want for k in SHAPES)


def test_weights_round_to_the_leaf_dtype_as_jax_promotes():
    """Each promotion rule of a bf16 replica, in both packages: a scalar
    weight is rounded to bf16 before the product; per-node weights are cast
    to the leaf's dtype; bf16 plus f32 is f32; and an f32 0-d array times a
    bf16 array is f32 in JAX, where torch's 0-d f32 tensor would keep bf16
    (the port promotes the operand itself)."""
    rng = np.random.default_rng(5)
    rep = rng.standard_normal((3, 256)).astype(np.float32)
    jrep = jnp.asarray(rep).astype(jnp.bfloat16)
    trep = torch.from_numpy(rep).to(torch.bfloat16)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    w = 1.0 / 3.0                                # not a bf16 value
    jprod = w * jrep
    tprod = tg.weight_for(w, trep) * trep
    assert tprod.dtype == torch.bfloat16 and jprod.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(tprod), _bits(jprod))
    vec = np.array([0.3, 1 / 3, 0.7], dtype=np.float32)
    jv = jg._weight_for(vec, jrep) * jrep
    tv = tg.weight_for(vec, trep) * trep
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    jsum = jnp.asarray(x) + jprod                  # bf16 + f32 -> f32
    tsum = torch.from_numpy(x) + tprod
    assert jsum.dtype == jnp.float32 and tsum.dtype == torch.float32
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    s_t = jnp.float32(3.0)                       # ECD's counter: a float32 array
    jz = (0.5 * s_t) * jrep
    assert jz.dtype == jnp.float32
    assert (torch.tensor(1.5) * trep).dtype == torch.bfloat16     # torch's rule differs
    np.testing.assert_array_equal((1.5 * trep.to(torch.float32)).numpy(), np.asarray(jz))


def test_bf16_receives_match_the_jax_wire():
    """The four fused receives' plain versions (K2, K5b, K6c, K7b) with a
    bf16 accumulator, through the port's ``decode_axpy_``, against the JAX
    wire's eager ``decode_axpy`` on the same payload (words carried across):
    bit-equal at ``aw`` = 1 and -1."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    acc = rng.standard_normal((4, 1024)).astype(np.float32)
    for spec in ("quant:4", "sign", "sparse:0.05:topk", "lowrank:2"):
        jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
        jpay = jwire.encode(jnp.asarray(x), jw.leaf_seed(1, 2, 0))
        tpay = {k: torch.from_numpy(np.array(v).view(np.int32) if v.dtype == jnp.uint32
                                    else np.array(v)) for k, v in jpay.items()}
        jacc = jnp.asarray(acc).astype(jnp.bfloat16)
        for aw, w in ((1.0, 1.0), (-1.0, 0.5)):
            want = jwire.decode_axpy(jpay, jacc, w, aw)
            tacc = torch.from_numpy(acc).to(torch.bfloat16)
            got = twire.decode_axpy_(tpay, tacc, w, aw)
            assert got is tacc and got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{spec} aw={aw}")


def test_rekey_casts_the_new_aux_to_bf16():
    rng = np.random.default_rng(3)
    X = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SHAPES.items()}
    for algo in ALGOS:
        jst = jd.init_dist_state(algo, jax.tree.map(lambda a: jnp.asarray(a[0]), X),
                                 jg.make_gossip_plan("ring", N), jsgd())
        jst = jst._replace(params=jax.tree.map(jnp.asarray, X))
        tst = dist_state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
        jst = jd.rekey_dist_state(jst, algo, jg.make_gossip_plan("full_logn", N),
                                  aux_dtype=jnp.bfloat16, drop="0.1:2")
        tst = td.rekey_dist_state(tst, algo, tg.make_gossip_plan("full_logn", N),
                                  aux_dtype=torch.bfloat16, drop="0.1:2")
        _assert_states(jst, tst, f"rekey {algo}")


def _bf16_jax_state(algo="choco", steps=2):
    rng = np.random.default_rng(21)
    jstate, _ = _run_both(algo, "quant:4", "ring", None, rng, steps=steps, check_each=False)
    return jstate


def test_bf16_aux_checkpoint_read_both_ways(tmp_path):
    jstate = _bf16_jax_state()
    tstate = dist_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jck.save(str(tmp_path / "jax"), 2, jstate)
    template = td.init_dist_state("choco", {k: torch.zeros(s) for k, s in SHAPES.items()}, N,
                                  tsgd(), aux_dtype=torch.bfloat16)
    restored, _ = tck.restore(str(tmp_path / "jax"), template)
    _assert_states(jstate, restored, "jax save -> port restore")
    tck.save(str(tmp_path / "port"), 2, tstate)
    jtemplate = jd.init_dist_state("choco", {k: jnp.zeros(s) for k, s in SHAPES.items()},
                                   jg.GossipPlan.ring(N), jsgd(), aux_dtype=jnp.bfloat16)
    jback, _ = jck.restore(str(tmp_path / "port"), jtemplate)
    _assert_states(jback, tstate, "port save -> jax restore")
    assert all(l.dtype == jnp.bfloat16 for l in jax.tree.leaves(jback.aux))


def test_dist_state_from_jax_node_keeps_bf16():
    jstate = _bf16_jax_state("dcd", steps=1)
    whole = dist_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for node in (0, N - 1):
        part = dist_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu", node=node)
        for a, t in part.aux.items():
            for (p, l), (_, w) in zip(leaf_items(t), leaf_items(whole.aux[a])):
                assert l.dtype == torch.bfloat16 and l.shape[0] == 1
                assert torch.equal(l[0].view(torch.int16), w[node].view(torch.int16)), (a, p)


RANKS = 2


def _rank_run(group, p0, grads, spec):
    torch.set_num_threads(1)
    plan = tg.make_gossip_plan("ring", RANKS)
    state = td.init_dist_state("dcd", {k: torch.from_numpy(v) for k, v in p0.items()}, plan,
                               tsgd(), wire=spec, group=group, aux_dtype=torch.bfloat16)
    step = td.make_dist_train_step(_linear_loss_torch, "dcd", tsgd(), spec, plan,
                                   tconstant(LR), group=group)
    for g in grads:
        state, _ = step(state, {k: torch.from_numpy(v[group.rank:group.rank + 1])
                                for k, v in g.items()})
    # numpy, not tensors: a tensor in the result queue shares its storage
    # with a process that exits
    trees = dict(state.aux, params=state.params)
    return {a: {p: (str(l.dtype), _bits(l).copy()) for p, l in leaf_items(t)}
            for a, t in trees.items()}


def test_two_gloo_ranks_match_the_stacked_bf16_run():
    rng = np.random.default_rng(8)
    p0 = _params(rng)
    grads = [{"gw": rng.standard_normal((RANKS,) + SHAPES["w"]).astype(np.float32),
              "gb": rng.standard_normal((RANKS,) + SHAPES["b"]).astype(np.float32)}
             for _ in range(2)]
    spec = "quant:4"
    plan = tg.make_gossip_plan("ring", RANKS)
    state = td.init_dist_state("dcd", {k: torch.from_numpy(v) for k, v in p0.items()}, plan,
                               tsgd(), wire=spec, aux_dtype=torch.bfloat16)
    step = td.make_dist_train_step(_linear_loss_torch, "dcd", tsgd(), spec, plan, tconstant(LR))
    for g in grads:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in g.items()})
    outs = spawn_ranks(_rank_run, RANKS, "gloo", p0, grads, spec, device="cpu")
    for rank, out in enumerate(outs):
        assert sorted(out) == sorted([*state.aux, "params"])
        for a, leaves in out.items():
            tree = state.params if a == "params" else state.aux[a]
            for p, (dtype, bits) in leaves.items():
                want = dict(leaf_items(tree))[p][rank:rank + 1]
                assert dtype == str(want.dtype), (rank, a, p)
                np.testing.assert_array_equal(bits, _bits(want), err_msg=f"{rank} {a} {p}")
    assert any(l.dtype == torch.bfloat16 for t in state.aux.values()
               for _, l in leaf_items(t))


def test_mix_reads_each_lazy_neighbour_once():
    """A lazily decoded neighbour (naive, D-PSGD) is made once a shift and
    mix, bf16 leaf or not: the weight's dtype is taken from the neighbour
    already made."""
    from repro_torch.distributed.transport import Lazy
    plan = tg.make_gossip_plan("ring", N)
    for dtype in (torch.float32, torch.bfloat16):
        made = []
        x = torch.ones((N, 8), dtype=dtype)
        nbrs = Lazy(lambda s: made.append(s) or torch.roll(x, s, dims=0))
        tg.mix_leaf(plan, x, nbrs)
        assert sorted(made) == sorted(plan.shift_list)
