"""The port's dryrun against the JAX package's, on the CPU.

The JAX dryrun lowers and compiles each step on a forced 256- or 512-device
host mesh; the port builds it on the meta device.  What follows from shapes
and the plan alone is held to the JAX package's own functions, exactly:

* for every architecture at ``train_4k``, on 1 pod and 2 pods, the train
  record's ``params_total``, wire fields (``wire_payload_bytes``,
  ``wire_bits_per_element``, ``wire_format``, ``wire_spec_per_leaf``),
  gossip fields, failure record and controller record, from the JAX
  dryrun's record helpers over its ``eval_shape`` state (drop 0.1 and
  straggler 0.5 in one case);
* ``model_flops`` and ``active_param_count``;
* ``param_pspec`` for every leaf of every architecture on the train
  layout (node-stacked) and the serve layout, against the JAX rules over a
  stub ``Mesh`` (``axis_names`` and ``devices``, all that they read); the
  decode caches' specs against ``cache_shardings``;
* the per-device argument bytes of the train state, from those specs.

The FLOP counts and their depth extrapolation are in
``test_torch_dryrun_counts.py``.  ``dryrun_smoke(device="cpu")`` prints the
``[SMOKE OK]`` record with JAX's keys; ``--json`` records load with both
packages' ``load_dryrun_records`` and feed both ``plan_phases_measured``
to the same plan.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
(it must run before JAX starts a backend).  Here JAX's CPU backend is
started first, and the variable is put back after the test
(``monkeypatch``), so no later process of this worker inherits it.
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.distributed import sharding as jsh
from repro.distributed import wire as jw
from repro.distributed.failures import make_drop_spec as jmake_drop
from repro.launch import analysis as janalysis
from repro.launch import specs as jspecs
from repro.netsim import load_dryrun_records as jload
from repro.netsim import plan_phases_measured as jplan_measured
from repro.optim import sgd as jsgd
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import plans as tplans
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.netsim import load_dryrun_records as tload
from repro_torch.netsim import plan_phases_measured as tplan_measured
from repro_torch.tree import leaf_items
from test_torch_families import one_torch_thread  # noqa: F401

@pytest.fixture
def jdr(monkeypatch):
    """The JAX dryrun module, imported with JAX's backend already started
    and ``XLA_FLAGS`` restored after the test."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as module
    return module


def _stub(mesh):
    """What the JAX rules read of a ``Mesh``: its axis names and devices."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.devices.shape, dtype=object))


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def test_plans_and_shapes_are_the_jax_packages():
    from repro.distributed import plans as jplans
    assert {a: dataclasses.asdict(p) for a, p in tplans.TRAIN_PLANS.items()} == \
        {a: dataclasses.asdict(p) for a, p in jplans.TRAIN_PLANS.items()}
    assert {a: dataclasses.asdict(p) for a, p in tplans.SERVE_PLANS.items()} == \
        {a: dataclasses.asdict(p) for a, p in jplans.SERVE_PLANS.items()}
    assert {k: dataclasses.asdict(v) for k, v in tspecs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}
    assert tplans.TRAIN_PLANS["mistral-large-123b"].torch_aux_dtype == torch.bfloat16
    assert tplans.TRAIN_PLANS["granite-3-2b"].torch_aux_dtype is None


def test_logical_layouts_follow_the_jax_reshapes():
    for multi_pod in (False, True):
        prod = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert prod.size == (512 if multi_pod else 256)
        for arch, plan in tplans.TRAIN_PLANS.items():
            n = plan.nodes_for(multi_pod)
            m = tmesh.derive_train_mesh(prod, n, plan.tp)
            assert m.axis_names == ("node", "fsdp", "model")
            assert m.devices.shape == (n, prod.size // (n * plan.tp), plan.tp)
            # pod-major: node i's devices are the i-th contiguous block
            assert m.coords(int(m.devices[-1, 0, 0]))["node"] == n - 1
            np.testing.assert_array_equal(m.devices.reshape(-1), np.arange(prod.size))
        s = tmesh.derive_serve_mesh(prod, 8)
        assert s.shape == {"dp": prod.size // 8, "mp": 8}
    with pytest.raises(ValueError):
        tmesh.derive_train_mesh(tmesh.make_production_mesh(), 3, 8)


def _jax_shape_fields(jdr, arch, multi_pod, drop_rate, straggler, algo="dcd",
                      wire="quant:8"):
    cfg = jget_config(arch)
    plan = tplans.TRAIN_PLANS[arch]
    n = plan.nodes_for(multi_pod)
    gossip = jg.make_gossip_plan("ring", n)
    codec = jw.make_wire_format(wire)
    drop = jmake_drop(drop_rate, salt=3)
    p_sds = jspecs.params_specs(cfg)
    aux_dtype = jnp.bfloat16 if plan.aux_dtype == "bfloat16" else None
    state = jax.eval_shape(lambda ps: jd.init_dist_state(algo, ps, gossip, jsgd(),
                                                         aux_dtype=aux_dtype, drop=drop,
                                                         wire=codec), p_sds)
    payload = codec.wire_nbytes(state.params)
    rec = {**jdr._gossip_record(gossip, algo), "params_total": jdr._tree_size(p_sds),
           "wire_payload_bytes": payload,
           "wire_bits_per_element": round(8.0 * payload / jdr._tree_size(state.params), 4),
           "wire_format": codec.wire_format,
           "wire_spec_per_leaf": jdr._wire_spec_per_leaf(codec, state.params)}
    rec.update(jdr._failure_record(codec, gossip, algo, p_sds, drop, straggler))
    rec.update(jdr._controller_record(codec, gossip, algo, p_sds, drop, straggler))
    return json.loads(json.dumps(rec))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_record_shape_fields_equal_jax(jdr, arch, multi_pod):
    drop_rate, straggler = (0.1, 0.5) if arch == "granite-3-2b" and multi_pod else (0.0, 0.0)
    b = tdr.build_train_state(arch, "train_4k", multi_pod=multi_pod, drop_rate=drop_rate,
                              drop_salt=3)
    got = json.loads(json.dumps(tdr.shape_fields(b, "dcd", straggler)))
    want = _jax_shape_fields(jdr, arch, multi_pod, drop_rate, straggler)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (arch, k)
    # the state carries the plan's aux dtype, the batch its node stacking
    aux = [l for a, t in b["state"].aux.items() if not a.startswith("fresh")
           for _, l in leaf_items(t)]
    assert {l.dtype for l in aux} == \
        {tplans.TRAIN_PLANS[arch].torch_aux_dtype or torch.float32}
    assert all(l.device.type == "meta" for _, l in leaf_items(b["state"].params))
    assert b["batch"]["tokens"].shape[0] == b["n"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_jax(jdr, arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = jspecs.params_specs(jcfg)
    tp = tspecs.params_specs(tcfg)
    assert tdr._nonembed_params(tcfg, tp) == jdr._nonembed_params(jcfg, jp)
    n = tdr._nonembed_params(tcfg, tp)
    assert tanalysis.active_param_count(tcfg, n) == janalysis.active_param_count(jcfg, n)
    active = tanalysis.active_param_count(tcfg, n)
    for name in tspecs.SHAPES:
        assert tanalysis.model_flops(tcfg, tspecs.SHAPES[name], active) == \
            janalysis.model_flops(jcfg, jspecs.SHAPES[name], active)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_on_train_and_serve_layouts(arch):
    cfg = get_config(arch)
    n_routed = cfg.moe.n_routed if cfg.moe else None
    jp = jspecs.params_specs(jget_config(arch))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = dict(leaf_items(tspecs.params_specs(cfg)))
    assert sorted(tleaves) == sorted(_jax_path(p) for p, _ in flat)
    for multi_pod in (False, True):
        prod = tmesh.make_production_mesh(multi_pod=multi_pod)
        plan = tplans.TRAIN_PLANS[arch]
        n = plan.nodes_for(multi_pod)
        train = tmesh.derive_train_mesh(prod, n, plan.tp)
        serve = tmesh.derive_serve_mesh(prod, tplans.SERVE_PLANS[arch].mp)
        for path, leaf in flat:
            name = _jax_path(path)
            assert tsh.stack_depth(name) == jsh.stack_depth(path), name
            stacked = jax.ShapeDtypeStruct((n,) + leaf.shape, leaf.dtype)
            want = tuple(jsh.param_pspec(path, stacked, _stub(train), node_axis=True,
                                         n_stack_axes=jsh.stack_depth(path),
                                         n_routed=n_routed))
            got = tsh.param_pspec(name, (n,) + tuple(leaf.shape), train, node_axis=True,
                                  n_stack_axes=tsh.stack_depth(name), n_routed=n_routed)
            assert got == want, (arch, name, "train")
            for use_fsdp in (False, True):
                want = tuple(jsh.param_pspec(path, leaf, _stub(serve), node_axis=False,
                                             n_stack_axes=jsh.stack_depth(path),
                                             n_routed=n_routed, use_fsdp=use_fsdp))
                got = tsh.param_pspec(name, tuple(tleaves[name].shape), serve,
                                      node_axis=False, n_stack_axes=tsh.stack_depth(name),
                                      n_routed=n_routed, use_fsdp=use_fsdp)
                assert got == want, (arch, name, "serve", use_fsdp)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-lite-16b", "zamba2-7b",
                                  "whisper-base"])
def test_cache_and_batch_specs_equal_jax(arch, monkeypatch):
    # the JAX rules wrap each spec in a NamedSharding of the mesh: keep the spec
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: tuple(spec))
    cfg, jcfg = get_config(arch), jget_config(arch)
    serve = tmesh.derive_serve_mesh(tmesh.make_production_mesh(),
                                    tplans.SERVE_PLANS[arch].mp)
    for name in ("decode_32k", "long_500k"):
        shape = tspecs.SHAPES[name]
        jcache, jtok = jspecs.decode_cache_specs(jcfg, jspecs.SHAPES[name])
        jspec = jsh.cache_shardings(jcache, _stub(serve), batch=shape.global_batch)
        want = {jsh._path_names(p): s for p, s in jax.tree_util.tree_flatten_with_path(
            jspec, is_leaf=lambda x: isinstance(x, tuple) and all(
                a is None or isinstance(a, str) for a in x))[0]}
        caches, tok = tspecs.decode_cache_specs(cfg, shape)
        got = tsh.cache_shardings(caches, serve, batch=shape.global_batch)
        assert got and all(spec == want[p] for p, spec in got.items()), (arch, name)
        assert tsh.batch_shardings(tok, serve, node_axis=False) == \
            jsh.batch_shardings(jtok, _stub(serve), node_axis=False)


def test_per_device_argument_bytes_follow_from_the_specs():
    b = tdr.build_train_state("mistral-large-123b", "train_4k", multi_pod=False)
    mesh, state = b["mesh"], b["state"]
    got, whole = tdr._state_bytes_per_device(state, mesh, None)
    want = 0
    sizes = mesh.shape
    for tree in [state.params] + list(state.aux.values()):
        for p, l in leaf_items(tree):
            spec = tsh.param_pspec(p, tuple(l.shape), mesh, node_axis=True,
                                   n_stack_axes=tsh.stack_depth(p)) \
                if l.dim() > 1 else (None,) * l.dim()
            n = l.numel()
            for a in spec:
                n //= sizes[a] if a else 1
            want += n * l.element_size()
    assert got == want
    # 2 nodes x (f32 params + one bf16 replica a shift, 2 shifts... on a ring of
    # 2 one union shift) over the 256 devices, every leaf sharded 128 ways
    params = sum(l.numel() for _, l in leaf_items(b["p_sds"]))
    assert whole == params * 2 * 4 + params * 2 * 2 * len(
        [a for a in state.aux if a.startswith("rep")])
    assert tsh.shard_shape((2, 88, 12288, 1024), ("node", None, "fsdp", "model"), mesh) == \
        (1, 88, 12288 // 16, 1024 // 8)


JAX_SMOKE_KEYS = {"arch", "kind", "algo", "wire", "topology", "gossip_degree",
                  "gossip_rounds", "gossip_payloads", "n_devices", "compile_s", "steps",
                  "loss", "analysis", "wire_bits_per_element", "wire_format",
                  "wire_spec_per_leaf", "controller"}


def test_smoke_on_cpu_prints_the_jax_record(capsys):
    rec = tdr.dryrun_smoke("granite-3-2b", device="cpu")
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[SMOKE OK] ")]
    assert len(line) == 1 and json.loads(line[0][len("[SMOKE OK] "):]) == json.loads(
        json.dumps(rec))
    assert set(rec) == JAX_SMOKE_KEYS
    assert rec["n_devices"] == 1 and rec["steps"] == 2 and np.isfinite(rec["loss"])
    assert rec["analysis"]["permute_whitelist_violations"] == 0


def test_json_records_load_in_both_packages_and_plan_phases(tmp_path):
    path = str(tmp_path / "dr.jsonl")
    for wire in ("quant:8", "quant:4"):
        tdr.main(["--arch", "whisper-base", "--shape", "train_4k", "--wire", wire,
                  "--json", path])
    tdr.main(["--arch", "whisper-base", "--shape", "decode_32k", "--json", path])
    trecs, jrecs = tload(path), jload(path)
    assert trecs == jrecs and len(trecs) == 3
    train = trecs[0]
    assert train["memory"]["argument_bytes"] > 0 and train["flops_per_chip"] > 0
    assert train["bottleneck"] in ("compute", "memory", "collective")
    assert train["build_s"] > 0 and train["xla_raw_flops"] is None
    tplan = tplan_measured(trecs, total_steps=100)
    jplan = jplan_measured(jrecs, total_steps=100)
    assert tplan.describe() == jplan.describe()


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b", "internvl2-76b"])
def test_input_and_param_specs_have_the_jax_shapes(arch):
    """The meta stand-ins have the JAX package's shapes (token ids int64,
    the port's dtype, where JAX's are int32); nothing is allocated."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jp = jspecs.stacked_params_specs(jcfg, 4)
    tp = dict(leaf_items(tspecs.stacked_params_specs(cfg, 4)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp[_jax_path(path)]
        assert tuple(t.shape) == leaf.shape and t.device.type == "meta"
    for name, shape in tspecs.SHAPES.items():
        if shape.kind == "train":
            got, want = tspecs.train_input_specs(cfg, shape, 4), \
                jspecs.train_input_specs(jcfg, jspecs.SHAPES[name], 4)
        elif shape.kind == "prefill":
            got, want = tspecs.prefill_input_specs(cfg, shape), \
                jspecs.prefill_input_specs(jcfg, jspecs.SHAPES[name])
        else:
            continue
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, (arch, name)
