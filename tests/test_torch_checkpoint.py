"""The port's checkpointer (``repro_torch/checkpoint``), its carry
section and the restart path's gloo work, against the JAX package's
``checkpoint/checkpointer.py`` on the CPU.

Unit tests: every case of ``tests/test_checkpoint.py`` on the port's
``Checkpointer`` in one process (schema, round trip, bitcast dtypes,
async save + wait + gc, the readable structure, treedef and shape
errors, a short block list, the section filter, v1 back-compat, a meta
example), and the port's flatten printing the JAX package's key paths
and treedefs.

Format parity: the same state (numpy from a seed: bf16 parameters,
fp32 moments and master weights, step 7) from a JAX ``StepBundle`` and
from the port's 8 gloo ranks (each rank's shards cut by
``StepBundle.shard`` and ``opt_shards``, independently of the
checkpointer's blocks), saved by both packages, for fcdp at (2, 2, 2)
with a padded vocabulary (tp 2), hier at (2, 2, 2) (widened optimizer
state), fcdp at (2, 4, 1) (tp 1) and gemma-smoke's tied tree (no
``head`` leaf) under fcdp at (2, 2, 2): equal manifests and byte-equal
leaf files. Each package restores the other's checkpoint bit for bit:
the port's restored shards equal its own, and re-saved they equal the
JAX files byte for byte; the JAX ``Checkpointer.restore`` under
``state_shardings()`` returns the numpy state.

The carry: the JAX ``build_train_prime`` carry and the port's ``prime``
carry of the same parameters and batch at (2, 2, 2), microbatch 2,
fp32, compared as global arrays (the carry section of both packages'
checkpoints) within the step tolerances; the port restores the JAX
carry (same mesh and signature) and re-saves it byte for byte; the JAX
``reshard_state`` restores the port's. ``cross_step_carry_signature``
and ``mesh_meta`` equal the JAX package's.

The JAX half runs in a subprocess (as ``tests/test_torch_streams.py``
runs it) while the ranks start; the ranks wait for its checkpoints. The
ranks' work, shared with ``tests/test_torch_restart.py`` (its restart
scenarios run in the same spawn, and a 4-rank spawn follows for the
elastic leg), is computed once per session (``shared_result``).
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (MANIFEST_VERSION, Block,
                                    CheckpointError, Checkpointer)
from repro_torch.checkpoint.checkpointer import flatten_with_path, _keystr
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.launch.mesh import MeshShape

AXES = ("pod", "data", "model")
DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
# the vocabulary padded to 256 at tp 2
PADDED = dict(DENSE, vocab_size=255)
SEQ, BATCH = 64, 8
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
# gemma-smoke: tied embeddings, no head leaf
TIED = dict(name="gemma-smoke", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=1, d_ff=192, vocab_size=512,
            head_dim=16, act="geglu", tie_embeddings=True)
# name -> (model, mesh sizes, system knobs): the format-parity configs
CONFIGS = {
    "fcdp_tp2": (PADDED, (2, 2, 2), dict(mode="fcdp")),
    "hier": (DENSE, (2, 2, 2), dict(mode="hier")),
    "fcdp_tp1": (DENSE, (2, 4, 1), dict(mode="fcdp")),
    "tied_gemma": (TIED, (2, 2, 2), dict(mode="fcdp")),
}
# the carry check: fcdp, streams 2 and 3, microbatch 2, fp32
CARRY = (DENSE, (2, 2, 2), dict(mode="fcdp", async_grad_reduce=True,
                                cross_step_pipeline=True, dtype="float32"))
CARRY_MB = 2
STEP = 7                     # the optimizer step the format state carries
# the carry against the JAX prime's, relative to each leaf's largest
# entry: the grad-norm tolerance of the step tests
CARRY_RTOL = 1e-3


def _sys_knobs(kw, pkg):
    """``kw`` as SystemConfig arguments of ``pkg`` ('jax' or 'torch')."""
    kw = dict(kw)
    dtype = kw.pop("dtype", "bfloat16")
    if pkg == "jax":
        kw.update(param_dtype=dtype, compute_dtype=dtype, quant_impl="jnp",
                  fused_impl="jnp")
    else:
        kw["dtype"] = dtype
    return dict(min_shard_size=8, **kw)


def port_run(model, kw, microbatch=0):
    return RunConfig(model=ModelConfig(**model),
                     shape=ShapeCell("t", "train", SEQ, BATCH),
                     system=SystemConfig(**_sys_knobs(kw, "torch")),
                     optimizer=OptimizerConfig(**OPT), microbatch=microbatch)


def port_bundle(model, sizes, kw, microbatch=0, mesh=None):
    from repro_torch.core.engine import StepBundle
    return StepBundle(port_run(model, kw, microbatch), device="cpu",
                      mesh=mesh or MeshShape(AXES, sizes))


def jax_bundle(model, sizes, kw, microbatch=0):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.base import SystemConfig as JSystemConfig
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    import jax
    run = JRunConfig(model=JModelConfig(**model),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=JSystemConfig(**_sys_knobs(kw, "jax")),
                     optimizer=JOptimizerConfig(**OPT), microbatch=microbatch)
    n = int(np.prod(sizes))
    return JStepBundle(run, make_mesh(sizes, AXES,
                                      devices=jax.devices()[:n]))


def _bf16_exact(x):
    """``x`` rounded to bf16, as fp32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def global_state(name):
    """The format state of config ``name``: per trainable leaf path the
    global parameter (bf16 values, as fp32), m, v (> 0) and master, from
    numpy seeded by the config; step ``STEP``."""
    model, sizes, kw = CONFIGS[name]
    b = port_bundle(model, sizes, kw)
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    out = {"params": {}, "m": {}, "v": {}, "master": {}, "step": STEP}
    for i in b.train_idx:
        path, shape = b.paths[i], b.def_leaves[i].shape
        out["params"][path] = _bf16_exact(
            rng.normal(0, 1, shape).astype(np.float32))
        out["m"][path] = rng.normal(0, 1e-2, shape).astype(np.float32)
        out["v"][path] = rng.uniform(0, 1e-3, shape).astype(np.float32)
        out["master"][path] = rng.normal(0, 1, shape).astype(np.float32)
    return out


def make_batch(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


def carry_params():
    """The carry check's parameters: a nested dict of fp32 numpy arrays
    (the port's def tree), from a seed."""
    model, sizes, kw = CARRY
    b = port_bundle(model, sizes, kw, CARRY_MB)
    rng = np.random.default_rng(100)
    tree = {}
    for path, d in zip(b.paths, b.def_leaves):
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = (rng.normal(0, 0.05, d.shape).astype(np.float32)
                      if d.init not in ("ones",)
                      else np.ones(d.shape, np.float32))
    return tree


# -- the JAX half (a subprocess) --------------------------------------------

def _jax_reference(root):
    """Write the JAX checkpoints under ``root/jax``: each format config's
    state at step 1, then the carry config's prime at step 1; a
    ``done`` file after each, an ``error`` file on failure."""
    root = Path(root)
    try:
        import jax
        import jax.numpy as jnp
        from repro.checkpoint.checkpointer import Checkpointer as JCk
        from repro.runtime.elastic import mesh_meta as jmeta
        for name, (model, sizes, kw) in CONFIGS.items():
            b = jax_bundle(model, sizes, kw)
            g = global_state(name)
            sh = b.state_shardings()
            labels = [b.def_leaves[i].label for i in b.train_idx]
            tree = {"params": [jax.device_put(
                        jnp.asarray(g["params"][p], jnp.bfloat16), s)
                        for p, s in zip(labels, sh["params"])],
                    "opt": {k: [jax.device_put(g[k][p], s) for p, s in
                                zip(labels, sh["opt"][k])]
                            for k in ("m", "v", "master")}}
            tree["opt"]["step"] = jax.device_put(jnp.int32(STEP),
                                                 sh["opt"]["step"])
            JCk(str(root / "jax" / name)).save(1, tree, blocking=True,
                                               meta=jmeta(b.mesh))
            (root / "jax" / f"{name}.done").touch()
        _jax_carry(root)
        (root / "jax" / "carry.done").touch()
    except BaseException:
        import traceback
        (root / "jax").mkdir(parents=True, exist_ok=True)
        (root / "jax" / "error").write_text(traceback.format_exc())
        raise


def _jax_carry(root):
    import functools as ft

    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCk
    from repro.optim.adamw import init_opt_state
    from repro.runtime.elastic import mesh_meta as jmeta
    model, sizes, kw = CARRY
    b = jax_bundle(model, sizes, kw, CARRY_MB)
    tree = carry_params()
    leaves = []
    for d in b.def_leaves:
        node = tree
        for k in d.label.split("."):
            node = node[k]
        leaves.append(node)
    sh = b.state_shardings()["params"]
    tp = [jax.device_put(leaves[i], s) for i, s in zip(b.train_idx, sh)]
    fp = [jax.device_put(leaves[i], jax.sharding.NamedSharding(
        b.mesh, b.leaf_specs[i])) for i in b.frozen_idx]
    ost = jax.jit(ft.partial(init_opt_state, sys=b.run.system))(tp)
    carry, m = b.make_train_prime()(tp, fp, ost, make_batch(0))
    JCk(str(root / "jax" / "carry")).save(
        1, {"params": tp, "opt": ost, "carry": carry}, blocking=True,
        meta=jmeta(b.mesh))
    (root / "jax" / "carry_loss.json").write_text(
        json.dumps(float(m["loss"])))


def wait_for(root, name, timeout_s=600.0):
    """Block until the JAX half has written ``name`` (raise if it
    failed)."""
    root = Path(root) / "jax"
    deadline = time.monotonic() + timeout_s
    while not (root / f"{name}.done").exists():
        if (root / "error").exists():
            raise RuntimeError("the JAX reference failed:\n"
                               + (root / "error").read_text()[-4000:])
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX checkpoint {name}")
        time.sleep(0.1)
    return root / name


def _start_jax(root):
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_checkpoint as t; "
            "t._jax_reference(sys.argv[1])")
    return subprocess.Popen([sys.executable, "-c", code, str(root)],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


# -- the port's ranks ---------------------------------------------------------

def _ckpt(path, **kw):
    import torch.distributed as dist
    return Checkpointer(str(path), rank=dist.get_rank(),
                        world=dist.get_world_size(), barrier=dist.barrier,
                        **kw)


def _format_task(root, mesh, device):
    """Each format config on the 8 ranks: the port's checkpoint of the
    state, then the JAX one restored, compared with the port's shards
    and saved again."""
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.runtime.elastic import mesh_meta
    out = {}
    for name, (model, sizes, kw) in CONFIGS.items():
        rm = mesh if sizes == (2, 2, 2) else RankMesh(
            MeshShape(AXES, sizes), mesh.backend)
        b = port_bundle(model, sizes, kw, mesh=rm)
        g = global_state(name)
        paths = [b.paths[i] for i in b.train_idx]
        train = [b.shard(p, torch.from_numpy(g["params"][p])
                         .to(torch.bfloat16)).detach() for p in paths]
        opt = {k: b.opt_shards([b.shard(p, torch.from_numpy(g[k][p]))
                                .detach() for p in paths])
               for k in ("m", "v", "master")}
        opt["step"] = STEP
        tree = {"params": train, "opt": opt}
        _ckpt(root / "port" / name).save(1, tree, meta=mesh_meta(b),
                                         blocks=b.state_blocks(tree))
        got = _ckpt(wait_for(root, name)).restore(1, tree, shardings=b)
        _ckpt(root / "port" / f"{name}_rt").save(
            1, got, meta=mesh_meta(b), blocks=b.state_blocks(got))
        flat = [t for _, t in flatten_with_path(tree)[0]]
        flat_got = [t for _, t in flatten_with_path(got)[0]]
        out[name] = {
            "equal": [bool(torch.equal(a, c)) if torch.is_tensor(a)
                      else a == c for a, c in zip(flat, flat_got)],
            "device": str(flat_got[0].device),
            "widened": len(b.widen)}
    return out


def _carry_task(root, mesh, coll, device):
    """The carry config's prime on the 8 ranks, saved with its carry; the
    JAX checkpoint with its carry restored (carry-aware) and saved
    again."""
    from repro_torch.launch.train import ModeRun, RunState, TrainJob
    from repro_torch.runtime.elastic import mesh_meta, reshard_state
    model, sizes, kw = CARRY
    job = TrainJob(run=port_run(model, {}), mesh=mesh.mesh_shape, runs=[],
                   device="cpu", params=carry_params(),
                   batches=[make_batch(0)])
    st = RunState(job, ModeRun(microbatch=CARRY_MB, **kw), mesh, coll,
                  device)
    m = st.do_train_step(st.batch(0))
    tree = st.state_tree()
    _ckpt(root / "port" / "carry").save(1, tree, meta=mesh_meta(st.bundle),
                                        blocks=st.bundle.state_blocks(tree))
    jck = _ckpt(wait_for(root, "carry"))
    state, invalidated = reshard_state(
        jck, 1, st.bundle, {"params": st.train_p, "opt": st.opt})
    _ckpt(root / "port" / "carry_rt").save(
        1, state, meta=mesh_meta(st.bundle),
        blocks=st.bundle.state_blocks(state))
    return {"loss": m["loss"], "invalidated": invalidated,
            "restored_carry": "carry" in state,
            "carry_shapes": [tuple(t.shape) for t in tree["carry"]["g_acc"]]}


def _ranks_task(root, job, mesh, coll, device, state):
    """Everything the 8 ranks do besides ``job.runs`` (the restart
    driver's runs): the format configs, the carry, the restart
    scenarios of ``tests/test_torch_restart.py``."""
    import test_torch_restart as tr
    return {"format": _format_task(root, mesh, device),
            "carry": _carry_task(root, mesh, coll, device),
            "restart": tr.scenarios(root, mesh, coll, device)}


def _compute(tmp_path_factory):
    from repro_torch.launch.train import TrainJob, spawn
    import test_torch_restart as tr
    root = Path(tmp_path_factory.mktemp("torch_ckpt"))
    proc = _start_jax(root)
    try:
        job = tr.driver_job(root)
        job.task = functools.partial(_ranks_task, root)
        ranks = spawn(job, str(root), timeout_s=900)
        elastic = spawn(tr.elastic_job(root), str(root), timeout_s=600)
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"the JAX reference failed:\n{err[-4000:]}")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return {"root": str(root),
            "ranks": [{"task": r["task"], "runs": r["runs"]} for r in ranks],
            "elastic": [r["task"] for r in elastic]}


_RUNS = {}


def shared_runs(tmp_path_factory):
    """The ranks' results, computed once per session (once per process
    here, once per session across pytest-xdist's workers)."""
    from test_torch_train import shared_result
    if "runs" not in _RUNS:
        _RUNS["runs"] = shared_result(tmp_path_factory, "torch_ckpt_runs",
                                      lambda: _compute(tmp_path_factory))
    return _RUNS["runs"]


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return shared_runs(tmp_path_factory)


def _leaf_files(d):
    d = Path(d)
    man = json.loads((d / "manifest.json").read_text())
    return man, {l["path"]: (d / f"leaf_{i:05d}.npy").read_bytes()
                 for i, l in enumerate(man["leaves"])}


def _step_dir(shared, *parts):
    return Path(shared["root"]).joinpath(*parts, "step_00000001")


def _manifest_keys(man):
    return ({k: man[k] for k in ("version", "treedef", "n_leaves", "meta")},
            man["leaves"])


# -- format parity ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_both_packages_write_the_same_checkpoint(shared, name):
    """The same state saved by both packages: equal manifests, leaf
    files equal byte for byte."""
    jman, jfiles = _leaf_files(_step_dir(shared, "jax", name))
    pman, pfiles = _leaf_files(_step_dir(shared, "port", name))
    assert _manifest_keys(pman) == _manifest_keys(jman)
    assert jman["version"] == MANIFEST_VERSION
    assert pfiles.keys() == jfiles.keys()
    for path in jfiles:
        assert pfiles[path] == jfiles[path], path


def test_hier_widens_the_optimizer_state(shared):
    """The hier config's optimizer state is wider than its parameters on
    some leaf (the widened layout the blocks subdivide)."""
    assert all(r["task"]["format"]["hier"]["widened"] > 0
               for r in shared["ranks"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_restores_jax_checkpoint(shared, name):
    """A JAX checkpoint restored in the port: every rank's shards and
    optimizer blocks equal its own (``StepBundle.shard`` /
    ``opt_shards`` of the same arrays) bit for bit, on the bundle's
    device; saved again, the files equal the JAX ones byte for byte."""
    for r in shared["ranks"]:
        f = r["task"]["format"][name]
        assert all(f["equal"]) and f["device"] == "cpu"
    jman, jfiles = _leaf_files(_step_dir(shared, "jax", name))
    pman, pfiles = _leaf_files(_step_dir(shared, "port", f"{name}_rt"))
    assert _manifest_keys(pman) == _manifest_keys(jman)
    assert pfiles == jfiles


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_restores_port_checkpoint(shared, name):
    """A port checkpoint restored by the JAX ``Checkpointer.restore``
    under ``state_shardings()``: the numpy state, bit for bit."""
    import jax
    import ml_dtypes
    from repro.checkpoint.checkpointer import Checkpointer as JCk
    model, sizes, kw = CONFIGS[name]
    b = jax_bundle(model, sizes, kw)
    sh = b.state_shardings()
    labels = [b.def_leaves[i].label for i in b.train_idx]
    shapes = [b.def_leaves[i].shape for i in b.train_idx]

    def sds(dt):
        return [jax.ShapeDtypeStruct(s, dt) for s in shapes]
    example = {"params": sds(ml_dtypes.bfloat16),
               "opt": {k: sds(np.float32) for k in ("m", "v", "master")}}
    example["opt"]["step"] = jax.ShapeDtypeStruct((), np.int32)
    got = JCk(str(_step_dir(shared, "port", name).parent)).restore(
        1, example, shardings=sh)
    g = global_state(name)
    for p, x in zip(labels, got["params"]):
        np.testing.assert_array_equal(
            np.asarray(x).view(np.uint16),
            np.asarray(g["params"][p]).astype(ml_dtypes.bfloat16)
            .view(np.uint16))
    for k in ("m", "v", "master"):
        for p, x in zip(labels, got["opt"][k]):
            np.testing.assert_array_equal(np.asarray(x), g[k][p])
    assert int(got["opt"]["step"]) == STEP
    assert got["params"][0].sharding == sh["params"][0]


# -- the carry -----------------------------------------------------------------

def _section(man_files, section):
    man, files = man_files
    return {l["path"]: _npy(files[l["path"]]) for l in man["leaves"]
            if l["section"] == section}


def _npy(raw):
    import io
    return np.load(io.BytesIO(raw))


def test_carry_signature_matches_jax():
    """``cross_step_carry_signature`` and ``mesh_meta`` equal the JAX
    package's on the same configs in bf16 (fcdp, a widened one, PEFT,
    the hier-embedding composite, tp 1). In fp32 the shapes are equal
    and the dtypes are not: the JAX signature gives the def dtype
    (bfloat16) for the fp32 carry its step computes, the port the dtype
    its carry is (ROADMAP Queue 3)."""
    from repro.core.engine.train import cross_step_carry_signature as jsig
    from repro.runtime.elastic import mesh_meta as jmeta
    from repro_torch.core.engine.train import cross_step_carry_signature
    from repro_torch.runtime.elastic import mesh_meta
    model, sizes, kw = CARRY
    bf16 = dict(kw, dtype="bfloat16")
    cases = [(model, sizes, bf16),
             (DENSE, sizes, dict(bf16, mode="hier")),
             (DENSE, sizes, dict(bf16, peft=True)),
             (DENSE, sizes, dict(bf16, mode_overrides=(("embed", "hier"),))),
             (DENSE, (2, 4, 1), bf16)]
    for model, sizes, kw in cases:
        pb = port_bundle(model, sizes, kw, CARRY_MB)
        jb = jax_bundle(model, sizes, kw, CARRY_MB)
        assert cross_step_carry_signature(pb) == jsig(jb), (sizes, kw)
        assert mesh_meta(pb) == jmeta(jb.mesh)
    pb = port_bundle(*CARRY, CARRY_MB)
    jb = jax_bundle(*CARRY, CARRY_MB)
    port, ref = cross_step_carry_signature(pb), jsig(jb)
    assert [s for s, _ in port] == [s for s, _ in ref]
    assert {d for _, d in port} == {"float32"}
    assert {d for _, d in ref} == {"bfloat16"}


def test_port_carry_matches_jax_prime(shared):
    """The port's prime carry and the JAX ``build_train_prime`` carry of
    the same parameters and batch, as the global arrays of both
    checkpoints' carry sections: the same leaves and shapes, values
    within CARRY_RTOL of each leaf's largest entry; the primes' losses
    within the step tolerance (1e-4)."""
    jc = _section(_leaf_files(_step_dir(shared, "jax", "carry")), "carry")
    pc = _section(_leaf_files(_step_dir(shared, "port", "carry")), "carry")
    assert jc.keys() == pc.keys() and len(jc) > 0
    for path, want in jc.items():
        got = pc[path]
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=CARRY_RTOL * scale, err_msg=path)
    jloss = json.loads((Path(shared["root"]) / "jax" /
                        "carry_loss.json").read_text())
    for r in shared["ranks"]:
        np.testing.assert_allclose(r["task"]["carry"]["loss"], jloss,
                                   rtol=1e-4)


def test_port_restores_jax_carry(shared):
    """The JAX checkpoint's carry (same mesh, same signature) is kept by
    the port's carry-aware restore, and saved again equals the JAX files
    byte for byte."""
    for r in shared["ranks"]:
        c = r["task"]["carry"]
        assert not c["invalidated"] and c["restored_carry"]
    _, jfiles = _leaf_files(_step_dir(shared, "jax", "carry"))
    _, pfiles = _leaf_files(_step_dir(shared, "port", "carry_rt"))
    assert pfiles == jfiles


def test_jax_restores_port_carry(shared):
    """The port's checkpoint with its carry restored by the JAX
    ``Checkpointer.restore`` under ``state_shardings(with_carry=True)``:
    the carry arrays the port saved. (The JAX ``reshard_state`` drops
    this fp32 carry, as it drops its own: its signature says bf16.)"""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCk
    from repro.runtime.elastic import reshard_state as jreshard
    model, sizes, kw = CARRY
    b = jax_bundle(model, sizes, kw, CARRY_MB)
    shapes = [b.def_leaves[i].shape for i in b.train_idx]
    sds = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
    example = {"params": sds, "opt": {"m": sds, "v": sds, "master": sds,
                                      "step": jax.ShapeDtypeStruct(
                                          (), np.int32)}}
    ck = JCk(str(_step_dir(shared, "port", "carry").parent))
    state = ck.restore(1, dict(example, carry=b.cross_step_carry_sds()),
                       shardings=b.state_shardings(with_carry=True))
    pc = _section(_leaf_files(_step_dir(shared, "port", "carry")), "carry")
    got = [np.asarray(x) for k in ("g_acc", "pending")
           for x in state["carry"][k]]
    assert len(got) == len(pc)
    for x, want in zip(got, pc.values()):
        np.testing.assert_array_equal(x, want)
    _, invalidated = jreshard(ck, 1, b, example)
    assert invalidated


# -- the checkpointer in one process (tests/test_checkpoint.py's cases) -------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": [torch.from_numpy(rng.normal(0, 1, (8, 4))
                                    .astype(np.float32)),
                   torch.from_numpy(rng.normal(0, 1, (4,))
                                    .astype(np.float32)).to(torch.bfloat16)],
        "opt": {"m": [torch.from_numpy(rng.normal(0, 1, (8, 4))
                                       .astype(np.float32))],
                "step": 7},
    }


def _leaves(tree):
    return [t for _, t in flatten_with_path(tree)[0]]


def _assert_tree_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("tree", [
    {"opt": {"m": [1], "master": [1], "step": 1, "v": [1]},
     "params": [1, 2]},
    {"a": (1, 2)}, {"a": (1,)}, {"a": []}, {"w": 1},
    {"carry": {"g_acc": [1], "pending": [1]}},
    {"b": {}, "a": [[1, 2], [3]]}, [1, {"x": 2}], (1,), {"a": None}])
def test_flatten_prints_as_jax(tree):
    """Key paths, leaf order and treedef strings equal jax.tree_util's
    (what the JAX ``_validate`` compares)."""
    from repro.compat import flatten_with_path as jflat
    from repro.checkpoint.checkpointer import _keystr as jkeystr
    jl, jtd = jflat(tree)
    pl, ptd = flatten_with_path(tree)
    assert ptd == str(jtd)
    assert [_keystr(k) for k, _ in pl] == [jkeystr(k) for k, _ in jl]
    assert [v for _, v in pl] == [v for _, v in jl]


def test_manifest_v2_schema(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(), blocking=True, meta={"note": "hello"})
    man = ck.manifest(3)
    assert man["version"] == MANIFEST_VERSION
    assert man["step"] == 3
    assert man["meta"] == {"note": "hello"}
    assert man["n_leaves"] == len(man["leaves"]) == 4
    assert [l["section"] for l in man["leaves"]] == \
        ["opt", "opt", "params", "params"]
    assert man["leaves"][1] == {"path": "['opt']['step']", "section": "opt",
                                "shape": [], "dtype": "int32"}
    assert man["leaves"][2]["path"] == "['params'][0]"
    assert man["leaves"][2]["shape"] == [8, 4]
    assert man["leaves"][3]["dtype"] == "bfloat16"


def test_single_process_files_equal_jax(tmp_path):
    """One tree (a Python-int step saved as JAX saves its int32 step)
    written by both packages: the same manifest and bytes."""
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JCk
    tree = _tree()
    jtree = {"params": [jnp.asarray(tree["params"][0].numpy()),
                        jnp.asarray(tree["params"][1].float().numpy(),
                                    jnp.bfloat16)],
             "opt": {"m": [jnp.asarray(tree["opt"]["m"][0].numpy())],
                     "step": jnp.int32(7)}}
    Checkpointer(str(tmp_path / "p")).save(1, tree, meta={"a": 1})
    JCk(str(tmp_path / "j")).save(1, jtree, meta={"a": 1})
    jman, jfiles = _leaf_files(tmp_path / "j" / "step_00000001")
    pman, pfiles = _leaf_files(tmp_path / "p" / "step_00000001")
    assert pman == jman and pfiles == jfiles


def test_roundtrip_preserves_values(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(1, tree, blocking=True)
    restored = ck.restore(1, tree, device="cpu")
    _assert_tree_equal(tree, restored)
    assert isinstance(restored["opt"]["step"], int)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_bitcast_dtypes_roundtrip_bit_exact(tmp_path, dtype):
    """bf16 and fp8 go to disk as raw bits with the logical dtype in the
    manifest: the round trip is bit-exact."""
    ck = Checkpointer(str(tmp_path))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (16, 3)).astype(np.float32)) \
        .to(getattr(torch, dtype))
    ck.save(1, {"w": x}, blocking=True)
    man = ck.manifest(1)
    assert man["leaves"][0]["dtype"] == dtype
    assert man["leaves"][0]["shape"] == [16, 3]
    r = ck.restore(1, {"w": x}, device="cpu")["w"]
    assert r.dtype == x.dtype
    width = torch.int16 if dtype == "bfloat16" else torch.uint8
    assert torch.equal(x.view(width), r.view(width))


def test_async_save_wait_and_gc(tmp_path):
    """Back-to-back async saves serialize, wait() drains the last one,
    and GC keeps ``keep`` newest."""
    ck = Checkpointer(str(tmp_path), keep=2)
    trees = {s: _tree(seed=s) for s in (1, 2, 3, 4)}
    for s, t in trees.items():
        ck.save(s, t, blocking=False)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    for s in (3, 4):
        assert ck.manifest(s)["version"] == MANIFEST_VERSION
        _assert_tree_equal(trees[s], ck.restore(s, trees[s], device="cpu"))
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The async save writes the state as it was at the call: the live
    tensors moving on (in place, as the train step does) change
    nothing."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    want = [t.clone() if torch.is_tensor(t) else t for t in _leaves(tree)]
    ck.save(1, tree, blocking=False)
    for t in _leaves(tree):
        if torch.is_tensor(t):
            t.add_(1)
    ck.wait()
    got = _leaves(ck.restore(1, tree, device="cpu"))
    for a, b in zip(want, got):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_restore_into_wrong_structure_raises_readable(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    tree["carry"] = {"g_acc": [torch.zeros((2, 8, 4))]}
    ck.save(1, tree, blocking=True)
    with pytest.raises(CheckpointError) as ei:
        ck.restore(1, _tree(), device="cpu")
    msg = str(ei.value)
    assert "['carry']['g_acc'][0]" in msg
    assert "not in the example tree" in msg
    ck.save(2, _tree(), blocking=True)
    with pytest.raises(CheckpointError) as ei:
        ck.restore(2, tree, device="cpu")
    assert "absent from the checkpoint" in str(ei.value)


def test_restore_treedef_mismatch_same_paths(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": [torch.zeros(3), torch.ones(3)]}, blocking=True)
    with pytest.raises(CheckpointError, match="treedef"):
        ck.restore(1, {"a": (torch.zeros(3), torch.ones(3))}, device="cpu")


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros((4, 4))}, blocking=True)
    with pytest.raises(CheckpointError, match="shape mismatch"):
        ck.restore(1, {"w": torch.zeros((2, 4))}, device="cpu")


def test_short_shardings_tree_raises(tmp_path):
    """One Block short of the leaves raises instead of leaving the
    trailing leaves unplaced; a full list restores each leaf's block."""
    ck = Checkpointer(str(tmp_path))
    tree = {"params": [torch.arange(32.0).reshape(8, 4),
                       torch.ones((8, 4))]}
    ck.save(1, tree, blocking=True)
    half = Block((8, 4), (slice(4, 8), slice(0, 4)))
    with pytest.raises(CheckpointError, match="shardings"):
        ck.restore(1, tree, shardings={"params": [half]}, device="cpu")
    example = {"params": [torch.empty(4, 4), torch.empty(4, 4)]}
    ok = ck.restore(1, example, shardings={"params": [half, half]},
                    device="cpu")
    assert torch.equal(ok["params"][0], tree["params"][0][4:])
    assert torch.equal(ok["params"][1], torch.ones(4, 4))


def test_block_writers_assemble_the_global_array(tmp_path):
    """Two blocks of one leaf written by a Checkpointer each (the second
    rank's write through the first's file): the global array."""
    import threading
    full = torch.arange(24.0).reshape(6, 4)
    cks = [Checkpointer(str(tmp_path), rank=r, world=2, barrier=b)
           for r, b in enumerate(_two_party_barrier(threading))]
    blocks = [Block((6, 4), (slice(3 * r, 3 * r + 3), slice(0, 4)))
              for r in range(2)]

    def save(r):
        cks[r].save(1, {"w": full[3 * r:3 * r + 3]}, blocks=[blocks[r]])
    ts = [threading.Thread(target=save, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    got = np.load(tmp_path / "step_00000001" / "leaf_00000.npy")
    np.testing.assert_array_equal(got, full.numpy())
    assert cks[0].manifest(1)["leaves"][0]["shape"] == [6, 4]
    assert sorted(p.name for p in (tmp_path / "step_00000001").iterdir()) \
        == ["leaf_00000.npy", "manifest.json"]


def _two_party_barrier(threading):
    bar = threading.Barrier(2)
    return [bar.wait, bar.wait]


def test_section_filtered_restore(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    tree["carry"] = {"g_acc": [torch.full((2, 8, 4), 3.0)]}
    ck.save(1, tree, blocking=True)
    partial = ck.restore(1, _tree(), sections=("params", "opt"),
                         device="cpu")
    assert set(partial) == {"params", "opt"}
    assert torch.equal(partial["params"][0], tree["params"][0])
    with pytest.raises(CheckpointError, match="sections"):
        ck.restore(1, {"params": _tree()["params"]},
                   sections=("params", "opt"), device="cpu")


def test_v1_manifest_back_compat(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(1, tree, blocking=True)
    mpath = tmp_path / "step_00000001" / "manifest.json"
    man = json.loads(mpath.read_text())
    v1 = {"step": man["step"], "treedef": man["treedef"],
          "n_leaves": man["n_leaves"],
          "leaves": [{"shape": l["shape"], "dtype": l["dtype"]}
                     for l in man["leaves"]]}
    mpath.write_text(json.dumps(v1))
    _assert_tree_equal(tree, ck.restore(1, tree, device="cpu"))
    with pytest.raises(CheckpointError, match="refusing"):
        ck.restore(1, {"params": tree["params"]}, device="cpu")
    wrong = {"params": [torch.zeros(3, 3)] * 2,
             "opt": {"m": [torch.zeros(3, 3)], "step": torch.zeros(3, 3)}}
    with pytest.raises(CheckpointError, match="shape mismatch"):
        ck.restore(1, wrong, device="cpu")
    with pytest.raises(CheckpointError, match="manifest v2"):
        ck.restore(1, tree, sections=("params",), device="cpu")


def test_restore_accepts_meta_example(tmp_path):
    """Example leaves may be meta tensors (the restart driver builds the
    carry example from the bundle's carry layout)."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    ck.save(1, tree, blocking=True)
    out = ck.restore(1, {"w": torch.empty((2, 3), device="meta")},
                     device="cpu")
    assert torch.equal(out["w"], tree["w"])


def test_restore_defaults_to_cuda(tmp_path):
    """Without a bundle or a device the restore runs on cuda, and
    raises on a machine without one."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(2)}, blocking=True)
    if torch.cuda.is_available():
        assert ck.restore(1, {"w": torch.zeros(2)})["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.restore(1, {"w": torch.zeros(2)})
