"""Training of the moe, ssm and hybrid families in the port against the
JAX package's, on the CPU.

The models are ``tests/test_composite.py``'s t-moe (2 layers of
attention + a 4-expert top-2 MoE) and ``tests/test_system.py``'s t-rwkv
(2 RWKV-6 layers) and t-jamba (2 periods of (attention, MLP), (Mamba,
MoE)), all at d_model 64, on the ``CELL`` batch (seq 64, batch 8) with
``min_shard_size=8``. Both packages start from the same weights, drawn
with the port's initializer from seed 0 (``_init_tree``; the port's
ranks draw them alike, one job a mesh taking every family's model in
turn, ``ModeRun.model``).

Step tests: zero3 and fcdp at (pod 2, data 2, model 1) and (2, 2, 2) in
fp32, one step, held to the JAX step at ``tests/test_system.py``'s
tolerances (loss rtol 1e-4, grad norm 1e-3, updated parameters rtol
2e-2 / atol 2e-3), the aux loss at rtol 1e-4; every (op, axis) byte
count of the step equal to the JAX trace, the expert-parallel
``all_to_all/model`` included. One difference is pinned: the JAX
save_all policy recomputes the channel-mix's 'model' reduce-scatter in
its backward (it lists the primitive as "psum_scatter", which jax 0.9
calls "reduce_scatter"), so the JAX trace carries twice the port's
``psum_scatter/model`` on t-rwkv at tp 2.

The mixed per-tensor layout (``MIXED_RULES``: the experts on mics, the
embedding on hier) equals the port's all-fcdp step at the golden's
tolerances, the reference's own criterion
(``tests/test_composite.py::test_mixed_moe_golden``, which the JAX
mixed step fails on jax 0.9 through hier's double 'pod' sum); its bytes
equal the JAX mixed trace's but that pinned ``psum/pod``.
``moe_weight_resident`` makes the experts 'inter_only' (stored over
'pod' only), with the JAX trace's bytes but the pinned ``psum/data``
(the reference sums a widened leaf's gradient over its widening axis
twice, as for hier) and the non-resident step's loss. The losses of all three families fall over 4 fcdp steps at
(2, 2, 2) (``tests/test_system.py::test_loss_decreases_all_families``),
and a crash at step 1 under the restart driver resumes bit for bit.

``convert.shards_from_jax`` carries each family's tree in the JAX
layout into every rank's shards at tp 1 and tp 2 and back, bit for bit.
The JAX steps run in a subprocess with XLA's excess precision off and
the "jnp" impls (as ``tests/test_torch_tp.py``), while the port's ranks
run (gloo, one spawn a mesh), once per session
(``shared_result``). In process: the Mamba scan's Function
(``ops.mamba_scan_train``) passes ``gradcheck`` in fp64 and, through
``_mamba_core``, gives JAX's gradient of the JAX core, and the train
launcher takes two steps of rwkv6-3b's and jamba-v0.1-52b's smoke
models on one CPU rank.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (MambaConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      RWKVConfig, ShapeCell, SystemConfig)
from repro_torch.core.partition import init_params, tree_items
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn
from repro_torch.models.lm import LM
from test_torch_train import assemble, shared_result

MODELS = {
    "moe": dict(name="t-moe", family="moe", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256,
                moe=dict(num_experts=4, top_k=2, d_ff_expert=64)),
    "ssm": dict(name="t-rwkv", family="ssm", num_layers=2, d_model=64,
                num_heads=0, num_kv_heads=0, d_ff=128, vocab_size=256,
                rwkv=dict(head_dim=16, decay_lora=8)),
    "hybrid": dict(name="t-jamba", family="hybrid", num_layers=4,
                   d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=256, mamba=dict(d_state=8, dt_rank=8),
                   moe=dict(num_experts=4, top_k=2, d_ff_expert=128,
                            moe_period=2, moe_offset=1),
                   hybrid_period=2, hybrid_attn_positions=(0,)),
}
FAMILIES = tuple(MODELS)
SEQ, BATCH = 64, 8
AXES = ("pod", "data", "model")
MESHES = {1: (2, 2, 1), 2: (2, 2, 2)}
F32 = "float32"
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
MIXED_RULES = (("blocks.*.moe.we_*", "mics"), ("embed", "hier"))
FALL_STEPS = 4
LOSS_RTOL, GNORM_RTOL, AUX_RTOL = 1e-4, 1e-3, 1e-4
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
STEP_IDS = [f"{fam}_{mode}_tp{tp}" for fam in FAMILIES
            for tp in MESHES for mode in ("zero3", "fcdp")]
# the reference's recomputed reduce-scatter (module note)
PINNED_RS = {"ssm_zero3_tp2", "ssm_fcdp_tp2"}
# the recomputing activation policies, fcdp at tp 2
POLICIES = ("block_io", "save_collectives")
POLICY_IDS = [f"{fam}_{pol}" for fam in FAMILIES for pol in POLICIES]


def _runs(tp, ckpt_dir):
    """The port's runs at tp, every family's, by id: each family's model
    drawn from seed 0 on the CPU (``ModeRun.model``)."""
    runs = {}
    for fam in FAMILIES:
        one = dict(dtype=F32, model=_model(fam, PORT_NS))
        runs[f"{fam}_zero3_tp{tp}"] = ModeRun("zero3", **one)
        runs[f"{fam}_fcdp_tp{tp}"] = ModeRun(
            "fcdp", steps=FALL_STEPS if tp == 2 else 1, **one)
        if tp == 2 and fam == "moe":
            runs["mixed"] = ModeRun("fcdp", mode_overrides=MIXED_RULES,
                                    **one)
            runs["resident"] = ModeRun("fcdp", moe_weight_resident=True,
                                       **one)
        if tp == 2:
            for pol in POLICIES:
                runs[f"{fam}_{pol}"] = ModeRun("fcdp", activation_policy=pol,
                                               **one)
        if tp == 2 and fam != "moe":
            runs[f"{fam}_restart"] = ModeRun(
                "fcdp", steps=2, ckpt_dir=os.path.join(ckpt_dir, fam),
                ckpt_every=1, fail_at=(1,), **one)
    return runs


def _model(fam, ns):
    """The family's ModelConfig built from ``ns``'s classes (the port's
    or the JAX package's)."""
    kw = dict(MODELS[fam])
    for key, cls in (("moe", "MoEConfig"), ("mamba", "MambaConfig"),
                     ("rwkv", "RWKVConfig")):
        if key in kw:
            kw[key] = ns[cls](**kw[key])
    return ns["ModelConfig"](**kw)


PORT_NS = dict(ModelConfig=ModelConfig, MoEConfig=MoEConfig,
               MambaConfig=MambaConfig, RWKVConfig=RWKVConfig)


def make_batch(seed=0):
    """``tests/test_system.py:make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


def _init_tree(fam):
    """The family's full parameters as a nested dict of fp32 numpy
    arrays, drawn by the port's initializer from seed 0 (the shapes do
    not depend on tp here: nothing is padded at tp 2)."""
    defs = LM(_model(fam, PORT_NS), SystemConfig(), 2).defs
    flat = init_params(defs, 0, torch.device("cpu"), torch.float32)
    out: dict = {}
    for path, t in tree_items(flat):
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.numpy()
    return out


# -- the JAX reference (run in a subprocess) -------------------------------

def _jax_ns():
    from repro.configs import base
    return {k: getattr(base, k) for k in PORT_NS}


def _jax_run(fam, tp, mode, init, batch, execute=True, **sys_kw):
    """The JAX step of one run from ``init``: the bytes per (op, axis),
    traced; with ``execute`` the first step's metrics and updated
    trainable parameters."""
    import functools

    import jax
    from jax.sharding import NamedSharding
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.base import SystemConfig as JSystemConfig
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    sysc = JSystemConfig(mode=mode, min_shard_size=8, quant_impl="jnp",
                         param_dtype=F32, compute_dtype=F32,
                         fused_impl="jnp", **sys_kw)
    run = JRunConfig(model=_model(fam, _jax_ns()),
                     shape=JShapeCell("t", "train", SEQ, BATCH), system=sysc,
                     optimizer=JOptimizerConfig(**OPT))
    b = JStepBundle(run, make_mesh(MESHES[tp], AXES))
    src = b.treedef.flatten_up_to(init)
    tp_, fp = b.split([jax.device_put(np.asarray(a, np.float32),
                                      NamedSharding(b.mesh, spec))
                       for a, spec in zip(src, b.leaf_specs)])
    ost = jax.jit(functools.partial(init_opt_state, sys=b.run.system))(tp_)
    step = b.make_train_step()
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    stats = collect_collectives(step.trace(tp_, fp, ost, jb).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    out = {"bytes": {k: v for k, v in stats.by_op_axis.items() if v}}
    if execute:
        tp_, ost, m = step(tp_, fp, ost, jb)
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["params"] = {b.def_leaves[i].label: np.asarray(x, np.float32)
                         for i, x in zip(b.train_idx, tp_)}
    return out


def _reference(init_path, fam, tp):
    """A share of the JAX results of one family the tests read: the
    step runs at ``tp``, executed; with tp 1 also the recomputing
    policies at tp 2, and with tp 2 for the MoE the mixed and the
    resident layouts, traced."""
    with open(init_path, "rb") as f:
        init = pickle.load(f)[fam]
    batch = make_batch()
    out = {}
    for mode in ("zero3", "fcdp"):
        out[f"{fam}_{mode}_tp{tp}"] = _jax_run(fam, tp, mode, init, batch)
    if tp == 1:             # tp 2's traces, in the process with less to do
        for pol in POLICIES:
            out[f"{fam}_{pol}"] = _jax_run(fam, 2, "fcdp", init, batch,
                                           execute=False,
                                           activation_policy=pol)
    if fam == "moe" and tp == 2:
        out["mixed"] = _jax_run(fam, 2, "fcdp", init, batch, execute=False,
                                mode_overrides=MIXED_RULES)
        out["resident"] = _jax_run(fam, 2, "fcdp", init, batch,
                                   execute=False, moe_weight_resident=True)
    return out


def _start_reference(tmp, init_path, fam, tp):
    """Start ``_reference(init_path, fam, tp)`` in a fresh interpreter
    with eight CPU devices and XLA's excess precision off; returns the
    process and the file its result goes to. One a family and tp, side
    by side: compiling a step is most of the cost."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"families_reference_{fam}_{tp}.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_families as t; pickle.dump("
            "t._reference(sys.argv[1], sys.argv[2], int(sys.argv[3])), "
            "open(sys.argv[4], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, init_path, fam,
                             str(tp), out],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish_reference(proc, out):
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{err[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


# -- the port --------------------------------------------------------------

def _compute(tmp_path_factory):
    """The JAX reference in its own processes while the port's ranks run
    from the same weights: one spawn per mesh, every family's runs in
    turn."""
    tmp = str(tmp_path_factory.mktemp("families"))
    init_path = os.path.join(tmp, "inits.pickle")
    with open(init_path, "wb") as f:
        pickle.dump({fam: _init_tree(fam) for fam in FAMILIES}, f)
    procs = [_start_reference(tmp, init_path, fam, tp)
             for fam in FAMILIES for tp in MESHES]
    port = {}
    try:
        for tp, mesh in MESHES.items():
            runs = _runs(tp, tmp)
            job = TrainJob(
                run=RunConfig(model=_model("moe", PORT_NS),
                              shape=ShapeCell("t", "train", SEQ, BATCH),
                              system=SystemConfig(min_shard_size=8),
                              optimizer=OptimizerConfig(**OPT)),
                mesh=MeshShape(AXES, mesh), runs=list(runs.values()),
                device="cpu", seed=0, batches=[make_batch()] * FALL_STEPS,
                return_params=True)
            ranks = spawn(job, tmp, timeout_s=900)
            for i, rid in enumerate(runs):
                port[rid] = [rk["runs"][i] for rk in ranks]
    except BaseException:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise
    ref = {}
    for proc, path in procs:
        ref.update(_finish_reference(proc, path))
    return {"ref": ref, "port": port}


@pytest.fixture(scope="module")
def fam_runs(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_families_runs",
                         lambda: _compute(tmp_path_factory))


def _port_params(ranks, tp):
    specs = ranks[0]["specs"]
    mesh = MeshShape(AXES, MESHES[tp])
    return {path: assemble({r: torch.from_numpy(res["params"][path])
                            for r, res in enumerate(ranks)},
                           specs[path], mesh).numpy()
            for path in specs}


@pytest.mark.parametrize("rid", STEP_IDS)
def test_step_matches_jax(fam_runs, rid):
    """The first step from the same weights and batch: loss, aux loss,
    grad norm and the updated parameters, every rank alike."""
    ref, ranks = fam_runs["ref"][rid], fam_runs["port"][rid]
    m, mj = ranks[0]["metrics"][0], ref["metrics"]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(m["aux_loss"], mj["aux_loss"], rtol=AUX_RTOL)
    assert (m["aux_loss"] > 0) == (not rid.startswith("ssm"))
    assert m["tokens"] == mj["tokens"] == BATCH * SEQ
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _port_params(ranks, int(rid[-1]))
    assert set(params) == set(ref["params"])
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{rid} {path}")


@pytest.mark.parametrize("rid", STEP_IDS)
def test_bytes_match_jax(fam_runs, rid):
    """Every (op, axis) byte count of the step equals the JAX trace on
    every rank; at tp 2 the MoE moves its dispatch over 'model' (4
    all-to-alls a layer: 2 forward, 2 backward), and t-rwkv's pinned
    reduce-scatter (module note) is half the reference's."""
    want = dict(fam_runs["ref"][rid]["bytes"])
    if rid in PINNED_RS:
        assert want["psum_scatter/model"] % 2 == 0
        want["psum_scatter/model"] //= 2
    for rank, r in enumerate(fam_runs["port"][rid]):
        assert r["bytes"][0] == want, (rid, rank)
    a2a = want.get("all_to_all/model", 0)
    if rid.endswith("tp2") and not rid.startswith("ssm"):
        # two MoE layers, each [4, 40, 64] fp32 buffers a dispatch
        assert a2a == 2 * 4 * 4 * 40 * 64 * 4 // 2
    else:
        assert a2a == 0


@pytest.mark.parametrize("rid", POLICY_IDS)
def test_recomputing_policies_match_jax_bytes(fam_runs, rid):
    """fcdp at tp 2 under block_io (the layer recomputed in its
    backward) and save_collectives (its 'model' collectives' outputs
    kept, the MoE's ``all_to_all``s and Mamba's x_proj sum included):
    every (op, axis) byte count equals the JAX trace, and the step is
    the save_all step's (the same math)."""
    fam = rid.split("_")[0]
    base = fam_runs["port"][f"{fam}_fcdp_tp2"][0]["metrics"][0]
    for rank, r in enumerate(fam_runs["port"][rid]):
        assert r["bytes"][0] == fam_runs["ref"][rid]["bytes"], (rid, rank)
        m = r["metrics"][0]
        np.testing.assert_allclose(m["loss"], base["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], base["grad_norm"],
                                   rtol=GNORM_RTOL)
        np.testing.assert_allclose(m["aux_loss"], base["aux_loss"],
                                   rtol=AUX_RTOL)


def test_losses_fall_over_four_steps(fam_runs):
    """``tests/test_system.py::test_loss_decreases_all_families`` for the
    moe, ssm and hybrid families: fcdp at (2, 2, 2), 4 steps on one
    batch, finite and falling."""
    for fam in FAMILIES:
        losses = [m["loss"] for m in
                  fam_runs["port"][f"{fam}_fcdp_tp2"][0]["metrics"]]
        assert len(losses) == FALL_STEPS and np.isfinite(losses).all()
        assert losses[-1] < losses[0], (fam, losses)


def test_mixed_layout_equals_all_fcdp(fam_runs):
    """The experts on mics and the embedding on hier: the step equals
    all-fcdp at the golden's tolerances, and its bytes equal the JAX
    mixed trace's but ``psum/pod``, where the reference sums the hier
    embedding's gradient over 'pod' twice (``ROADMAP.md`` Queue 3)."""
    mixed, fcdp = fam_runs["port"]["mixed"], fam_runs["port"]["moe_fcdp_tp2"]
    m, mf = mixed[0]["metrics"][0], fcdp[0]["metrics"][0]
    np.testing.assert_allclose(m["loss"], mf["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], mf["grad_norm"],
                               rtol=GNORM_RTOL)
    got, want = _port_params(mixed, 2), _port_params(fcdp, 2)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, **PARAM_TOL, err_msg=path)
    specs = mixed[0]["specs"]
    assert specs["blocks.pos0.moe.we_in"][2] == "data"      # mics
    ref = dict(fam_runs["ref"]["mixed"]["bytes"])
    ref_pod = ref.pop("psum/pod")
    for r in mixed:
        b = dict(r["bytes"][0])
        assert b.pop("psum/pod") < ref_pod
        assert b == ref


def test_weight_resident_experts_are_inter_only(fam_runs):
    """``moe_weight_resident``: the experts are stored over 'pod' only
    (each pod's shard resident), their optimizer state widened over
    'data'; the bytes equal the JAX trace but ``psum/data`` (the loss
    terms' 16 B against the reference's double sum), and the first
    step's loss is the non-resident step's."""
    res, base = fam_runs["port"]["resident"], fam_runs["port"]["moe_fcdp_tp2"]
    specs = res[0]["specs"]
    for n in ("we_in", "we_gate"):
        assert specs[f"blocks.pos0.moe.{n}"] == (None, "model", "pod", None)
    assert specs["blocks.pos0.moe.we_out"] == (None, "model", None, "pod")
    assert specs["blocks.pos0.moe.router"] != (None, "pod", None)
    assert set(res[0]["widened"]) == {f"blocks.pos0.moe.{n}" for n in
                                      ("we_in", "we_gate", "we_out")}
    assert res[0]["metrics"][0]["loss"] == base[0]["metrics"][0]["loss"]
    np.testing.assert_allclose(res[0]["metrics"][0]["grad_norm"],
                               base[0]["metrics"][0]["grad_norm"],
                               rtol=GNORM_RTOL)
    ref = dict(fam_runs["ref"]["resident"]["bytes"])
    ref_data = ref.pop("psum/data")
    for r in res:
        b = dict(r["bytes"][0])
        # the loss terms' sum alone: the reference sums the widened
        # experts' gradients over 'data' once more (ROADMAP.md Queue 3)
        assert b.pop("psum/data") == 16 < ref_data
        assert b == ref


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_restart_resumes_bit_for_bit(fam_runs, fam):
    """Under the checkpoint/restart driver, a failure injected at step 1
    restores the step-1 checkpoint and replays it: both steps' losses
    and the final shards equal the uninterrupted run's."""
    ranks = fam_runs["port"][f"{fam}_restart"]
    clean = fam_runs["port"][f"{fam}_fcdp_tp2"]
    for r in ranks:
        assert r["restart"]["restarts"] == 1
        assert [r["restart"]["losses"][s] for s in range(2)] == [
            m["loss"] for m in clean[0]["metrics"][:2]]


@pytest.mark.parametrize("tp", list(MESHES))
@pytest.mark.parametrize("fam", FAMILIES)
def test_convert_carries_the_jax_tree(fam, tp):
    """``convert.shards_from_jax`` cuts a family's tree in the JAX
    package's layout (the nested dict the JAX bundle's treedef flattens,
    which the reference steps above consume) into every rank's shards at
    (2, 2, tp); put back together they are the tree, bit for bit."""
    from types import SimpleNamespace

    from repro_torch.convert import shards_from_jax
    from repro_torch.core.engine import StepBundle
    tree = _init_tree(fam)
    ms = MeshShape(AXES, MESHES[tp])
    run = RunConfig(model=_model(fam, PORT_NS),
                    shape=ShapeCell("t", "train", SEQ, BATCH),
                    system=SystemConfig(min_shard_size=8, dtype=F32))
    shards = {}
    for rank in range(ms.world):
        b = StepBundle(run, device="cpu", mesh=SimpleNamespace(
            mesh_shape=ms, coords=ms.coords(rank)))
        shards[rank] = dict(tree_items(shards_from_jax(tree, b)))
    want = dict(tree_items(tree))
    assert set(b.paths) == set(want)
    for path, spec in zip(b.paths, b.leaf_specs):
        full = assemble({r: sh[path].detach() for r, sh in shards.items()},
                        spec, ms)
        np.testing.assert_array_equal(full.numpy(), want[path], path)


# -- the scan's Function, in process ---------------------------------------

def test_mamba_scan_train_gradcheck():
    """The adjoint scan is the scan's gradient: ``gradcheck`` in fp64 on
    the plain path, with and without a carried initial state."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    a = (0.05 + 0.9 * torch.rand(2, 9, 6, generator=gen,
                                 dtype=torch.float64)).requires_grad_()
    b = torch.randn(2, 9, 6, generator=gen,
                    dtype=torch.float64).requires_grad_()
    h0 = torch.randn(2, 6, generator=gen, dtype=torch.float64
                     ).requires_grad_()
    assert torch.autograd.gradcheck(ops.mamba_scan_train, (a, b, h0))
    assert torch.autograd.gradcheck(
        lambda x, y: ops.mamba_scan_train(x, y, None), (a, b))


def test_mamba_core_gradient_matches_jax():
    """Through ``_mamba_core`` (the scan's Function inside), the
    gradient of a weighted sum of its output with respect to the input
    and every weight equals JAX's ``jax.grad`` of the JAX core (a
    one-device mesh), fp32, at jamba-smoke's width."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.launch.mesh import make_mesh
    from repro.models import sublayers as jsl
    from repro.models.common import MeshInfo
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import sublayers
    cfg = get_smoke_config("jamba-v0.1-52b")
    jcfg = j_smoke("jamba-v0.1-52b")
    defs = sublayers.mamba_defs(cfg)
    rng = np.random.default_rng(3)
    p = {n: (rng.normal(0, 0.3, d.shape) + (1.0 if d.init == "ones"
                                            else 0.0)).astype(np.float32)
         for n, d in defs.items() if n not in ("norm", "in_proj",
                                                "out_proj")}
    d_in = cfg.mamba.expand * cfg.d_model
    xz = rng.normal(0, 1, (2, 24, 2 * d_in)).astype(np.float32)
    wy = rng.normal(0, 1, (2, 24, d_in)).astype(np.float32)
    names = sorted(p)
    mesh = make_mesh((1, 1, 1), AXES, devices=jax.devices()[:1])
    mi = MeshInfo.from_mesh(mesh)

    def loss(xz_, *w):
        y, _ = jsl._mamba_core(jcfg, mi, dict(zip(names, w)), xz_)
        return jnp.sum(y * wy)
    grad = shard_map(jax.grad(loss, argnums=tuple(range(len(names) + 1))),
                     mesh=mesh, in_specs=(P(),) * (len(names) + 1),
                     out_specs=(P(),) * (len(names) + 1), check_vma=False)
    want = [np.asarray(g) for g in jax.jit(grad)(
        jnp.asarray(xz), *(jnp.asarray(p[n]) for n in names))]
    tx = torch.from_numpy(xz).requires_grad_()
    tw = {n: torch.from_numpy(p[n]).requires_grad_() for n in names}
    y, _ = sublayers._mamba_core(cfg, tw, tx, train=True)
    (y * torch.from_numpy(wy)).sum().backward()
    got = [tx.grad.numpy()] + [tw[n].grad.numpy() for n in names]
    for name, g, w in zip(["xz"] + names, got, want):
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(g - w).max() / scale < 1e-4, name


# -- the launcher ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_launcher_trains_the_family_smoke(monkeypatch, tmp_path, arch):
    """``python -m repro_torch.launch.train --arch <arch> --smoke
    --device cpu`` takes two steps on one rank (torchrun's environment),
    with a checkpoint a step."""
    import socket

    from repro_torch.launch import train as launcher
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    res = launcher.main(["--arch", arch, "--smoke", "--steps", "2",
                         "--batch", "2", "--seq-len", "32", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    r = res["runs"][0]
    assert len(r["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    assert (r["metrics"][0]["aux_loss"] > 0) == (arch != "rwkv6-3b")
    assert r["restart"]["ckpt_steps"][-1] == 2
