"""The port's scheduler streams 2 and 3 (``core/schedule.py``,
``core/engine/train.py``) against the JAX package's, on the CPU, at
(pod 2, data 2, model 2).

Both packages train ``tests/test_schedule.py``'s ``DENSE`` model (3
layers, d_model 64, GQA 4/2, d_ff 128, vocab 256, qkv bias) on its batch
(seq 64, batch 8) with ``min_shard_size=8`` and microbatch 2, the JAX
step on eight CPU devices, the port on eight gloo ranks from the JAX
bundle's parameters. Each row of ``ROWS`` runs sequentially and with
``async_grad_reduce`` in bf16 (the JAX package's default parameter
type, the def dtype the analytic byte counts use, so the carry's
measured bytes can equal them), and the runs held to the JAX steps
again in fp32 (in bf16 the two packages' roundings part by more than
the loss tolerance under PEFT and after two updates):

  * every (op, axis) byte count of either run equals the JAX trace, and
    the 'pod' bytes equal the table of ``POD_BYTES``, but for the pinned
    double sums of hier and of the hier-embedding composite (``PINNED``,
    the reference's fault that ``tests/test_torch_sched.py`` pins);
  * the first step's loss and grad norm equal the JAX step's at loss
    rtol 1e-4 and grad norm 1e-3, the parameters at rtol 2e-2 / atol
    2e-3 (``tests/test_schedule.py:175-186``); hier and the composite
    are held to the port's zero3 and fcdp and the JAX zero3 and fcdp;
  * async against sequential in the port: the same bytes but zero3's
    'pod' all-gather, which falls to fcdp's (the backward regathers
    nothing), and the same bits; int8 (qwZ/qgZ) within 5e-2
    (``tests/test_quant.py:227-238``), the trio called as
    ``int8_launch_plan`` says (once per leaf); ag_matmul calling the
    chunk matmul as its plan says; depth 2 bit-equal to depth 0 with
    live depth 0 and no ring bytes; mics and hier declining the flag.

Stream 3: fcdp and the hier-embedding composite over 3 batches (prime,
2 piped, flush) against the port's fused async step: losses, the
shifted grad norms and the final shards bit for bit, a piped call's
bytes equal to a fused step's, prime and flush together one fused step,
the carry's measured bytes equal to ``cross_step_buffer_bytes``; fcdp's
losses and final parameters against the JAX fused async step, and the
prime's loss against JAX's ``build_train_prime`` (the reference's piped
and flush steps fail ``shard_map``'s replication check on this JAX, so
they are not run). The analytic functions and gates equal the JAX
ones, leaf for leaf, and the validation errors match the reference's.

The JAX steps run in a subprocess with XLA's excess precision off, as
``tests/test_torch_sched.py`` runs them; the port's ranks run once per
session behind ``shared_result``'s file lock.
"""
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn

DENSE = dict(name="t-dense", family="dense", num_layers=3, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
SEQ, BATCH, NM = 64, 8, 2
AXES = ("pod", "data", "model")
MESH3 = MeshShape(AXES, (2, 2, 2))
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
INT8_DRIFT = 5e-2            # tests/test_quant.py:227-238
INT8 = "int8_pod"
EMBED_HIER = (("embed", "hier"),)
XSTEPS = 3                   # batches of the cross-step runs

ROWS = {
    "zero3": dict(mode="zero3"),
    "zeropp": dict(mode="zeropp"),
    "fcdp": dict(mode="fcdp"),
    "fcdp_q8": dict(mode="fcdp", param_compress=INT8, grad_compress=INT8),
    "fcdp_ag": dict(mode="fcdp", fused_matmul="ag_matmul"),
    "fcdp_d2": dict(mode="fcdp", prefetch_depth=2),
    "mics": dict(mode="mics"),
    "hier": dict(mode="hier"),
    "zero3_peft": dict(mode="zero3", peft=True),
    "fcdp_peft": dict(mode="fcdp", peft=True),
    "fcdp_embed_hier": dict(mode="fcdp", mode_overrides=EMBED_HIER),
}
DECLINE = ("mics", "hier")


def _mr(row, on, steps=1, xstep=False, dtype="bfloat16"):
    return ModeRun(**ROWS[row], microbatch=NM, steps=steps, dtype=dtype,
                   async_grad_reduce=on, cross_step_pipeline=xstep)


RUNS = {f"{row}_{v}": _mr(row, v == "async")
        for row in ROWS for v in ("seq", "async")}
# stream 3 and the fused async step it is held to, over XSTEPS batches
XROWS = ("fcdp", "fcdp_embed_hier")
for _row in XROWS:
    RUNS[f"{_row}_fused3"] = _mr(_row, True, XSTEPS)
    RUNS[f"{_row}_xstep"] = _mr(_row, True, XSTEPS, xstep=True)
# held to the JAX steps in fp32: the two packages' bf16 roundings part
# by more than the step tolerances after an update (and in the LoRA
# forward); the bf16 runs above hold the bytes and the bits
F32 = "float32"
for _row in ("zero3", "zeropp", "fcdp_q8", "fcdp_ag", "hier", "zero3_peft",
             "fcdp_peft", "fcdp_embed_hier"):
    RUNS[f"{_row}_async_f32"] = _mr(_row, True, dtype=F32)
RUNS["fcdp_fused3_f32"] = _mr("fcdp", True, XSTEPS, dtype=F32)
RUNS["fcdp_xstep_f32"] = _mr("fcdp", True, XSTEPS, xstep=True, dtype=F32)

# the 'pod' bytes a rank-step of the JAX trace at microbatch 2 (jax
# 0.9.0): (all_gather, psum_scatter, psum), sequential and async
POD_BYTES = {
    "zero3_seq": (140096, 78272, 585), "zero3_async": (78272, 78272, 585),
    "fcdp_q8_seq": (39968, 448, 585), "fcdp_q8_async": (39968, 448, 585),
    "mics_seq": (0, 0, 315465), "mics_async": (0, 0, 315465),
    "zero3_peft_seq": (152384, 6144, 6153),
    "zero3_peft_async": (84416, 6144, 6153),
    "fcdp_peft_seq": (6144, 6144, 6153), "fcdp_peft_async": (6144, 6144, 6153),
}
for _row in ("zeropp", "fcdp", "fcdp_ag", "fcdp_d2"):
    for _v in ("seq", "async"):
        POD_BYTES[f"{_row}_{_v}"] = (78272, 78272, 585)
# the analytic (async, carry) buffers of the JAX bundles, whatever the
# flag (None: not compared)
BUFFERS = {"zero3_peft": (90560, 21504), "fcdp_peft": (12288, 21504),
           "mics": (0, None), "hier": (0, None),
           "fcdp_embed_hier": (140160, 122656)}
for _row in ("zero3", "zeropp", "fcdp", "fcdp_q8", "fcdp_ag", "fcdp_d2"):
    BUFFERS[_row] = (156544, 118560)

# the pinned divergences: (row, op/axis) -> (JAX bytes, port bytes); the
# reference sums hier's widened gradients over 'pod' twice (ROADMAP
# Queue 3)
PINNED = {("hier", "psum/pod"): (315465, 585),
          ("fcdp_embed_hier", "psum/pod"): (33353, 585)}


def _row(rid):
    """The row of ``ROWS`` a run id belongs to."""
    for suffix in ("_f32", "_seq", "_async", "_fused3", "_xstep"):
        rid = rid.removesuffix(suffix)
    return rid


def make_batch(seed=0):
    """``tests/test_schedule.py:make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


# -- the JAX reference (run in a subprocess) -------------------------------

def _jax_bundle(mr):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.base import SystemConfig as JSystemConfig
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    sysc = JSystemConfig(
        mode=mr.mode, min_shard_size=8, param_compress=mr.param_compress,
        grad_compress=mr.grad_compress, quant_impl="jnp",
        fused_matmul=mr.fused_matmul, fused_impl="jnp",
        prefetch_depth=mr.prefetch_depth, peft=mr.peft,
        lora_rank=mr.lora_rank, mode_overrides=mr.mode_overrides,
        async_grad_reduce=mr.async_grad_reduce,
        cross_step_pipeline=mr.cross_step_pipeline,
        param_dtype=mr.dtype, compute_dtype=mr.dtype)
    run = JRunConfig(model=JModelConfig(**DENSE),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=sysc, optimizer=JOptimizerConfig(**OPT),
                     microbatch=mr.microbatch)
    return JStepBundle(run, make_mesh((2, 2, 2), AXES))


def _analytic(sched, strategy, defs, plans, mesh, run):
    """Either package's analytic buffers and gates (``sched``: its
    ``core.schedule`` module), in total, per group and per leaf."""
    args = (strategy, defs, plans, mesh)
    return {"async_live": sched.async_reduce_enabled(run, strategy, mesh),
            "xstep_live": sched.cross_step_enabled(run, strategy, mesh),
            "async_bytes": sched.async_buffer_bytes(*args),
            "async_by_group": sched.async_buffer_bytes_by_group(*args),
            "carry_bytes": sched.cross_step_buffer_bytes(*args),
            "carry_by_group": sched.cross_step_buffer_bytes_by_group(*args),
            "per_leaf": {d.label: (
                sched.async_buffer_bytes(strategy, [d], [p], mesh),
                sched.cross_step_buffer_bytes(strategy, [d], [p], mesh))
                for d, p in zip(defs, plans)}}


def _jax_analytic(b):
    from repro.core import schedule as js
    return _analytic(js, b.strategy, b.def_leaves, b.plan_leaves, b.mi,
                     b.run)


def _jax_run(mr, batches, steps):
    """The bytes per (op, axis) of the step, traced on its arrays, the
    analytic buffers and gates, and, with ``steps``, the metrics of that
    many batches of the fused step and the trainable parameters after
    them."""
    import functools

    import jax
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    b = _jax_bundle(mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    tp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in tp]
    fp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in fp]
    ost = jax.jit(functools.partial(init_opt_state, sys=b.run.system))(tp)
    out = _jax_analytic(b)
    if mr.cross_step_pipeline:
        # the prime only: piped and flush fail shard_map's replication
        # check on this JAX
        _, m = b.make_train_prime()(tp, fp, ost, batches[0])
        out["prime_loss"] = float(m["loss"])
        return out
    step = b.make_train_step()
    stats = collect_collectives(step.trace(tp, fp, ost, batches[0]).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    out["bytes"] = {k: v for k, v in stats.by_op_axis.items() if v}
    if steps:
        out["metrics"] = []
        for batch in batches[:steps]:
            tp, ost, m = step(tp, fp, ost, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"] = {b.def_leaves[i].label: np.asarray(x, np.float32)
                         for i, x in zip(b.train_idx, tp)}
    return out


def _jax_init(peft):
    import jax
    b = _jax_bundle(_mr("fcdp_peft" if peft else "fcdp", False))
    return jax.tree.unflatten(b.treedef, [np.asarray(x) for x in
                                          b.init_all_params(seed=0)])


# the JAX runs: every bf16 sequential and async row traced (bytes); the
# fp32 runs executed, that many batches, where the port's are held to
# them; fcdp's prime in fp32
JAX_STEPS = {"zero3_async_f32": 1, "zeropp_async_f32": 1,
             "fcdp_q8_async_f32": 1, "fcdp_ag_async_f32": 1,
             "zero3_peft_async_f32": 1, "fcdp_peft_async_f32": 1,
             "fcdp_fused3_f32": XSTEPS}
JAX_RUNS = [rid for rid in RUNS if rid.endswith(("_seq", "_async"))] \
    + sorted(JAX_STEPS) + ["fcdp_xstep_f32"]
PARTS = 2                    # reference processes


def _reference(part, init_path=None):
    """Part ``part`` of the JAX runs (every PARTS-th, the executed ones
    spread first); part 0 first writes the initial parameter trees to
    ``init_path``."""
    if init_path:
        with open(init_path + ".part", "wb") as f:
            pickle.dump({False: _jax_init(False), True: _jax_init(True)}, f)
        os.rename(init_path + ".part", init_path)
    batches = [make_batch(s) for s in range(XSTEPS)]
    order = sorted(JAX_RUNS, key=lambda r: (r not in JAX_STEPS, r))
    return {rid: _jax_run(RUNS[rid], batches, JAX_STEPS.get(rid, 0))
            for rid in order[part::PARTS]}


def _start_reference(tmp, part):
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"streams_reference_{part}.pickle")
    init = os.path.join(tmp, "streams_init.pickle") if part == 0 else ""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_streams as t; "
            "pickle.dump(t._reference(int(sys.argv[2]), sys.argv[3]), "
            "open(sys.argv[1], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, out, str(part),
                             init], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out, init


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


def _wait_for(path, proc):
    """The pickle at ``path``, once the process writing it has."""
    import time
    while not os.path.exists(path):
        if proc.poll() is not None:
            _finish_reference(proc, path)       # raises with its errors
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


# -- the port: eight gloo ranks per parameter tree ---------------------------

def _port_runs(tmp, runs, init):
    job = TrainJob(
        run=RunConfig(model=ModelConfig(**DENSE),
                      shape=ShapeCell("t", "train", SEQ, BATCH),
                      system=SystemConfig(min_shard_size=8),
                      optimizer=OptimizerConfig(**OPT)),
        mesh=MESH3, runs=list(runs.values()), device="cpu", params=init,
        batches=[make_batch(s) for s in range(XSTEPS)], return_params=True)
    ranks = spawn(job, tmp, timeout_s=900)
    return {rid: [rk["runs"][i] for rk in ranks]
            for i, rid in enumerate(runs)}


def _compute(tmp_path_factory):
    """The reference in PARTS processes; the port's ranks start once the
    first has written the initial parameters."""
    tmp = str(tmp_path_factory.mktemp("streams"))
    procs = [_start_reference(tmp, k) for k in range(PARTS)]
    try:
        init = _wait_for(procs[0][2], procs[0][0])
        port = {}
        for peft in (False, True):
            runs = {rid: mr for rid, mr in RUNS.items() if mr.peft == peft}
            port.update(_port_runs(tmp, runs, init[peft]))
        ref = {}
        for proc, out, _ in procs:
            ref.update(_finish_reference(proc, out))
    except BaseException:
        for proc, _, _ in procs:
            proc.kill()
            proc.wait()
        raise
    return {"ref": ref, "port": port}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_streams_runs",
                         lambda: _compute(tmp_path_factory))


def _params(ranks, key="final_params"):
    from test_torch_train import assemble
    import torch
    specs = ranks[0]["specs"]
    return {path: assemble({r: torch.from_numpy(res[key][path])
                            for r, res in enumerate(ranks)},
                           specs[path], MESH3).numpy()
            for path in specs}


def _close(a, b, what):
    """Two port runs' first steps at the step tolerances."""
    ma, mb = a[0]["metrics"][0], b[0]["metrics"][0]
    np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=LOSS_RTOL,
                               err_msg=what)
    np.testing.assert_allclose(ma["grad_norm"], mb["grad_norm"],
                               rtol=GNORM_RTOL, err_msg=what)
    pa, pb = _params(a), _params(b)
    for path in pa:
        np.testing.assert_allclose(pa[path], pb[path], **PARAM_TOL,
                                   err_msg=f"{what} {path}")


def _bit_equal_params(a, b, what):
    pa, pb = _params(a), _params(b)
    assert set(pa) == set(pb)
    for path in pa:
        np.testing.assert_array_equal(pa[path], pb[path],
                                      err_msg=f"{what} {path}")


def _pod(b):
    return tuple(b.get(f"{op}/pod", 0)
                 for op in ("all_gather", "psum_scatter", "psum"))


def _port_bundle(mr):
    from repro_torch.core.engine import StepBundle
    sysc = SystemConfig(
        mode=mr.mode, min_shard_size=8, param_compress=mr.param_compress,
        grad_compress=mr.grad_compress, fused_matmul=mr.fused_matmul,
        prefetch_depth=mr.prefetch_depth, peft=mr.peft,
        lora_rank=mr.lora_rank, mode_overrides=mr.mode_overrides,
        async_grad_reduce=mr.async_grad_reduce,
        cross_step_pipeline=mr.cross_step_pipeline)
    run = RunConfig(model=ModelConfig(**DENSE),
                    shape=ShapeCell("t", "train", SEQ, BATCH), system=sysc,
                    optimizer=OptimizerConfig(**OPT), microbatch=mr.microbatch)
    return StepBundle(run, device="cpu", mesh=MESH3)


# -- validation and the gates ---------------------------------------------------

def _validation_error(pkg, case):
    """The ValueError message of ``case`` in ``pkg`` ('repro' or
    'repro_torch'), or None."""
    import importlib
    base = importlib.import_module(f"{pkg}.configs.base")
    model = base.ModelConfig(**DENSE)
    cell = base.ShapeCell("t", "train", SEQ, BATCH)
    try:
        if case == "no_async":
            base.SystemConfig(cross_step_pipeline=True)
        sysc = base.SystemConfig(cross_step_pipeline=True,
                                 async_grad_reduce=True)
        if case.startswith("microbatch"):
            base.RunConfig(model=model, shape=cell, system=sysc,
                           microbatch=int(case[-1]))
        run = base.RunConfig(model=model, shape=cell, system=sysc,
                             microbatch=2)
        if case == "replace":
            run.replace(microbatch=0)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["no_async", "microbatch0", "microbatch1",
                                  "replace", "valid"])
def test_validation_matches_jax(case):
    """Cross-step needs async and microbatch >= 2 (``replace`` checks
    again), with the reference's messages."""
    got = _validation_error("repro_torch", case)
    assert got == _validation_error("repro", case)
    assert (got is None) == (case == "valid")


class _M3:
    axis_names = ("pod", "data", "model")


class _M2:
    axis_names = ("data", "model")


GATE_MODES = ("zero3", "zeropp", "fcdp", "mics", "hier", "fcdp+mics",
              "mics+hier")


def _gates(pkg, mode):
    import importlib
    st = importlib.import_module(f"{pkg}.core.strategy")
    base = importlib.import_module(f"{pkg}.configs.base")
    if "+" in mode:
        names = mode.split("+")
        s = st.CompositeStrategy(st.get_strategy(names[0]),
                                 {n: st.get_strategy(n) for n in names})
    else:
        s = st.get_strategy(mode)
    out = [s.supports_async_grad_reduce, s.supports_cross_step]
    for flags in ({}, {"async_grad_reduce": True},
                  {"async_grad_reduce": True, "cross_step_pipeline": True}):
        sysc = base.SystemConfig(**flags)
        for mesh in (_M3(), _M2()):
            out += [s.async_grad_reduce_active(sysc, mesh),
                    s.cross_step_active(sysc, mesh)]
    return out


@pytest.mark.parametrize("mode", GATE_MODES)
def test_strategy_gates_match_jax(mode):
    """The capabilities and gates (``tests/test_cross_step.py:110-139``):
    zero3, zeropp and fcdp stream given the flag and a 'pod' axis, mics
    and hier decline, a composite streams when any group does."""
    got = _gates("repro_torch", mode)
    assert got == _gates("repro", mode)
    assert got[0] == got[1] == (mode not in ("mics", "hier", "mics+hier"))


def test_gates_need_pod_of_size_two():
    """A 'pod' axis of size 1 has no stage 1 to defer."""
    from repro_torch.core.strategy import get_strategy
    sysc = SystemConfig(async_grad_reduce=True, cross_step_pipeline=True)
    one = MeshShape(AXES, (1, 2, 2))
    for mode in ("zero3", "fcdp"):
        s = get_strategy(mode)
        assert s.async_grad_reduce_active(sysc, MESH3)
        assert not s.async_grad_reduce_active(sysc, one)
        assert not s.cross_step_active(sysc, one)


@pytest.mark.parametrize("rid", JAX_RUNS)
def test_analytic_matches_jax(streams, rid):
    """``async_reduce_enabled``, ``cross_step_enabled``, the async and
    carry buffers in total, per group and per leaf equal the JAX
    functions', and the table's values."""
    from repro_torch.core import schedule
    b = _port_bundle(RUNS[rid])
    got = _analytic(schedule, b.strategy, b.def_leaves, b.plan_leaves,
                    b.mesh_shape, b.run)
    want = streams["ref"][rid]
    for k in got:
        assert got[k] == want[k], (rid, k)
    async_b, carry_b = BUFFERS[_row(rid)]
    assert got["async_bytes"] == async_b
    assert carry_b is None or got["carry_bytes"] == carry_b
    for r in streams["port"].get(rid, []):
        assert (r["async_buffer_bytes"], r["cross_step_buffer_bytes"]) \
            == (got["async_bytes"], got["carry_bytes"])
        assert (r["async_live"], r["cross_step_live"]) \
            == (got["async_live"], got["xstep_live"])


# -- stream 2: bytes ------------------------------------------------------------

STEP_RUNS = [rid for rid in RUNS if rid.endswith(("_seq", "_async"))]


def _pinned(rid):
    return {k: v for (r, k), v in PINNED.items() if r == _row(rid)}


@pytest.mark.parametrize("rid", STEP_RUNS)
def test_bytes_match_jax(streams, rid):
    """Every (op, axis) byte count of every rank's step equals the JAX
    trace, but for the pinned double sums."""
    want = dict(streams["ref"][rid]["bytes"])
    for key, (jax_b, port_b) in _pinned(rid).items():
        assert want[key] == jax_b, (rid, key, want[key])
        want[key] = port_b
    for rank, r in enumerate(streams["port"][rid]):
        assert r["bytes"] == [want], (rid, rank)


@pytest.mark.parametrize("rid", sorted(POD_BYTES))
def test_pod_bytes_table(streams, rid):
    """The 'pod' (all_gather, psum_scatter, psum) bytes a rank-step of
    the table: zero3's gather falls from 140,096 to fcdp's 78,272 under
    async (84,416 under PEFT); the other modes' do not move."""
    assert _pod(streams["port"][rid][0]["bytes"][0]) == POD_BYTES[rid]


@pytest.mark.parametrize("row", [r for r in ROWS if r not in DECLINE])
def test_async_moves_no_bytes(streams, row):
    """Async against sequential in the port: every (op, axis) equal, but
    zero3's 'pod' all-gather (the backward's regather is gone), which
    equals fcdp's under async (under PEFT the frozen trunk's view still
    crosses 'pod' once a microbatch)."""
    port = streams["port"]
    seq, asy = (dict(port[f"{row}_{v}"][0]["bytes"][0])
                for v in ("seq", "async"))
    assert port[f"{row}_async"][0]["async_live"]
    assert not port[f"{row}_seq"][0]["async_live"]
    if row.startswith("zero3"):
        assert asy["all_gather/pod"] < seq["all_gather/pod"]
        if row == "zero3":
            fc = port["fcdp_async"][0]["bytes"][0]
            assert asy["all_gather/pod"] == fc["all_gather/pod"]
        seq["all_gather/pod"] = asy["all_gather/pod"]
    assert asy == seq


# -- stream 2: the steps ----------------------------------------------------------

def _hold(ranks, ref, what):
    """The port's steps against a JAX run's fused steps: every step both
    ran, and the parameters when both ran as many."""
    n = min(len(ranks[0]["metrics"]), len(ref["metrics"]))
    for s in range(n):
        m, mj = ranks[0]["metrics"][s], ref["metrics"][s]
        np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"{what} loss {s}")
        np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                                   rtol=GNORM_RTOL,
                                   err_msg=f"{what} grad norm {s}")
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks), what
    if len(ranks[0]["metrics"]) != len(ref["metrics"]):
        return
    params = _params(ranks)
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{what} {path}")


HELD = {rid: rid for rid in JAX_STEPS}
# hier's reference step sums over 'pod' twice: zero3's and fcdp's
HELD.update({"hier_async_f32": "zero3_async_f32",
             "fcdp_embed_hier_async_f32": "fcdp_fused3_f32"})


@pytest.mark.parametrize("rid", sorted(HELD))
def test_async_matches_jax(streams, rid):
    """The port's async step equals the JAX async step in fp32 (hier's
    the JAX zero3 step, the hier-embedding composite's the JAX fcdp
    step)."""
    _hold(streams["port"][rid], streams["ref"][HELD[rid]], rid)


@pytest.mark.parametrize("row", ["zero3", "zeropp", "fcdp", "fcdp_ag",
                                 "zero3_peft", "fcdp_peft",
                                 "fcdp_embed_hier"])
def test_async_equals_sequential(streams, row):
    """The moved reduce changes no math: async equals sequential, and
    bit for bit (every reduce here sums two ranks, whose order does not
    matter; the 'pod' reduce of a whole leaf sums what the per-layer
    reduces summed)."""
    port = streams["port"]
    asy, seq = port[f"{row}_async"], port[f"{row}_seq"]
    _close(asy, seq, row)
    assert [r["metrics"] for r in asy] == [r["metrics"] for r in seq]
    _bit_equal_params(asy, seq, row)


def test_hier_embedding_composite_equals_fcdp(streams):
    """The composite's hier embedding is summed over 'pod' once (by the
    widening reduce-scatter), so its step is fcdp's, sequential and
    async; the reference's grad norm doubles there."""
    port, ref = streams["port"], streams["ref"]
    for v in ("seq", "async"):
        _close(port[f"fcdp_embed_hier_{v}"], port[f"fcdp_{v}"], v)
    assert ref["fcdp_embed_hier_async"]["bytes"] == ref[
        "fcdp_embed_hier_seq"]["bytes"]


@pytest.mark.parametrize("row", DECLINE)
def test_mics_and_hier_decline(streams, row):
    """mics and hier decline the flag: not live, their sequential bytes
    and bits."""
    port = streams["port"]
    seq, asy = port[f"{row}_seq"], port[f"{row}_async"]
    assert not asy[0]["async_live"] and not asy[0]["cross_step_live"]
    assert asy[0]["bytes"] == seq[0]["bytes"]
    assert [r["metrics"] for r in asy] == [r["metrics"] for r in seq]
    _bit_equal_params(asy, seq, row)


def test_int8_async(streams):
    """qwZ/qgZ under async: quantized whole (once per leaf), within 5e-2
    of the sequential int8 step, the trio called as ``int8_launch_plan``
    says, fewer calls than the per-layer sequential step."""
    port = streams["port"]
    asy, seq = port["fcdp_q8_async"], port["fcdp_q8_seq"]
    a, q = (r[0]["metrics"][0]["loss"] for r in (asy, seq))
    assert abs(a - q) / abs(q) < INT8_DRIFT
    for r in asy + seq:
        assert r["calls"] == [r["int8_plan"]]
        assert r["launches"] == [dict.fromkeys(r["int8_plan"], 0)]
    pa, ps = asy[0]["int8_plan"], seq[0]["int8_plan"]
    assert all(0 < pa[k] < ps[k] for k in pa), (pa, ps)
    assert pa == _leaf_level_plan("fcdp_q8_async")


def _leaf_level_plan(rid):
    """Per microbatch and trainable leaf with a stage 1: qwZ quantizes
    and dequantizes once, qgZ quantizes and dequant-accumulates once."""
    b = _port_bundle(RUNS[rid])
    out = dict.fromkeys(("quantize", "dequantize", "dequant_accumulate"), 0)
    for i in b.train_idx:
        res = b.plan_leaves[i].residency
        out["quantize"] += res.quantized_gather + res.quantized_reduce
        out["dequantize"] += res.quantized_gather
        out["dequant_accumulate"] += res.quantized_reduce
    return {k: v * NM for k, v in out.items()}


def test_ag_matmul_async(streams):
    """The fused matmul fed from the resident stage-1 view: its plan's
    chunk matmuls, the unfused async step's bits."""
    port = streams["port"]
    for r in port["fcdp_ag_async"]:
        assert r["mm_calls"] == [r["mm_plan"]] and r["mm_plan"] > 0
        assert r["mm_launches"] == [0]        # the CPU: plain versions
    assert [r["metrics"] for r in port["fcdp_ag_async"]] \
        == [r["metrics"] for r in port["fcdp_async"]]
    _bit_equal_params(port["fcdp_ag_async"], port["fcdp_async"], "ag")


def test_ring_is_a_no_op_under_async(streams):
    """Under async the model's plans have no stage 1: prefetch depth 2
    equals depth 0 bit for bit, live depth 0, no ring bytes; the
    sequential step at depth 2 keeps its ring."""
    port = streams["port"]
    d2, d0 = port["fcdp_d2_async"], port["fcdp_async"]
    assert [r["metrics"] for r in d2] == [r["metrics"] for r in d0]
    _bit_equal_params(d2, d0, "d2")
    for r in d2:
        assert r["live_depth"] == [0] and r["ring_bytes"] == [0]
        assert r["prefetch_buffer_bytes"] == 0
    assert port["fcdp_d2_seq"][0]["live_depth"] == [2]


def test_caches_under_async(streams):
    """The backward reads the resident stage-1 view on the device: no
    cache is parked on the host under fcdp, and zero3 reads the same
    device bytes as fcdp."""
    port = streams["port"]
    fc, z3 = port["fcdp_async"][0], port["zero3_async"][0]
    assert set(fc["cache_places"][0]) == {"device"}
    assert fc["cached"][0] == z3["cached"][0]
    assert "host" in port["fcdp_seq"][0]["cached"][0]


# -- stream 3 ---------------------------------------------------------------------

@pytest.mark.parametrize("row", XROWS)
def test_cross_step_bit_identical(streams, row):
    """Prime, 2 piped calls and a flush against the fused async step over
    the same 3 batches: the losses, the shifted grad norms and the final
    shards bit for bit (the piped call reports the previous step's norm,
    the flush the last)."""
    port = streams["port"]
    xs, fu = port[f"{row}_xstep"], port[f"{row}_fused3"]
    for r in xs:
        assert r["kinds"] == ["prime", "piped", "piped", "flush"]
        assert r["metrics"][0]["grad_norm"] == 0.0
        assert [m["primed"] for m in r["metrics"]] == [True, False, False,
                                                       False]
    m_x, m_f = xs[0]["metrics"], fu[0]["metrics"]
    assert [m["loss"] for m in m_x[:XSTEPS]] == [m["loss"] for m in m_f]
    assert [m["grad_norm"] for m in m_x[1:]] \
        == [m["grad_norm"] for m in m_f]
    assert all(r["metrics"] == m_x for r in xs)
    _bit_equal_params(xs, fu, row)


def _sum(*bs):
    out = {}
    for b in bs:
        for k, v in b.items():
            out[k] = out.get(k, 0.0) + v
    return out


@pytest.mark.parametrize("row", XROWS)
def test_cross_step_bytes(streams, row):
    """A piped call moves a fused step's bytes, (op, axis) by (op, axis);
    prime and flush together move one fused step's."""
    port = streams["port"]
    for x, f in zip(port[f"{row}_xstep"], port[f"{row}_fused3"]):
        fused = f["bytes"][1]
        assert x["bytes"][1] == fused and x["bytes"][2] == fused
        assert _sum(x["bytes"][0], x["bytes"][3]) == pytest.approx(fused)


@pytest.mark.parametrize("row", XROWS)
def test_carry_bytes(streams, row):
    """The carry's measured bytes equal ``cross_step_buffer_bytes`` after
    the prime and each piped call (none after the flush), and its
    tensors have ``cross_step_carry_layout``'s per-rank shapes."""
    b = _port_bundle(RUNS[f"{row}_xstep"])
    assert b.cross_step
    layout = b.cross_step_carry_layout()
    laid = sum(math.prod(shape) * dtype.itemsize
               for entries in layout.values() for shape, dtype in entries)
    for r in streams["port"][f"{row}_xstep"]:
        want = r["cross_step_buffer_bytes"]
        assert want > 0 and r["cross_step_live"]
        assert r["carry_bytes"] == [want, want, want, 0]
    assert laid == want


def test_cross_step_matches_jax(streams):
    """fcdp's cross-step run against the JAX fused async step over the
    same batches, in fp32: losses within 1e-4, the shifted grad norms within
    1e-3, the final parameters at the step tolerances; the prime's loss
    equals the JAX ``build_train_prime``'s."""
    xs, ref = streams["port"]["fcdp_xstep_f32"], streams["ref"]
    mj = ref["fcdp_fused3_f32"]["metrics"]
    m = xs[0]["metrics"]
    np.testing.assert_allclose([x["loss"] for x in m[:XSTEPS]],
                               [x["loss"] for x in mj], rtol=LOSS_RTOL)
    np.testing.assert_allclose([x["grad_norm"] for x in m[1:]],
                               [x["grad_norm"] for x in mj],
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(m[0]["loss"],
                               ref["fcdp_xstep_f32"]["prime_loss"],
                               rtol=LOSS_RTOL)
    params = _params(xs)
    for path, want in ref["fcdp_fused3_f32"]["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=path)
