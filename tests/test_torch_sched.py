"""The port's stage-1 prefetch ring (``core/schedule.py``), hierarchical
partitioning (hier) and the 'inter_only' fsdp scope against the JAX
package's, on the CPU, at (pod 2, data 2, model 2).

Step tests: both packages train ``tests/test_system.py``'s ``DENSE``
model (2 layers, d_model 64, GQA 4/2, vocab 256) on its batch (seq 64,
batch 8) with ``min_shard_size=8``, the JAX step on eight CPU devices,
the port on eight gloo ranks from the JAX bundle's parameters:

  * zero3, zeropp and fcdp at prefetch depths 1, 2 and 7 (7 is clamped
    to the 2 layers) equal the JAX step at the same depth at
    ``test_system.py``'s tolerances (loss rtol 1e-4, grad norm 1e-3,
    parameters rtol 2e-2 / atol 2e-3), and the port's own depth 0 bit
    for bit: the ring moves when a stage-1 gather runs, not what it
    gathers or reduces;
  * hier equals the JAX *zero3* step (loss 6.0437, grad norm 5.391)
    and the port's zero3 bit for bit. The JAX hier step
    sums its gradient over 'pod' twice and reports twice the grad norm
    (10.777 with XLA's default flags): a fault of the reference the
    port does not copy (``core/strategy.py``);
  * fcdp with the MLP projections 'inter_only' (``mlp_inter_only``, the
    same ``defs_fn`` in both packages) equals plain fcdp: the JAX package
    sums those leaves' gradients over 'data' twice there (grad norm
    5.5975 with XLA's default flags);
  * fcdp at depth 1 with ``fused_matmul="ag_matmul"`` equals fcdp at
    depth 1 bit for bit, and with int8 qwZ/qgZ stays within
    ``test_substrate.py``'s 0.08 of it, calling the int8 trio as often
    as ``int8_launch_plan`` says (zero3 + qwZ at depth 1 too, whose
    backward no longer regathers).

Byte tests: comm_smoke's model (``benchmarks/harness/workloads.py``: 2
layers, d_model 64) under the five modes at depths 0, 1 and 2 moves
every (op, axis) byte count of the JAX trace per step, with two pinned
exceptions (hier's 'pod' psum and the 'inter_only' run's 'data' psum,
the reference's double sums), the 'pod' totals of the table below, the
JAX scheduler's live depth (0 under mics and hier) and ring bytes equal
to the JAX ``cache_bytes_per_chip``'s ``prefetch_buffer_bytes_per_chip``.

The JAX steps run in a subprocess with XLA's excess precision off, as
``tests/test_torch_tp.py`` runs them (see its module note); the port's
ranks run once per session behind ``shared_result``'s file lock. This
module imports nothing of JAX at its top: the ranks import it to read
``mlp_inter_only``.
"""
import dataclasses
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

DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
COMM_MODEL = dict(name="smoke-dense", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256)
SEQ, BATCH = 64, 8
AXES = ("pod", "data", "model")
MESH3 = MeshShape(AXES, (2, 2, 2))
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
COMM_OPT = dict(total_steps=4, warmup_steps=1)
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
INT8_DRIFT = 0.08            # tests/test_substrate.py's per-step bound
INT8 = "int8_pod"


def mlp_inter_only(defs):
    """The stack's MLP projections (w_in, w_gate, w_out; not its norm)
    sharded over 'pod' only, as the reference shards its MoE experts: a
    def tree transform for either package's bundle (``defs_fn``)."""
    def walk(tree, in_mlp):
        return {k: (walk(v, in_mlp or k == "mlp") if isinstance(v, dict)
                    else dataclasses.replace(v, fsdp_scope="inter_only")
                    if in_mlp and k.startswith("w_") else v)
                for k, v in tree.items()}
    return walk(defs, False)


STREAMING = ("zero3", "zeropp", "fcdp")
DEPTHS = (1, 2, 7)
DENSE_RUNS = {f"{m}_d{k}": ModeRun(m, prefetch_depth=k)
              for m in STREAMING for k in (0,) + DEPTHS}
DENSE_RUNS.update({
    "hier": ModeRun("hier"),
    "fcdp_inter": ModeRun("fcdp", defs_fn=mlp_inter_only),
    "fcdp_d1_ag": ModeRun("fcdp", prefetch_depth=1,
                          fused_matmul="ag_matmul"),
    "fcdp_d1_q8": ModeRun("fcdp", INT8, INT8, prefetch_depth=1),
    "zero3_d1_q8": ModeRun("zero3", INT8, INT8, prefetch_depth=1)})
# the JAX steps the port's are held to
JAX_DENSE = [f"{m}_d{k}" for m in STREAMING for k in DEPTHS] + ["fcdp_d0"]
MODES = ("zero3", "zeropp", "fcdp", "mics", "hier")
COMM_RUNS = {f"{m}_d{k}": ModeRun(m, prefetch_depth=k)
             for m in MODES for k in (0, 1, 2)}
COMM_RUNS["fcdp_inter"] = ModeRun("fcdp", defs_fn=mlp_inter_only)

# comm_smoke's 'pod' bytes a step as the port moves them; the JAX trace
# equals them but for hier's 'pod' psum (115,975 B in the reference: its
# double sum)
COMM_POD = {"zero3_d0": 78279, "zero3_d1": 57671, "zero3_d2": 57671,
            "hier_d0": 57671, "mics_d0": 115975,
            **{f"{m}_d{k}": 57671 for m in ("zeropp", "fcdp")
               for k in (0, 1, 2)}}
# the pinned divergences: (run, op/axis) -> (JAX bytes, port bytes)
PINNED = {("hier", "psum/pod"): (115975, 7),
          ("fcdp_inter", "psum/data"): (49168, 16)}
RING_SLOT = 20608            # one layer's stage-1 shards a rank, bf16


def make_batch(seed=0):
    """``tests/test_system.py:make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


# -- the JAX reference (run in a subprocess) -------------------------------

def _jax_bundle(model, opt, mr):
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
        prefetch_depth=mr.prefetch_depth)
    run = JRunConfig(model=JModelConfig(**model),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=sysc, optimizer=JOptimizerConfig(**opt))
    return JStepBundle(run, make_mesh((2, 2, 2), AXES), defs_fn=mr.defs_fn)


def _jax_run(model, opt, mr, batch, execute):
    """The bytes per (op, axis) of the step, traced on its arrays, the
    scheduler's live depth and ring bytes, and, executed, the metrics of
    the first step and the trainable parameters after it."""
    import functools

    import jax
    from repro.core.cache import cache_bytes_per_chip
    from repro.core.schedule import GatherScheduler
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    b = _jax_bundle(model, opt, mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    ost = jax.jit(functools.partial(init_opt_state, sys=b.run.system))(tp)
    step = b.make_train_step()
    stats = collect_collectives(step.trace(tp, fp, ost, batch).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    depth = GatherScheduler(b.strategy, b.run.system, b.mi,
                            b.model.plans).depth
    out = {"bytes": {k: v for k, v in stats.by_op_axis.items() if v},
           "live_depth": min(depth, model["num_layers"]),
           "ring_bytes": cache_bytes_per_chip(b)[
               "prefetch_buffer_bytes_per_chip"]}
    if execute:
        tp, ost, m = step(tp, fp, ost, batch)
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["params"] = {b.def_leaves[i].label: np.asarray(x, np.float32)
                         for i, x in zip(b.train_idx, tp)}
    return out


def _reference():
    import jax
    batch = make_batch()
    b = _jax_bundle(DENSE, OPT, DENSE_RUNS["fcdp_d0"])
    init = jax.tree.unflatten(b.treedef, [np.asarray(x) for x in
                                          b.init_all_params(seed=0)])
    return {
        "dense": {rid: _jax_run(DENSE, OPT, DENSE_RUNS[rid], batch, True)
                  for rid in JAX_DENSE},
        "comm": {rid: _jax_run(COMM_MODEL, COMM_OPT, mr, batch, False)
                 for rid, mr in COMM_RUNS.items()},
        "dense_init": init,
    }


def _start_reference(tmp):
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, "sched_reference.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_sched as t; "
            "pickle.dump(t._reference(), open(sys.argv[1], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, out], env=env,
                            stdout=subprocess.DEVNULL,
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


# -- the port: eight gloo ranks per model ------------------------------------

def _port_runs(tmp, model, opt, runs, init):
    job = TrainJob(
        run=RunConfig(model=ModelConfig(**model),
                      shape=ShapeCell("t", "train", SEQ, BATCH),
                      system=SystemConfig(min_shard_size=8),
                      optimizer=OptimizerConfig(**opt)),
        mesh=MESH3, runs=list(runs.values()), device="cpu", params=init,
        batches=[make_batch()], return_params=True)
    ranks = spawn(job, tmp, timeout_s=900)
    return {rid: [rk["runs"][i] for rk in ranks]
            for i, rid in enumerate(runs)}


def _compute(tmp_path_factory):
    """The reference in its own process, meanwhile comm_smoke's port
    runs (they do not start from its weights), then DENSE's."""
    tmp = str(tmp_path_factory.mktemp("sched"))
    proc, ref_path = _start_reference(tmp)
    try:
        out = {"comm": _port_runs(tmp, COMM_MODEL, COMM_OPT, COMM_RUNS,
                                  None)}
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    out["ref"] = ref = _finish_reference(proc, ref_path)
    out["dense"] = _port_runs(tmp, DENSE, OPT, DENSE_RUNS,
                              ref["dense_init"])
    return out


@pytest.fixture(scope="module")
def sched_runs(tmp_path_factory):
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_sched_runs",
                         lambda: _compute(tmp_path_factory))


def _params(ranks):
    from test_torch_train import assemble
    import torch
    specs = ranks[0]["specs"]
    return {path: assemble({r: torch.from_numpy(res["params"][path])
                            for r, res in enumerate(ranks)},
                           specs[path], MESH3).numpy()
            for path in specs}


def _hold_to_jax(ref, ranks, what):
    m, mj = ranks[0]["metrics"][0], ref["metrics"]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{what} loss")
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL, err_msg=f"{what} grad norm")
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _params(ranks)
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{what} {path}")


def _bit_equal(a, b, what):
    """Two port runs' first steps: equal metrics on every rank and equal
    updated parameters, bit for bit."""
    assert [r["metrics"] for r in a] == [r["metrics"] for r in b], what
    pa, pb = _params(a), _params(b)
    assert set(pa) == set(pb)
    for path in pa:
        np.testing.assert_array_equal(pa[path], pb[path],
                                      err_msg=f"{what} {path}")


# -- step tests -------------------------------------------------------------

@pytest.mark.parametrize("mode", STREAMING)
@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_matches_jax(sched_runs, mode, depth):
    """The first step at depth k equals the JAX step at depth k."""
    rid = f"{mode}_d{depth}"
    _hold_to_jax(sched_runs["ref"]["dense"][rid], sched_runs["dense"][rid],
                 rid)


@pytest.mark.parametrize("mode", STREAMING)
@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_equals_depth0_bit_for_bit(sched_runs, mode, depth):
    """The ring changes when a stage-1 gather runs, not its values nor
    the backward's reduce order: depth k equals depth 0 bit for bit,
    with the live depth clamped to the 2 layers."""
    d = sched_runs["dense"]
    _bit_equal(d[f"{mode}_d{depth}"], d[f"{mode}_d0"], f"{mode} d{depth}")
    assert d[f"{mode}_d{depth}"][0]["live_depth"] == [min(depth, 2)]
    assert d[f"{mode}_d0"][0]["live_depth"] == [0]


def test_hier_equals_zero3(sched_runs):
    """hier's step is zero3's: held to the JAX zero3 step (grad norm
    5.3913, not the reference hier's double), and bit-equal to the
    port's zero3, its opt state widened over 'pod'."""
    d, ref = sched_runs["dense"], sched_runs["ref"]["dense"]
    _hold_to_jax(ref["zero3_d1"], d["hier"], "hier vs JAX zero3")
    np.testing.assert_allclose(d["hier"][0]["metrics"][0]["grad_norm"],
                               5.3913, rtol=GNORM_RTOL)
    _bit_equal(d["hier"], d["zero3_d0"], "hier vs zero3")
    widened = d["hier"][0]["widened"]
    assert widened and set(map(tuple, widened.values())) == {("pod",)}


def test_inter_only_equals_fcdp(sched_runs):
    """The MLP projections sharded over 'pod' only (their optimizer state
    widened over 'data') give plain fcdp's step: grad norm 5.3913, not
    the reference's 5.5975."""
    d, ref = sched_runs["dense"], sched_runs["ref"]["dense"]
    _hold_to_jax(ref["fcdp_d0"], d["fcdp_inter"], "inter_only vs JAX fcdp")
    m, m0 = (d[k][0]["metrics"][0] for k in ("fcdp_inter", "fcdp_d0"))
    np.testing.assert_allclose(m["loss"], m0["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], m0["grad_norm"],
                               rtol=GNORM_RTOL)
    widened = d["fcdp_inter"][0]["widened"]
    assert widened and all(".mlp." in p for p in widened)
    assert set(map(tuple, widened.values())) == {("data",)}


def test_ag_matmul_at_depth1_bit_for_bit(sched_runs):
    """The fused matmul fed from a ring slot equals the unfused step at
    depth 1 bit for bit, with the plans' chunk-matmul calls."""
    d = sched_runs["dense"]
    _bit_equal(d["fcdp_d1_ag"], d["fcdp_d1"], "ag_matmul d1")
    for r in d["fcdp_d1_ag"]:
        assert r["mm_calls"] == [r["mm_plan"]] and r["mm_plan"] > 0
        assert r["mm_launches"] == [0]        # the CPU: plain versions


@pytest.mark.parametrize("rid", ["fcdp_d1_q8", "zero3_d1_q8"])
def test_int8_through_the_ring(sched_runs, rid):
    """qwZ/qgZ through the ring: quantized at issue, dequantized at the
    slot's wait, within 0.08 of the exact step, the int8 trio called as
    ``int8_launch_plan`` says (zero3's backward no longer regathers, so
    its plan is fcdp's)."""
    d = sched_runs["dense"]
    exact = d[rid.replace("_q8", "")][0]["metrics"][0]["loss"]
    got = d[rid][0]["metrics"][0]["loss"]
    assert got != exact and abs(got - exact) / abs(exact) < INT8_DRIFT
    plans = {tuple(sorted(r["int8_plan"].items())) for r in d[rid]}
    assert plans == {tuple(sorted(d["fcdp_d1_q8"][0]["int8_plan"].items()))}
    for r in d[rid]:
        assert r["calls"] == [r["int8_plan"]]
        assert all(v > 0 for v in r["int8_plan"].values())


# -- byte tests (comm_smoke's model) -----------------------------------------

def _pinned(rid):
    base = rid.split("_d")[0] if rid != "fcdp_inter" else rid
    return {k: v for (r, k), v in PINNED.items() if r == base}


@pytest.mark.parametrize("rid", list(COMM_RUNS))
def test_comm_bytes_match_jax(sched_runs, rid):
    """Every (op, axis) byte count of every rank equals the JAX trace at
    the same depth, but for the pinned double sums."""
    want = dict(sched_runs["ref"]["comm"][rid]["bytes"])
    for key, (jax_b, port_b) in _pinned(rid).items():
        assert want[key] == jax_b, (rid, key, want[key])
        want[key] = port_b
    for rank, r in enumerate(sched_runs["comm"][rid]):
        assert r["bytes"] == [want], (rid, rank)


def test_hier_pod_psum_is_the_loss_terms_only(sched_runs):
    """Pinned: hier sums no gradient over 'pod' beyond its widening
    reduce-scatter, whose bytes equal its gather back; the reference's
    trace adds the all-reduce it also runs."""
    for k in (0, 1, 2):
        got = sched_runs["comm"][f"hier_d{k}"][0]["bytes"][0]
        ref = sched_runs["ref"]["comm"][f"hier_d{k}"]["bytes"]
        assert (got["psum/pod"], ref["psum/pod"]) == PINNED["hier",
                                                           "psum/pod"][::-1]
        assert got["psum_scatter/pod"] == got["all_gather/pod"] == 28832
        assert got["psum/pod"] == sched_runs["comm"]["zero3_d0"][0][
            "bytes"][0]["psum/pod"]


def test_inter_only_data_psum_is_the_loss_terms_only(sched_runs):
    """Pinned: the 'inter_only' leaves' gradients are summed over 'data'
    once, by the widening reduce-scatter; the reference also
    all-reduces them there."""
    got = sched_runs["comm"]["fcdp_inter"][0]["bytes"][0]
    ref = sched_runs["ref"]["comm"]["fcdp_inter"]["bytes"]
    assert (ref["psum/data"], got["psum/data"]) == PINNED["fcdp_inter",
                                                          "psum/data"]
    assert got["psum/data"] == sched_runs["comm"]["fcdp_d0"][0]["bytes"][
        0]["psum/data"]


@pytest.mark.parametrize("rid", sorted(COMM_POD))
def test_comm_pod_totals(sched_runs, rid):
    """The 'pod' bytes a step: zero3's fall from 78,279 to fcdp's 57,671
    at depth >= 1 (its all-gather from 49,440 to 28,832), hier's are
    57,671, mics's 115,975; zeropp's and fcdp's do not move with the
    depth."""
    got = sched_runs["comm"][rid][0]["bytes"][0]
    assert sum(v for k, v in got.items() if k.endswith("/pod")) \
        == COMM_POD[rid]
    if rid.startswith("zero3"):
        assert got["all_gather/pod"] == (49440 if rid == "zero3_d0"
                                         else 28832)


@pytest.mark.parametrize("rid", list(COMM_RUNS))
def test_live_depth_and_ring_bytes(sched_runs, rid):
    """The live depth equals the JAX scheduler's (0 under mics and hier
    and at depth 0), the ring holds live depth x 20,608 B a rank, and
    that equals the port's ``prefetch_buffer_bytes`` and the JAX
    ``prefetch_buffer_bytes_per_chip``."""
    ref = sched_runs["ref"]["comm"][rid]
    for r in sched_runs["comm"][rid]:
        assert r["live_depth"] == [ref["live_depth"]], rid
        assert r["ring_bytes"] == [ref["live_depth"] * RING_SLOT], rid
        assert r["prefetch_buffer_bytes"] == ref["ring_bytes"], rid
    if rid.split("_")[0] in ("mics", "hier"):
        assert ref["live_depth"] == 0 and ref["ring_bytes"] == 0
