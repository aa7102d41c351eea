"""The port's tensor parallelism over 'model' against the JAX package's,
on the CPU, at (pod 2, data 2, model 2).

Unit tests: the TP helpers of ``repro_torch/models/common.py`` are the
identity at tp 1; ``kv_span`` / ``slice_expand_kv`` equal the JAX
functions for every head layout ``pad_heads`` gives 4, 16 and 56 heads
at tp 2; and on two gloo ranks over 'model' (spawned once) the int8
activation all-reduce (``core/act_compress.py``), its backward twin,
the vocab-sharded embedding lookup and the vocab-sharded cross entropy
(whole and in chunks, with gradients) equal the JAX functions inside
``shard_map`` on ``mesh3`` (fp32; the int8 all-reduce within fp32
rounding of the JAX one, and within ``tests/test_substrate.py``'s 0.02
of the exact psum).

Step tests: both packages train ``tests/test_system.py``'s ``DENSE``
model (2 layers, d_model 64, GQA 4/2, vocab 256) on the ``CELL`` batch
(seq 64, batch 8) with ``min_shard_size=8``, the JAX step on eight CPU
devices, the port on eight gloo ranks from the JAX bundle's parameters:
zero3, zeropp, fcdp and mics in bf16 (and fcdp with the loss in
sequence chunks), held to the JAX step at ``test_system.py``'s
tolerances (loss rtol 1e-4, grad norm 1e-3, parameters rtol 2e-2 /
atol 2e-3); fcdp with ``act_psum="int8"`` in fp32, held to the JAX step
at the same tolerances; in bf16 fcdp with act int8, and with int8
qwZ/qgZ and act int8 together, held to the exact fcdp run by
``test_substrate.py``'s per-step relative 0.08; fcdp with
``fused_matmul="ag_matmul"`` bit for bit equal to unfused fcdp. PEFT
runs at peft_smoke's model (``benchmarks/harness/workloads.py``: d_model
256, d_ff 1024, LoRA rank 2) under fcdp, zero3 and the mixed arm
(``'*lora*=zero3'``), held to the JAX step; quant_smoke's model (4
layers, d_model 64) under fcdp, fcdp + qwZ and zero3 and comm_smoke's
(the same at 2 layers) under every mode move their bytes.

The JAX steps run in a subprocess whose XLA keeps no excess precision
(``--xla_allow_excess_precision=false``). With it, XLA's CPU compiler
keeps the f32 products of a bf16 matmul through the psum that follows
(the row-parallel projections' sums over 'model') and rounds the sum
once, where the program, its byte count and the port round each
rank's product to bf16 first: on this model that alone moves the JAX
loss by 5.9e-5 relative against the same step at tp 1, where no such
sum exists, and puts it 1.3e-4 from the port's. Without it the JAX step
rounds where its program says, and the port is within the tolerances.
The subprocess also keeps the JAX step out of the process that spawns
the ranks (``tests/test_torch_train.py``).

Byte counts per step and (op, axis) are held exactly to the JAX
package's ``collect_collectives`` of the same step and to the tables
below, the 'model' axis included. One difference is pinned: under
``act_psum="int8"`` the JAX layer remat recomputes the attention
output's int8 all-reduce in the backward (its remat policy never saves
an all-gather's output, and the int8 all-reduce ends in one), so its
'model' all-to-all and all-gather carry one more all-reduce per layer
than the port, which keeps that output for the backward.
"""
import os
import pickle
import queue as queue_mod
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn
from repro_torch.models import common
from test_torch_train import assemble, shared_result

DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
PEFT_MODEL = dict(name="smoke-dense-peft", family="dense", num_layers=2,
                  d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                  vocab_size=256)
QUANT_MODEL = dict(name="smoke-dense", family="dense", num_layers=4,
                   d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=256)
COMM_MODEL = dict(QUANT_MODEL, num_layers=2)        # comm_smoke's
SEQ, BATCH = 64, 8
AXES = ("pod", "data", "model")
MESH3 = MeshShape(AXES, (2, 2, 2))
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
PEFT_OPT = dict(lr=3e-4, total_steps=8, warmup_steps=1, grad_clip=1e9)
QUANT_OPT = dict(total_steps=4, warmup_steps=1)
INT8, F32 = "int8_pod", "float32"
MIXED = (("*lora*", "zero3"),)

RUNS = {"zero3": ModeRun("zero3"), "zeropp": ModeRun("zeropp"),
        "fcdp": ModeRun("fcdp", steps=3), "mics": ModeRun("mics"),
        "fcdp_chunk": ModeRun("fcdp", loss_chunk=16),
        "fcdp_act8_f32": ModeRun("fcdp", dtype=F32, act_psum="int8"),
        "fcdp_act8": ModeRun("fcdp", steps=3, act_psum="int8"),
        "fcdp_q8_act8": ModeRun("fcdp", INT8, INT8, steps=3,
                                act_psum="int8"),
        "fcdp_ag": ModeRun("fcdp", steps=3, fused_matmul="ag_matmul")}
JAX_IDS = ["zero3", "zeropp", "fcdp", "mics", "fcdp_chunk",
           "fcdp_act8_f32", "fcdp_act8", "fcdp_q8_act8", "fcdp_ag"]
# held to the JAX step's numbers (the int8 activation runs in bf16 are
# held to the exact run instead, as tests/test_torch_train.py holds its
# bf16 int8 run)
MATCH_IDS = ["zero3", "zeropp", "fcdp", "mics", "fcdp_chunk",
             "fcdp_act8_f32", "fcdp_ag"]
PEFT = dict(peft=True, lora_rank=2)
PEFT_RUNS = {"fcdp": ModeRun("fcdp", **PEFT),
             "zero3": ModeRun("zero3", **PEFT),
             "mixed": ModeRun("fcdp", mode_overrides=MIXED, **PEFT)}
QUANT_RUNS = {"fcdp": ModeRun("fcdp"),
              "fcdp_q8": ModeRun("fcdp", param_compress=INT8),
              "zero3": ModeRun("zero3")}
COMM_RUNS = {m: ModeRun(m) for m in ("zero3", "zeropp", "fcdp", "mics")}
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
ACT_DRIFT = 0.08            # tests/test_substrate.py's per-step bound
# the int8 all-reduce against the JAX one, both in fp32: the blocks and
# scales agree, but the jitted JAX dequant-accumulate and the port's
# plain one (each product and sum rounded on its own) round the partial
# sums differently in the last bit, which can move a block's second
# scale by one ulp: 1.9e-7 relative at most on these inputs
INT8_AR_TOL = dict(rtol=1e-6, atol=1e-6)

# bytes per device per step at (2, 2, 2), the JAX package's convention
_Z3 = {"all_gather/pod": 49440, "all_gather/data": 98880,
       "psum_scatter/pod": 28832, "psum_scatter/data": 57664,
       "psum/pod": 199, "psum/data": 400, "psum/model": 230404}
_CACHED = dict(_Z3, **{"all_gather/pod": 28832})
# one int8 activation all-reduce of a [2, 64, 64] activation: 16 blocks
# a rank, all-to-all and all-gather of 4,096 B of int8 plus 64 B of
# scales each; 4 a layer (2 forward, 2 backward) in the port
_ACT8 = {"psum/model": 50436, "psum/pod": 135,
         "all_to_all/model": 33280, "all_gather/model": 33280}
BYTES = {
    "zero3": _Z3, "zeropp": _CACHED, "fcdp": _CACHED,
    "mics": {"all_gather/data": 98880, "psum_scatter/data": 57664,
             "psum/pod": 116167, "psum/data": 400, "psum/model": 230404},
    # the recompute re-runs the chunks' sum of exponentials (4 x 128 B)
    "fcdp_chunk": dict(_CACHED, **{"psum/model": 230916}),
    "fcdp_act8": dict(_CACHED, **_ACT8),
    "fcdp_q8_act8": dict(_CACHED, **_ACT8, **{
        "all_gather/pod": 14720, "all_to_all/pod": 14560,
        "psum_scatter/pod": 160}),
    "fcdp_ag": dict(_CACHED, **{"all_gather/data": 86592,
                                "ppermute/data": 12288}),
}
# the JAX layer remat's extra int8 all-reduce per layer (module note)
ACT8_RECOMPUTE = {"all_to_all/model": 2 * 4160, "all_gather/model": 2 * 4160}
_PEFT_FCDP = {"all_gather/pod": 2048, "all_gather/data": 1123584,
              "psum_scatter/pod": 2048, "psum_scatter/data": 4096,
              "psum/pod": 2055, "psum/data": 4112, "psum/model": 921604}
PEFT_BYTES = {"fcdp": _PEFT_FCDP,
              "zero3": dict(_PEFT_FCDP, **{"all_gather/pod": 1086592,
                                           "all_gather/data": 2173184}),
              "mixed": dict(_PEFT_FCDP, **{"all_gather/pod": 4096})}
# results/baseline/quant_smoke.json's traced pod all-gather
QUANT_POD_AG = {"fcdp": 49440, "fcdp_q8": 25248, "zero3": 90656}
# comm_smoke's 'pod' bytes a step at prefetch depth 0 as the installed
# JAX package traces them (results/baseline/comm_smoke.json holds
# 78,281 / 57,673 / 57,673 / 53,417, recorded before its varying-axes
# typing: now mics sums its gradients over 'pod' on the gathered weight,
# before the 'data' reduce-scatter, and the loss terms' sum is split
# over 'model' too)
COMM_DCN = {"zero3": 78279, "zeropp": 57671, "fcdp": 57671, "mics": 115975}


def make_batch(seed=0):
    """``tests/test_system.py:make_batch`` as numpy (peft_smoke's and
    quant_smoke's batches are drawn the same way)."""
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
        param_dtype=mr.dtype, compute_dtype=mr.dtype,
        loss_chunk=mr.loss_chunk, fused_matmul=mr.fused_matmul,
        fused_impl="jnp", act_psum=mr.act_psum, peft=mr.peft,
        lora_rank=mr.lora_rank, mode_overrides=mr.mode_overrides)
    run = JRunConfig(model=JModelConfig(**model),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=sysc, optimizer=JOptimizerConfig(**opt))
    return JStepBundle(run, make_mesh((2, 2, 2), AXES))


def _jax_run(model, opt, mr, batch, execute=True):
    """Metrics of the first step, the trainable parameters after it and
    the bytes per (op, axis) of the step, traced on its arrays."""
    import functools

    import jax
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    b = _jax_bundle(model, opt, mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    tp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in tp]
    fp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in fp]
    ost = jax.jit(functools.partial(init_opt_state, sys=b.run.system))(tp)
    step = b.make_train_step()
    stats = collect_collectives(step.trace(tp, fp, ost, batch).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    out = {"bytes": {k: v for k, v in stats.by_op_axis.items() if v}}
    if execute:
        tp, ost, m = step(tp, fp, ost, batch)
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["params"] = {b.def_leaves[i].label: np.asarray(x, np.float32)
                         for i, x in zip(b.train_idx, tp)}
    return out


def _jax_init_tree(model, opt, mr):
    import jax
    b = _jax_bundle(model, opt, mr)
    leaves = [np.asarray(x) for x in b.init_all_params(seed=0)]
    return jax.tree.unflatten(b.treedef, leaves)


def _reference():
    """Every JAX result the step tests read: the DENSE runs (executed
    where the port's step is held to them, else traced), the PEFT runs
    (executed), quant_smoke's and comm_smoke's (traced), and the initial
    parameter trees."""
    batch = make_batch()
    return {
        "dense": {rid: _jax_run(DENSE, OPT, RUNS[rid], batch,
                                execute=rid in MATCH_IDS)
                  for rid in JAX_IDS},
        "peft": {rid: _jax_run(PEFT_MODEL, PEFT_OPT, mr, batch)
                 for rid, mr in PEFT_RUNS.items()},
        "quant": {rid: _jax_run(QUANT_MODEL, QUANT_OPT, mr, batch,
                                execute=False)
                  for rid, mr in QUANT_RUNS.items()},
        "comm": {rid: _jax_run(COMM_MODEL, QUANT_OPT, mr, batch,
                               execute=False)
                 for rid, mr in COMM_RUNS.items()},
        "dense_init": _jax_init_tree(DENSE, OPT, RUNS["fcdp"]),
        "peft_init": _jax_init_tree(PEFT_MODEL, PEFT_OPT, PEFT_RUNS["fcdp"]),
    }


def _start_reference(tmp):
    """Start ``_reference()`` in a fresh interpreter with eight CPU
    devices and XLA's excess precision off (module note); returns the
    process and the file its result goes to."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, "tp_reference.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_tp as t; "
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


# -- the port: eight gloo ranks per model, two for the unit checks -------------

def _job(model, opt, runs, params, steps):
    return TrainJob(
        run=RunConfig(model=ModelConfig(**model),
                      shape=ShapeCell("t", "train", SEQ, BATCH),
                      system=SystemConfig(min_shard_size=8),
                      optimizer=OptimizerConfig(**opt)),
        mesh=MESH3, runs=list(runs.values()), device="cpu", params=params,
        batches=[make_batch()] * steps, return_params=True)


def _compute(tmp_path_factory):
    """The reference in its own process, meanwhile the port's jobs that
    do not start from its weights, then the ones that do."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    proc, ref_path = _start_reference(tmp)
    try:
        out = {"unit": _spawn_unit(tmp),
               "quant": _port_runs(tmp, QUANT_MODEL, QUANT_OPT, QUANT_RUNS,
                                   None),
               "comm": _port_runs(tmp, COMM_MODEL, QUANT_OPT, COMM_RUNS,
                                  None)}
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    out["ref"] = ref = _finish_reference(proc, ref_path)
    out["dense"] = _port_runs(tmp, DENSE, OPT, RUNS, ref["dense_init"])
    out["peft"] = _port_runs(tmp, PEFT_MODEL, PEFT_OPT, PEFT_RUNS,
                             ref["peft_init"])
    return out


def _port_runs(tmp, model, opt, runs, init):
    """Every rank's result of each run, by run id."""
    steps = max(r.steps for r in runs.values())
    ranks = spawn(_job(model, opt, runs, init, steps), tmp, timeout_s=900)
    return {rid: [rk["runs"][i] for rk in ranks]
            for i, rid in enumerate(runs)}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_tp_runs",
                         lambda: _compute(tmp_path_factory))


UNIT_SHAPE = (8, 64, 64)


def _unit_inputs():
    rng = np.random.default_rng(7)
    return {"x": rng.normal(0, 1, UNIT_SHAPE).astype(np.float32),
            "g": rng.normal(0, 1, UNIT_SHAPE).astype(np.float32),
            "table": rng.normal(0, 1, (256, 32)).astype(np.float32),
            "ids": rng.integers(0, 300, (4, 16)).astype(np.int64),
            "logits": rng.normal(0, 2, (4, 16, 256)).astype(np.float32),
            "labels": np.concatenate(
                [rng.integers(0, 256, (4, 15)), np.full((4, 1), 256)],
                axis=1).astype(np.int64),
            "h": rng.normal(0, 1, (2, 16, 64)).astype(np.float32),
            "head": rng.normal(0, 0.3, (64, 256)).astype(np.float32)}


def _unit_rank(rank: int) -> dict:
    """What rank ``rank`` of two over 'model' computes: each holds the
    model-sharded half (first dim of x and g, the table's rows, the
    logits' and the head's vocabulary columns) and the rest whole."""
    from repro_torch.core.act_compress import int8_bwd_psum, int8_psum
    from repro_torch.core.collectives import Collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import layers
    inp = {k: torch.from_numpy(v) for k, v in _unit_inputs().items()}
    coll = Collectives(RankMesh(MeshShape(("model",), (2,)), "gloo"))
    tpc = common.TPContext.of(coll, "int8")

    def half(t, dim):
        n = t.shape[dim] // 2
        return t.narrow(dim, rank * n, n).contiguous()
    out = {}
    before = {k: f.calls for k, f in ops.INT8_KERNELS.items()}
    out["int8_psum"] = int8_psum(half(inp["x"], 0), coll, "model").numpy()
    out["int8_calls"] = {k: f.calls - before[k]
                         for k, f in ops.INT8_KERNELS.items()}
    out["int8_bytes"] = coll.snapshot()
    out["exact_psum"] = common.psum_tp(half(inp["x"], 0), tpc).numpy()
    out["exact_bytes"] = coll.snapshot()["psum/model"]
    # the region's input is the same on both ranks, its gradient is not
    x = inp["x"][:UNIT_SHAPE[0] // 2].clone().requires_grad_(True)
    y = int8_bwd_psum(x, coll, "model")
    (y * half(inp["g"], 0)).sum().backward()
    out["bwd_fwd_equal"] = bool(torch.equal(y.detach(), x.detach()))
    out["bwd_grad"] = x.grad.numpy()
    out["embed"] = layers.embed_lookup(half(inp["table"], 0), inp["ids"],
                                       tpc).numpy()
    lg = half(inp["logits"], 2).requires_grad_(True)
    s, c = layers.tp_softmax_xent(lg, inp["labels"], 256, None, tpc)
    s.backward()
    out["xent"] = [s.item(), c.item()]
    out["xent_grad"] = lg.grad.numpy()
    for chunk in (0, 4):
        h = inp["h"].clone().requires_grad_(True)
        hw = half(inp["head"], 1).requires_grad_(True)
        s, c = layers.chunked_tp_softmax_xent(h, hw, inp["labels"][:2], 256,
                                              chunk, None, tpc)
        s.backward()
        out[f"chunked{chunk}"] = ([s.item(), c.item()], h.grad.numpy(),
                                  hw.grad.numpy())
    return out


def _unit_worker(rank, init_method, results):
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=2)
        try:
            results.put((rank, _unit_rank(rank), None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


def _spawn_unit(tmp):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        init = f"file://{os.path.join(d, 'store')}"
        procs = [ctx.Process(target=_unit_worker, args=(r, init, results))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < 2:
                rank, res, err = results.get(timeout=300)
                if err is not None:
                    raise RuntimeError(f"unit rank {rank} failed:\n{err}")
                got[rank] = res
        except queue_mod.Empty:
            raise TimeoutError("the unit ranks did not finish") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
    return [got[0], got[1]]


# -- unit tests -------------------------------------------------------------

def test_tp_helpers_are_the_identity_at_tp1():
    """At tp 1 every TP function hands back its input, with no
    collective (the context has none to issue)."""
    x = torch.randn(2, 3, 4)
    tpc = common.SERIAL
    assert tpc.tp == 1 and tpc.coll is None
    for fn in (common.psum_tp, common.psum_tp_act, common.pvary_tp,
               common.tp_region_in, common.pmax_tp):
        assert fn(x, tpc) is x
    assert common.TPContext(act_psum="int8").int8_act is False
    assert common.local_head_mask(tpc, 4, 4).tolist() == [True] * 4
    with pytest.raises(ValueError, match="act_psum"):
        common.TPContext(act_psum="fp8")
    with pytest.raises(ValueError, match="act_psum"):
        SystemConfig(act_psum="fp8")


@pytest.mark.parametrize("n", [1, 4, 16, 56, 151936, 49155])
@pytest.mark.parametrize("tp", [1, 2, 16])
def test_padding_matches_jax(n, tp):
    from repro.models.common import pad_heads, pad_vocab
    assert common.pad_heads(n, tp) == pad_heads(n, tp)
    assert common.pad_vocab(n, tp) == pad_vocab(n, tp)


def test_local_head_mask_marks_the_padding_heads():
    """7 heads at tp 2 pad to 8: the last head of rank 1 is padding."""
    assert common.local_head_mask(common.TPContext(2, 0, coll=object()), 8,
                                  7).tolist() == [True] * 4
    assert common.local_head_mask(common.TPContext(2, 1, coll=object()), 8,
                                  7).tolist() == [True] * 3 + [False]


def _kv_layouts():
    """(heads, kv heads) for 4, 16 and 56 heads and every kv count that
    divides the heads, padded at tp 2."""
    return [(h, kv) for h in (4, 16, 56) for kv in range(1, h + 1)
            if common.pad_heads(h, 2) % kv == 0 and h % kv == 0]


@pytest.mark.parametrize("heads,kv", _kv_layouts())
def test_slice_expand_kv_matches_jax(heads, kv):
    """Each 'model' rank's expanded K/V (and ``kv_span``) equal the JAX
    functions inside ``shard_map`` over two devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.launch.mesh import make_mesh
    from repro.models import attention as jattn
    from repro.models.common import MeshInfo
    from repro_torch.models import attention
    tp, hd = 2, 4
    hp = common.pad_heads(heads, tp)
    h_local, n_rep = hp // tp, hp // kv
    assert attention.kv_span(h_local, n_rep, kv) == jattn.kv_span(
        h_local, n_rep, kv)
    rng = np.random.default_rng(heads * 100 + kv)
    k = rng.normal(size=(1, 3, kv, hd)).astype(np.float32)
    v = rng.normal(size=(1, 3, kv, hd)).astype(np.float32)
    mesh = make_mesh((1, 1, tp), AXES, devices=jax.devices()[:tp])
    mi = MeshInfo.from_mesh(mesh)
    fn = shard_map(lambda a, b: jattn.slice_expand_kv(a, b, h_local, n_rep,
                                                      mi),
                   mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(None, None, "model"),) * 2, check_vma=False)
    wk, wv = (np.asarray(t) for t in jax.jit(fn)(jnp.asarray(k),
                                                 jnp.asarray(v)))
    got = [attention.slice_expand_kv(torch.from_numpy(k),
                                     torch.from_numpy(v), h_local, n_rep, r)
           for r in range(tp)]
    np.testing.assert_array_equal(torch.cat([g[0] for g in got], 2), wk)
    np.testing.assert_array_equal(torch.cat([g[1] for g in got], 2), wv)


@pytest.fixture(scope="module")
def unit(tp_runs):
    return tp_runs["unit"]


def _jax_in_mesh3(fn, in_specs, out_specs, *args):
    import jax
    import jax.numpy as jnp
    from repro.compat import shard_map
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), AXES)
    f = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_vma=True)
    out = jax.jit(f)(*map(jnp.asarray, args))
    return jax.tree.map(np.asarray, out)


def test_int8_psum_matches_jax(unit):
    """Each rank's int8 all-reduce equals the JAX package's ``int8_psum``
    on mesh3 within fp32 rounding (``INT8_AR_TOL``), is within 0.02 of
    the exact psum (``test_substrate.py``), calls the trio 2 / 1 / 1
    times, and moves int8 blocks and scales over 'model' in place of the
    fp32 psum."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core.act_compress import int8_psum
    x = _unit_inputs()["x"]
    exact, approx = _jax_in_mesh3(
        lambda a: (jax.lax.psum(a, "model"), int8_psum(a, "model")),
        (P("model"),), (P("model"), P("model")), x)
    half = UNIT_SHAPE[0] // 2
    for r, u in enumerate(unit):
        np.testing.assert_allclose(u["int8_psum"],
                                   approx[r * half:(r + 1) * half],
                                   **INT8_AR_TOL)
        np.testing.assert_allclose(u["exact_psum"],
                                   exact[r * half:(r + 1) * half],
                                   rtol=1e-6, atol=1e-6)
        rel = np.abs(u["exact_psum"] - u["int8_psum"]) / np.abs(
            u["exact_psum"]).max()
        assert rel.max() < 0.02, rel.max()
        assert u["int8_calls"] == {"quantize": 1, "dequantize": 1,
                                   "dequant_accumulate": 1}
    # 16,384 fp32 elements a rank, 32 blocks a chunk: each hop moves one
    # chunk of int8 blocks and scales (8,192 + 128 B), against the fp32
    # psum's 65,536 B
    for u in unit:
        assert u["int8_bytes"] == {"all_to_all/model": 8320,
                                   "all_gather/model": 8320}
        assert u["exact_bytes"] == 65536


def test_int8_bwd_psum_backward_matches_jax(unit):
    """``int8_bwd_psum`` is the identity forward and its backward is the
    int8 all-reduce of the gradient: the JAX VJP's, within
    ``INT8_AR_TOL``."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core.act_compress import int8_bwd_psum
    inp = _unit_inputs()

    def body(x, g):
        _, vjp = jax.vjp(lambda t: int8_bwd_psum(t, "model"), x)
        return vjp(g)[0]
    want = _jax_in_mesh3(body, (P(), P("model")), P(),
                         inp["x"][:UNIT_SHAPE[0] // 2], inp["g"])
    for u in unit:
        assert u["bwd_fwd_equal"]
        np.testing.assert_allclose(u["bwd_grad"], want, **INT8_AR_TOL)


def test_vocab_sharded_embed_lookup_matches_jax(unit):
    """Rows of the table split over 'model', ids past the vocabulary
    included: every rank's lookup equals the JAX package's."""
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro.models.common import MeshInfo
    from repro.models.layers import embed_lookup
    inp = _unit_inputs()
    mi = MeshInfo.from_mesh(make_mesh((2, 2, 2), AXES))
    want = _jax_in_mesh3(lambda t, i: embed_lookup(t, i, mi),
                         (P("model"), P()), P(), inp["table"],
                         inp["ids"].astype(np.int32))
    for u in unit:
        np.testing.assert_array_equal(u["embed"], want)


def test_tp_softmax_xent_matches_jax(unit):
    """The vocab-sharded cross entropy (a label past the vocabulary
    masked): the sum, the count and each rank's logit gradient equal the
    JAX package's ``tp_softmax_xent`` within fp32 rounding."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro.models.common import MeshInfo
    from repro.models.layers import tp_softmax_xent
    inp = _unit_inputs()
    mi = MeshInfo.from_mesh(make_mesh((2, 2, 2), AXES))
    labels = inp["labels"].astype(np.int32)

    def body(lg, lb):
        (s, c), vjp = jax.vjp(lambda t: tp_softmax_xent(t, lb, mi, 256), lg)
        return s, c, vjp((jnp.float32(1), jnp.float32(0)))[0]
    s, c, g = _jax_in_mesh3(body, (P(None, None, "model"), P()),
                            (P(), P(), P(None, None, "model")),
                            inp["logits"], labels)
    for r, u in enumerate(unit):
        np.testing.assert_allclose(u["xent"], [s, c], rtol=1e-5)
        np.testing.assert_allclose(u["xent_grad"],
                                   g[:, :, r * 128:(r + 1) * 128],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("chunk", [0, 4])
def test_chunked_tp_softmax_xent_matches_jax(unit, chunk):
    """Logits through the vocab-sharded head, whole and in chunks: the
    loss, x's gradient (summed over 'model') and each rank's head
    columns' gradient equal the JAX package's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro.models.common import MeshInfo
    from repro.models.layers import chunked_tp_softmax_xent
    inp = _unit_inputs()
    mi = MeshInfo.from_mesh(make_mesh((2, 2, 2), AXES))
    labels = inp["labels"][:2].astype(np.int32)

    def body(h, hw, lb):
        def f(h_, hw_):
            return chunked_tp_softmax_xent(h_, hw_, lb, mi, 256, chunk)[0]
        s, vjp = jax.vjp(f, h, hw)
        gh, ghw = vjp(jnp.float32(1))
        return s, gh, ghw
    s, gh, ghw = _jax_in_mesh3(body, (P(), P(None, "model"), P()),
                               (P(), P(), P(None, "model")),
                               inp["h"], inp["head"], labels)
    for r, u in enumerate(unit):
        (ls, cnt), ugh, ughw = u[f"chunked{chunk}"]
        np.testing.assert_allclose(ls, s, rtol=1e-5)
        assert cnt == 2 * 15
        np.testing.assert_allclose(ugh, gh, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ughw, ghw[:, r * 128:(r + 1) * 128],
                                   rtol=1e-5, atol=1e-6)


# -- step tests ---------------------------------------------------------------

def _port_params(ranks):
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
    assert m["tokens"] == mj["tokens"] == BATCH * SEQ
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _port_params(ranks)
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("rid", MATCH_IDS)
def test_step_matches_jax_at_tp2(tp_runs, rid):
    """The first step from the same weights and batch on (2, 2, 2): loss,
    grad norm and the updated parameters."""
    _hold_to_jax(tp_runs["ref"]["dense"][rid], tp_runs["dense"][rid], rid)


@pytest.mark.parametrize("rid", list(BYTES))
def test_bytes_per_axis_match_jax_at_tp2(tp_runs, rid):
    """Every (op, axis) byte count of every step and rank equals the
    table and the JAX trace, 'model' included; under act int8 the JAX
    trace carries the remat's extra all-reduce per layer (module
    note)."""
    want = BYTES[rid]
    ref = dict(tp_runs["ref"]["dense"][rid]["bytes"])
    if RUNS[rid].act_psum == "int8":
        for k, extra in ACT8_RECOMPUTE.items():
            assert ref[k] == want[k] + extra, (k, ref[k])
            ref[k] -= extra
    assert ref == want
    for rank, r in enumerate(tp_runs["dense"][rid]):
        for s, got in enumerate(r["bytes"]):
            assert got == want, (rid, rank, s)


def test_int8_act_halves_the_model_allreduce_bytes(tp_runs):
    """An int8 activation all-reduce moves about half the bf16 psum's
    bytes: all-to-all + all-gather of 8,320 B against 16,384 B for a
    [2, 64, 64] bf16 activation."""
    one_int8 = (BYTES["fcdp_act8"]["all_to_all/model"]
                + BYTES["fcdp_act8"]["all_gather/model"]) / 8
    one_bf16 = 2 * 64 * 64 * 2
    assert one_int8 == 8320
    assert 0.45 < one_int8 / one_bf16 < 0.55


@pytest.mark.parametrize("rid", ["fcdp_act8", "fcdp_q8_act8"])
def test_int8_act_tracks_the_exact_run(tp_runs, rid):
    """act int8 (with and without int8 qwZ/qgZ) stays within
    ``test_substrate.py``'s per-step relative 0.08 of the exact fcdp run
    over three steps, and differs from it."""
    exact = [m["loss"] for m in tp_runs["dense"]["fcdp"][0]["metrics"]]
    quant = [m["loss"] for m in tp_runs["dense"][rid][0]["metrics"]]
    assert len(quant) == len(exact) == 3
    for a, c in zip(exact, quant):
        assert abs(a - c) / a < ACT_DRIFT, (exact, quant)
    assert quant != exact


@pytest.mark.parametrize("rid", list(RUNS))
def test_int8_calls_match_the_extended_plan(tp_runs, rid):
    """Every rank's int8 calls per step equal ``int8_launch_plan``: 8
    activation all-reduces a step (2 layers x (attention, MLP) x
    (forward, backward)), each 1 quantize, 1 dequant-accumulate (which
    requantizes) and 1 dequantize, plus qwZ/qgZ's 16 gathers' calls. On
    the CPU the plain versions run, so no launch is counted."""
    for r in tp_runs["dense"][rid]:
        for calls, launches in zip(r["calls"], r["launches"]):
            assert calls == r["int8_plan"], rid
            assert not any(launches.values()), rid
    act = {"quantize": 8, "dequantize": 8, "dequant_accumulate": 8}
    plan = tp_runs["dense"][rid][0]
    if RUNS[rid].act_psum == "int8":
        assert plan["act_int8_plan"] == act
    else:
        assert not any(plan["act_int8_plan"].values())
    if rid == "fcdp_q8_act8":
        assert plan["int8_plan"] == {"quantize": 40, "dequantize": 24,
                                     "dequant_accumulate": 24}


def test_fused_ag_matmul_equals_unfused_bit_for_bit_at_tp2(tp_runs):
    """'ag_matmul' over 'data' with wo and w_out sharded over 'model' too:
    three steps equal the unfused fcdp run to the bit on every rank, and
    the ring ran 8 chunk matmuls a step."""
    fused, plain = tp_runs["dense"]["fcdp_ag"], tp_runs["dense"]["fcdp"]
    for f, u in zip(fused, plain):
        assert f["metrics"] == u["metrics"]
        for path, want in u["final_params"].items():
            assert np.array_equal(f["final_params"][path], want), path
        assert f["mm_calls"] == [8, 8, 8] == [f["mm_plan"]] * 3


@pytest.mark.parametrize("rid", list(PEFT_RUNS))
def test_peft_step_matches_jax_at_tp2(tp_runs, rid):
    """peft_smoke's model under PEFT on (2, 2, 2): the step equals the
    JAX step, every byte count equals the table and the JAX trace, and
    the frozen trunk is unchanged."""
    ref, ranks = tp_runs["ref"]["peft"][rid], tp_runs["peft"][rid]
    _hold_to_jax(ref, ranks, rid)
    assert ref["bytes"] == PEFT_BYTES[rid]
    for r in ranks:
        assert r["bytes"] == [PEFT_BYTES[rid]]
        assert r["frozen_unchanged"]


def test_peft_pod_gather_is_the_reference_cut(tp_runs):
    """peft_smoke's traced numbers: fcdp's 'pod' all-gather is 2,048 B
    against zero3's 1,086,592 B (a 99.81 % cut), the mixed arm's 4,096
    B."""
    ag = {rid: tp_runs["peft"][rid][0]["bytes"][0]["all_gather/pod"]
          for rid in PEFT_RUNS}
    assert ag == {"fcdp": 2048, "zero3": 1086592, "mixed": 4096}
    assert round(100 * (1 - ag["fcdp"] / ag["zero3"]), 2) == 99.81


def test_quant_smoke_pod_gather_bytes(tp_runs):
    """quant_smoke's traced 'pod' all-gather (fcdp 49,440 B, fcdp + qwZ
    25,248 B, zero3 90,656 B; 1.96x and 3.59x) from the port's ranks,
    and every (op, axis) count equal to the JAX trace."""
    got = {rid: tp_runs["quant"][rid][0]["bytes"][0] for rid in QUANT_RUNS}
    assert {rid: b["all_gather/pod"] for rid, b in got.items()} \
        == QUANT_POD_AG
    for rid, b in got.items():
        assert b == tp_runs["ref"]["quant"][rid]["bytes"], rid
    assert round(QUANT_POD_AG["fcdp"] / QUANT_POD_AG["fcdp_q8"], 2) == 1.96
    assert round(QUANT_POD_AG["zero3"] / QUANT_POD_AG["fcdp_q8"], 2) == 3.59


def test_comm_smoke_dcn_bytes(tp_runs):
    """comm_smoke's model (2 layers, d_model 64, no qkv bias) at prefetch
    depth 0: each mode's 'pod' bytes a step, every (op, axis) count
    equal to the JAX trace; fcdp and zeropp move 0.737 of zero3's."""
    for rid in COMM_RUNS:
        b = tp_runs["comm"][rid][0]["bytes"][0]
        assert b == tp_runs["ref"]["comm"][rid]["bytes"], rid
        assert sum(v for k, v in b.items() if k.endswith("/pod")) \
            == COMM_DCN[rid], rid
