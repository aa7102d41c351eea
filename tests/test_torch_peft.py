"""The port's PEFT / FCDP-Comm train step against the JAX package's, on
the CPU.

Both packages train peft_smoke's model (``benchmarks/harness/
workloads.py``: 2 layers, d_model 256, GQA 4/2, d_ff 1024, vocab 256)
with LoRA adapters of rank 2 on wq/wk/wv/wo, seq 64, batch 8,
``min_shard_size=8`` and peft_smoke's optimizer (lr 3e-4, one warmup
step, ``grad_clip`` 1e9, far above any norm here, so the clip scale is
exactly 1 in every arm), on a (pod 2, data 2, model 1) mesh: the JAX
step on four CPU devices, the port on four gloo ranks, from the JAX
bundle's initial parameters, two steps on two batches. The arms: fcdp,
zero3, zeropp and mics under PEFT; the mixed arm (the trunk on fcdp,
``'*lora*=zero3'``); fcdp with int8 qwZ/qgZ in fp32, held to the JAX
step with ``quant_impl="jnp"`` (as in ``tests/test_torch_train.py``),
at rank 8: at rank 2 every adapter's per-layer shard is 128 elements,
below one quant block, so no leaf would carry int8; and, in the port
only, the all-trainable fcdp arm (``peft.unfreeze_all``), against which
fcdp's adapters after one step are held bit for bit, as peft_smoke
holds them.

Tolerances are ``tests/test_system.py``'s: loss rtol 1e-4, grad norm
rtol 1e-3, updated parameters rtol 2e-2 / atol 2e-3. Byte counts per
step and (op, axis) equal the JAX package's ``collect_collectives`` of
the same step, traced on the same arrays. As in
``tests/test_torch_train.py``, the reference runs first and the port's
ranks after it, once per test session (``shared_result``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.core.engine import StepBundle as JStepBundle
from repro.launch.mesh import make_mesh
from repro.launch.roofline import collect_collectives
from repro.optim.adamw import init_opt_state as j_init_opt_state
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.core.partition import tree_items
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn
from test_torch_train import assemble, shared_result

PEFT_MODEL = dict(name="smoke-dense-peft", family="dense", num_layers=2,
                  d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                  vocab_size=256)
SEQ, BATCH = 64, 8
MESH = MeshShape(("pod", "data", "model"), (2, 2, 1))
OPT = dict(lr=3e-4, total_steps=8, warmup_steps=1, grad_clip=1e9)
INT8, F32 = "int8_pod", "float32"
MIXED = (("*lora*", "zero3"),)
PEFT = dict(peft=True, steps=2, lora_rank=2)
RUNS = {"fcdp": ModeRun("fcdp", **PEFT),
        "zero3": ModeRun("zero3", **PEFT),
        "zeropp": ModeRun("zeropp", **PEFT),
        "mics": ModeRun("mics", **PEFT),
        "mixed": ModeRun("fcdp", mode_overrides=MIXED, **PEFT),
        "fcdp_all": ModeRun("fcdp", peft=True, lora_rank=2,
                            all_trainable=True),
        "fcdp_int8_f32": ModeRun("fcdp", INT8, INT8, dtype=F32, peft=True,
                                 steps=2, lora_rank=8)}
JAX_IDS = ["fcdp", "zero3", "zeropp", "mics", "mixed", "fcdp_int8_f32"]
PEFT_IDS = JAX_IDS
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, PEFT_MODEL["vocab_size"],
                       (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, PEFT_MODEL["vocab_size"],
                          (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


BATCHES = [make_batch(0), make_batch(1)]


def _jax_bundle(mr):
    from repro.core.peft import unfreeze_all
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])
    run = JRunConfig(model=JModelConfig(**PEFT_MODEL),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=JSystemConfig(
                         mode=mr.mode, min_shard_size=8, peft=True,
                         lora_rank=mr.lora_rank,
                         mode_overrides=mr.mode_overrides,
                         param_compress=mr.param_compress,
                         grad_compress=mr.grad_compress, quant_impl="jnp",
                         param_dtype=mr.dtype, compute_dtype=mr.dtype),
                     optimizer=JOptimizerConfig(**OPT))
    return JStepBundle(run, mesh,
                       defs_fn=unfreeze_all if mr.all_trainable else None)


def _jax_run(mr):
    """Metrics, trainable parameters after each step and the bytes per
    (op, axis) of the step, traced on the arrays it runs."""
    b = _jax_bundle(mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    tp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in tp]
    fp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in fp]
    opt = jax.jit(functools.partial(j_init_opt_state, sys=b.run.system))(tp)
    step = b.make_train_step()
    sizes = {a: b.mi.size(a) for a in b.mi.axis_names}
    stats = collect_collectives(step.trace(tp, fp, opt, BATCHES[0]).jaxpr,
                                sizes)
    labels = [b.def_leaves[i].label for i in b.train_idx]
    out = {"metrics": [], "params": [],
           "bytes": {k: v for k, v in stats.by_op_axis.items() if v}}
    for s in range(mr.steps):
        tp, opt, m = step(tp, fp, opt, BATCHES[s])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append({p: np.asarray(x, np.float32)
                              for p, x in zip(labels, tp)})
    return out


def _jax_init_tree(lora_rank):
    b = _jax_bundle(ModeRun("fcdp", peft=True, lora_rank=lora_rank))
    leaves = [np.asarray(x) for x in b.init_all_params(seed=0)]
    return jax.tree.unflatten(b.treedef, leaves)


def _compute_runs(tmp_path_factory):
    """The JAX steps first, then one 4-rank job per adapter rank."""
    ref = {rid: _jax_run(RUNS[rid]) for rid in JAX_IDS}
    out, init = {}, {}
    for rank in sorted({mr.lora_rank for mr in RUNS.values()}):
        ids = [rid for rid, mr in RUNS.items() if mr.lora_rank == rank]
        init[rank] = _jax_init_tree(rank)
        job = TrainJob(
            run=RunConfig(model=ModelConfig(**PEFT_MODEL),
                          shape=ShapeCell("t", "train", SEQ, BATCH),
                          system=SystemConfig(min_shard_size=8),
                          optimizer=OptimizerConfig(**OPT)),
            mesh=MESH, runs=[RUNS[rid] for rid in ids], device="cpu",
            params=init[rank], batches=BATCHES, return_params=True)
        ranks = spawn(job, str(tmp_path_factory.mktemp("rdzv")),
                      timeout_s=900)
        out.update({rid: (ref.get(rid), [rk["runs"][i] for rk in ranks])
                    for i, rid in enumerate(ids)})
    init = {rank: {p: np.asarray(a) for p, a in tree_items(t)}
            for rank, t in init.items()}
    return out, init


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_peft_runs",
                         lambda: _compute_runs(tmp_path_factory))


@pytest.fixture(scope="module")
def runs(results):
    return results[0]


@pytest.fixture(scope="module")
def init_trees(results):
    """The initial full parameters (path -> array) per adapter rank."""
    return results[1]


def _full(ranks, key):
    """Full parameters (path -> float32 array) from every rank's shards
    after the first step (``params``) or the last (``final_params``)."""
    specs = ranks[0]["specs"]
    return {path: assemble({r: torch.from_numpy(res[key][path])
                            for r, res in enumerate(ranks)},
                           specs[path], MESH).numpy()
            for path in specs}


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("rid", JAX_IDS)
def test_step_matches_jax(runs, rid, step):
    """Loss, grad norm and the updated adapters after steps 1 and 2:
    ``lora_b`` starts at zero, so step 1's loss is the trunk's alone,
    and only the updated parameters and step 2 see the adapters."""
    ref, ranks = runs[rid]
    m, mj = ranks[0]["metrics"][step - 1], ref["metrics"][step - 1]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{rid} loss")
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL, err_msg=f"{rid} grad norm")
    assert m["tokens"] == mj["tokens"] == BATCH * SEQ
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _full(ranks, "params" if step == 1 else "final_params")
    want = ref["params"][step - 1]
    assert want and all("_lora_" in p for p in want)
    for path, w in want.items():
        np.testing.assert_allclose(params[path], w, **PARAM_TOL,
                                   err_msg=f"{rid} step {step} {path}")


@pytest.mark.parametrize("rid", JAX_IDS)
def test_bytes_per_axis_match_jax(runs, rid):
    """Every (op, axis) byte count of both steps on every rank equals
    the JAX trace of the step."""
    ref, ranks = runs[rid]
    for rank, r in enumerate(ranks):
        for s, got in enumerate(r["bytes"]):
            assert got == ref["bytes"], (rid, rank, s)


def test_fcdp_pod_gather_is_under_one_percent_of_zero3(runs):
    """FCDP-Comm: fcdp's frozen trunk is stored pod-replicated, so only
    the four sharded adapters of each layer cross 'pod' (2 x 4 x 256
    bytes) against zero3's trunk gathered in the forward and again in
    the backward; the mixed arm gathers its adapters twice."""
    pod = {rid: runs[rid][1][0]["bytes"][0]["all_gather/pod"]
           for rid in ("fcdp", "zero3", "zeropp", "mixed")}
    assert pod == {"fcdp": 2048, "zero3": 2036864, "zeropp": 1051264,
                   "mixed": 4096}
    assert pod["fcdp"] <= 0.01 * pod["zero3"]
    assert pod["mixed"] <= 0.01 * pod["zero3"]
    assert "all_gather/pod" not in runs["mics"][1][0]["bytes"][0]


def test_adapters_equal_the_all_trainable_arm_bit_for_bit(runs):
    """After one step fcdp's adapters equal those of the same tree with
    every leaf trainable, on every rank: freezing the trunk changes
    what is stored and moved, not the adapters' arithmetic."""
    peft, ref = runs["fcdp"][1], runs["fcdp_all"][1]
    for p, a in zip(peft, ref):
        adapters = [path for path in p["params"] if "_lora_" in path]
        assert len(adapters) == 8
        for path in adapters:
            assert np.array_equal(p["params"][path], a["params"][path]), \
                path
        assert a["params_trainable"] == a["params_total"]


@pytest.mark.parametrize("rid", PEFT_IDS)
def test_frozen_leaves_are_unchanged(runs, init_trees, rid):
    """Every frozen leaf after two steps equals its initial value bit for
    bit (in the run's dtype), and some ``lora_b`` left zero."""
    _, ranks = runs[rid]
    assert all(r["frozen_unchanged"] for r in ranks), rid
    assert any(r["lora_b_moved"] for r in ranks), rid
    init = init_trees[RUNS[rid].lora_rank]
    final = _full(ranks, "final_params")
    frozen = [p for p in final if "_lora_" not in p]
    assert len(frozen) == 12
    for path in frozen:
        # the bf16 draws, exact in either run dtype
        want = init[path].astype(np.float32)
        assert np.array_equal(final[path], want), (rid, path)


def test_trainable_fraction_is_under_one_percent(runs):
    r = runs["fcdp"][1][0]
    assert r["params_trainable"] == 2 * (4 * 256 * 2 + 2 * 256 + 2 * 2 * 128
                                         + 256 * 2)
    assert r["params_trainable"] / r["params_total"] < 0.01


def test_int8_runs_on_the_adapters_only(runs):
    """At rank 8 the sharded adapters (wq/wk/wv_lora_a, wo_lora_b: 512
    elements a per-layer shard) carry qwZ and qgZ; the frozen trunk
    stays exact. One quantize and one dequantize per gather, one
    quantize and one dequant-accumulate per reduce: 4 leaves x 2 layers.
    On the CPU the plain versions run, so no kernel launches."""
    r0 = runs["fcdp_int8_f32"][1][0]
    assert r0["int8_plan"] == {"quantize": 16, "dequantize": 8,
                               "dequant_accumulate": 8}
    for rid in RUNS:
        for r in runs[rid][1]:
            for calls, launches in zip(r["calls"], r["launches"]):
                assert calls == r["int8_plan"], rid
                assert not any(launches.values()), rid
            if rid != "fcdp_int8_f32":
                assert not any(r["int8_plan"].values()), rid
    assert runs["fcdp_int8_f32"][0]["bytes"]["all_to_all/pod"] > 0


@pytest.mark.parametrize("rid,host", [
    ("fcdp", True), ("mixed", True), ("zero3", False), ("mics", False)])
def test_frozen_trunk_waits_on_the_host_under_fcdp(runs, rid, host):
    """fcdp parks each frozen trunk weight fully gathered on the host
    tier (pod-replicated storage: no stage 1, ``cache_after`` 2), so
    the backward copies it back with no regather; zero3 and mics cache
    nothing. The adapters' stage-1 caches join fcdp's host tier (the
    mixed arm's adapters are zero3's and regather)."""
    # per layer: the bf16 matrices and the two norm scales, which the
    # layers read in fp32
    trunk = 2 * (256 * (256 + 128 + 128 + 256 + 3 * 1024) * 2 + 2 * 256 * 4)
    adapters = 2 * 4 * (256 * 2 // 2) * 2
    for r in runs[rid][1]:
        if not host:
            assert r["cached"][0] == {}
            continue
        want = trunk + (adapters if rid == "fcdp" else 0)
        assert r["cached"][0] == {"host": want}, rid
        assert r["cache_places"][0] == {"host": [("cpu", False)]}
