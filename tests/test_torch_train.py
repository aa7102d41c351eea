"""The port's sequential FCDP train step against the JAX package's, on
the CPU.

Both packages train ``tests/test_system.py``'s ``DENSE`` model (2
layers, d_model 64, GQA 4/2, vocab 256) on the ``CELL`` batch (seq 64,
batch 8, ``make_batch``) with ``min_shard_size=8``, on a (pod 2, data 2,
model 1) mesh: the JAX step on four CPU devices, the port on four gloo
ranks spawned once for the module, which run every mode in turn. Each
mode's first step is held to the JAX step; fcdp and fcdp+int8 run two
more steps for the int8 drift bound, and fcdp also runs with two
microbatches (gradient accumulation) and once with the loss in
sequence chunks and bf16 master weights and moments. The gather-fused
collective matmul runs under fcdp, zero3 and mics in mode 'ag_matmul'
(fcdp for three steps, against the unfused fcdp run bit for bit) and
under fcdp and zero3 in mode 'both'; the JAX side runs it with
``fused_impl="jnp"``, the oracle its Pallas kernel is bit-exact to. The
port starts from the JAX bundle's parameters, cut into each rank's
shards by ``repro_torch.convert.shards_from_jax``.

Tolerances are ``tests/test_system.py``'s across modes, for the same
reason: the fp32 reductions (the collectives' sums, the matmuls'
accumulations) are taken in another order. Loss rtol 1e-4, grad norm
rtol 1e-3, updated parameters rtol 2e-2 / atol 2e-3. The int8 run is
held to the JAX step with ``quant_impl="jnp"``, the oracle the JAX
package's Pallas kernels are bit-exact against (its interpret-mode
kernels fail inside the train step's ``shard_map`` on jax 0.9.0), in
fp32 weights and activations. In bf16 the qwZ-dequantized weights (a
multiple of one scale per 256-block) put many bf16 matmul outputs on
rounding ties that XLA's and PyTorch's CPU matmuls break apart: the
exact bf16 step from those same dequantized weights differs between
the packages by as much (grad norm 1.1e-3 relative) as the int8 runs
do, while each package's int8 step equals its exact step on them. So
the bf16 int8 run is held to the bf16 exact run (drift), the byte table
and the int8 call counts, and the fp32 one to the JAX step.

The reference and the port run one after the other, never at once: a
JAX step running in one thread while another drives the spawned ranks
crashed the test process under pytest-xdist (a segmentation fault in
the JAX half's ``np.asarray``). The results are computed once per test
session (``shared_result``): under xdist the first worker that needs
them computes them while the others wait on a file lock, so no two
workers run the 4-rank job at once.

Byte counts per step and (op, axis) are held exactly to the JAX
package's ``collect_collectives`` of the same step and to the table
below (bytes per device per step; an all-gather counts its output
bytes, a ppermute all of its input bytes per hop, every other op its
input bytes, in both packages). The fused ring is byte-neutral: the
forward gathers of ``wo`` and ``w_out`` (2 layers x (4,096 + 8,192)
bytes) leave ``all_gather/data`` for ``ppermute/data``; 'both' also
moves the backward gathers and the dw reduce-scatters into the ring.
"""
import fcntl
import functools
import os
import pickle
import traceback

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
from repro_torch.core.partition import block_index, shard_of, tree_items
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn

DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
SEQ, BATCH = 64, 8
MESH = MeshShape(("pod", "data", "model"), (2, 2, 1))
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
INT8, F32 = "int8_pod", "float32"
RUNS = {"zero3": ModeRun("zero3"), "zeropp": ModeRun("zeropp"),
        "fcdp": ModeRun("fcdp", steps=3), "mics": ModeRun("mics"),
        "fcdp_int8": ModeRun("fcdp", INT8, INT8, steps=3),
        "fcdp_int8_f32": ModeRun("fcdp", INT8, INT8, dtype=F32),
        "fcdp_mb2": ModeRun("fcdp", microbatch=2),
        "fcdp_chunk_bf16opt": ModeRun("fcdp", loss_chunk=16,
                                      master_dtype="bfloat16",
                                      opt_state_dtype="bfloat16"),
        "fcdp_ag": ModeRun("fcdp", steps=3, fused_matmul="ag_matmul"),
        "zero3_ag": ModeRun("zero3", fused_matmul="ag_matmul"),
        "mics_ag": ModeRun("mics", fused_matmul="ag_matmul"),
        "fcdp_both": ModeRun("fcdp", fused_matmul="both"),
        "zero3_both": ModeRun("zero3", fused_matmul="both")}
FUSED_IDS = ["fcdp_ag", "zero3_ag", "mics_ag", "fcdp_both", "zero3_both"]
BF16_IDS = ["zero3", "zeropp", "fcdp", "mics", "fcdp_int8"] + FUSED_IDS
# held to the JAX step: the exact modes in bf16, the int8 run in fp32
# (see the module docstring)
JAX_IDS = ["zero3", "zeropp", "fcdp", "mics", "fcdp_int8_f32", "fcdp_mb2",
           "fcdp_chunk_bf16opt"] + FUSED_IDS

_Z3 = {"all_gather/pod": 90400, "all_gather/data": 180800,
       "psum_scatter/pod": 53408, "psum_scatter/data": 106816,
       "psum/pod": 264, "psum/data": 528}
_CACHED = dict(_Z3, **{"all_gather/pod": 53408})
BYTES = {
    "zero3": _Z3,
    "zeropp": _CACHED,
    "fcdp": _CACHED,
    "mics": {"all_gather/data": 180800, "psum_scatter/data": 106816,
             "psum/pod": 214536, "psum/data": 528},
    "fcdp_int8": dict(_CACHED, **{"all_gather/pod": 27200,
                                  "psum_scatter/pod": 160,
                                  "all_to_all/pod": 27040}),
}
_AG = {"all_gather/data": 156224, "ppermute/data": 24576}
_BOTH = {"all_gather/data": 131648, "ppermute/data": 73728,
         "psum_scatter/data": 82240}
BYTES.update({"fcdp_ag": dict(_CACHED, **_AG), "zero3_ag": dict(_Z3, **_AG),
              "mics_ag": dict(BYTES["mics"], **_AG),
              "fcdp_both": dict(_CACHED, **_BOTH),
              "zero3_both": dict(_Z3, **_BOTH)})
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)


def make_batch(seed=0):
    """``tests/test_system.py:make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, DENSE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, DENSE["vocab_size"],
                          (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


def _jax_bundle(mr):
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4])
    run = JRunConfig(model=JModelConfig(**DENSE),
                     shape=JShapeCell("t", "train", SEQ, BATCH),
                     system=JSystemConfig(
                         mode=mr.mode, min_shard_size=8,
                         param_compress=mr.param_compress,
                         grad_compress=mr.grad_compress, quant_impl="jnp",
                         param_dtype=mr.dtype, compute_dtype=mr.dtype,
                         loss_chunk=mr.loss_chunk,
                         master_dtype=mr.master_dtype,
                         opt_state_dtype=mr.opt_state_dtype,
                         fused_matmul=mr.fused_matmul, fused_impl="jnp"),
                     optimizer=JOptimizerConfig(**OPT),
                     microbatch=mr.microbatch)
    return JStepBundle(run, mesh)


def _jax_run(mr, batch):
    b = _jax_bundle(mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    # the same bf16 draws, widened where the run is fp32
    tp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in tp]
    opt = jax.jit(functools.partial(j_init_opt_state, sys=b.run.system))(tp)
    step = b.make_train_step()
    sizes = {a: b.mi.size(a) for a in b.mi.axis_names}
    stats = collect_collectives(step.trace(*b.train_input_sds()).jaxpr,
                                sizes)
    tp, opt, m = step(tp, fp, opt, batch)
    full = jax.tree.unflatten(b.treedef, [np.asarray(x, np.float32)
                                          for x in tp])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": dict(tree_items(full)),
            "opt_dtypes": {k: str(opt[k][0].dtype)
                           for k in ("m", "v", "master")},
            "bytes": {k: v for k, v in stats.by_op_axis.items() if v}}


def _jax_init_tree():
    b = _jax_bundle(ModeRun("fcdp"))
    leaves = [np.asarray(x) for x in b.init_all_params(seed=0)]
    return jax.tree.unflatten(b.treedef, leaves)


def shared_result(tmp_path_factory, name, compute):
    """``compute()``'s result, computed once per test session. Under
    pytest-xdist the first worker to take the lock (a file in the
    session's base temporary directory, which every worker shares)
    computes and pickles it, and the others wait and read it; a failure
    is shared the same way."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    done = root / f"{name}.pickle"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            try:
                out = ("ok", compute())
            except Exception:
                out = ("error", traceback.format_exc())
            part = done.with_suffix(".part")
            part.write_bytes(pickle.dumps(out))
            part.rename(done)
        status, value = pickle.loads(done.read_bytes())
    if status != "ok":
        raise RuntimeError(f"{name} failed where it was computed:\n{value}")
    return value


def _compute_runs(tmp_path_factory):
    """Both packages' results per run id: the JAX steps first, then the
    port's four ranks."""
    batch = make_batch()
    ref = {rid: _jax_run(RUNS[rid], batch) for rid in JAX_IDS}
    job = TrainJob(
        run=RunConfig(model=ModelConfig(**DENSE),
                      shape=ShapeCell("t", "train", SEQ, BATCH),
                      system=SystemConfig(min_shard_size=8),
                      optimizer=OptimizerConfig(**OPT)),
        mesh=MESH, runs=list(RUNS.values()), device="cpu",
        params=_jax_init_tree(),
        batches=[batch] * max(r.steps for r in RUNS.values()),
        return_params=True)
    ranks = spawn(job, str(tmp_path_factory.mktemp("rdzv")), timeout_s=900)
    return {rid: (ref.get(rid), [rk["runs"][i] for rk in ranks])
            for i, rid in enumerate(RUNS)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_train_runs",
                         lambda: _compute_runs(tmp_path_factory))


def assemble(shards, spec, mesh):
    """The full tensor from every rank's block (rank -> block), the
    inverse of ``shard_of``; replicas of a block hold equal values."""
    first = next(iter(shards.values()))
    shape = list(first.shape)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        shape[dim] *= block_index(axes, mesh,
                                  {a: 0 for a in mesh.axis_names})[1]
    full = torch.empty(shape, dtype=first.dtype)
    for rank, block in shards.items():
        shard_of(full, spec, mesh, mesh.coords(rank)).copy_(block)
    return full


def _port_params(ranks):
    """Full parameters from every rank's shards."""
    specs = ranks[0]["specs"]
    return {path: assemble({r: torch.from_numpy(res["params"][path])
                            for r, res in enumerate(ranks)},
                           specs[path], MESH).numpy()
            for path in specs}


@pytest.mark.parametrize("rid", JAX_IDS)
def test_step_matches_jax(runs, rid):
    """The first step from the same weights and batch: loss, grad norm,
    the updated parameters and the optimizer state's types."""
    ref, ranks = runs[rid]
    m, mj = ranks[0]["metrics"][0], ref["metrics"]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{rid} loss")
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL, err_msg=f"{rid} grad norm")
    # with microbatches the JAX step reports tokens = 1
    assert m["tokens"] == mj["tokens"] == (1 if RUNS[rid].microbatch
                                           else BATCH * SEQ)
    # every rank reports the same global metrics
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert all(r["opt_dtypes"] == ref["opt_dtypes"] for r in ranks), rid
    params = _port_params(ranks)
    assert set(params) == set(ref["params"])
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{rid} {path}")


@pytest.mark.parametrize("rid", BF16_IDS)
def test_bytes_per_axis_match_jax(runs, rid):
    """Every (op, axis) byte count of every step equals the table and,
    for the modes the JAX step runs in bf16, its count of that step."""
    ref, ranks = runs[rid]
    if ref is not None:
        assert ref["bytes"] == BYTES[rid]
    for rank, r in enumerate(ranks):
        for s, got in enumerate(r["bytes"]):
            assert got == BYTES[rid], (rid, rank, s)


def test_microbatches_move_their_bytes_like_jax(runs):
    """Two microbatches: every gather and reduce-scatter runs per
    microbatch, as in the JAX scan; the counts equal its trace."""
    ref, ranks = runs["fcdp_mb2"]
    assert ranks[0]["bytes"][0] == ref["bytes"]
    assert ref["bytes"]["all_gather/pod"] == 2 * BYTES["fcdp"][
        "all_gather/pod"]


def test_fcdp_halves_the_pod_gather(runs):
    """FCDP's point: the backward reads the cached stage 1, so the pod
    all-gather is forward-only (53,408 vs zero3's 90,400 bytes), and
    qwZ/qgZ carry the pod transports in int8 blocks."""
    z3 = runs["zero3"][1][0]["bytes"][0]
    fc = runs["fcdp"][1][0]["bytes"][0]
    q8 = runs["fcdp_int8"][1][0]["bytes"][0]
    assert fc["all_gather/pod"] < z3["all_gather/pod"]
    assert fc["psum_scatter/pod"] == z3["psum_scatter/pod"]
    assert q8["all_gather/pod"] < 0.55 * fc["all_gather/pod"]
    assert q8["all_to_all/pod"] + q8["psum_scatter/pod"] \
        < 0.55 * fc["psum_scatter/pod"]


def test_int8_calls_match_the_plans(runs):
    """One quantize and one dequantize per qwZ gather, one quantize and
    one dequant-accumulate per qgZ reduce (16 leaf gathers: embed, head
    and 7 per layer), per step; none without int8. On the CPU the plain
    versions run, so the kernel launch counters stay at 0."""
    for rid in RUNS:
        for r in runs[rid][1]:
            for calls, launches in zip(r["calls"], r["launches"]):
                assert calls == r["int8_plan"], rid
                assert not any(launches.values()), rid
    assert runs["fcdp_int8"][1][0]["int8_plan"] == {
        "quantize": 32, "dequantize": 16, "dequant_accumulate": 16}
    assert not any(runs["fcdp"][1][0]["int8_plan"].values())


def test_int8_loss_drift(runs):
    """qwZ+qgZ track the exact fcdp run (test_quant.py's bound)."""
    exact = [m["loss"] for m in runs["fcdp"][1][0]["metrics"]]
    quant = [m["loss"] for m in runs["fcdp_int8"][1][0]["metrics"]]
    drift = max(abs(a - e) / abs(e) for a, e in zip(quant, exact))
    assert drift < 1e-2, (quant, exact)
    assert quant != exact


@pytest.mark.parametrize("rid,tier", [("fcdp", "host"), ("zeropp", "device"),
                                      ("zero3", None), ("mics", None),
                                      ("fcdp_int8", "host"),
                                      ("fcdp_ag", "host"),
                                      ("fcdp_both", "host"),
                                      ("zero3_ag", None), ("mics_ag", None)])
def test_stage1_cache_placement(runs, rid, tier):
    """What the layers keep for the backward: fcdp's stage-1 caches on
    the host tier (pinned on a card, plain CPU tensors here), zeropp's
    on the rank's device, none under zero3 and mics, which regather.
    A fused plan keeps the same stage-1 tensor (its collective matmul
    saves it, the layer scope parks it on its tier).
    Per rank: the two layers' stage-1 shards, 2 x 36,992 bf16 elements
    over 4 ranks x 2 (pod-gathered) = 73,984 bytes."""
    for r in runs[rid][1]:
        cached, places = r["cached"][0], r["cache_places"][0]
        if tier is None:
            assert cached == {} and places == {}
            continue
        assert cached == {tier: 73984}
        assert places == {tier: [("cpu", False)]}


def test_fused_ag_matmul_equals_unfused_bit_for_bit(runs):
    """Mode 'ag_matmul' on the CPU: the ring's chunk products are the
    same PyTorch matmul as the unfused one and its backward replays the
    unfused op sequence, so three steps give the unfused fcdp run's
    losses, grad norms and parameters to the bit, on every rank."""
    fused, plain = runs["fcdp_ag"][1], runs["fcdp"][1]
    for f, u in zip(fused, plain):
        assert len(f["metrics"]) == len(u["metrics"]) == 3
        assert f["metrics"] == u["metrics"]
        for path, want in u["final_params"].items():
            assert torch.equal(torch.from_numpy(f["final_params"][path]),
                               torch.from_numpy(want)), path


def test_fused_both_tracks_unfused(runs):
    """Mode 'both' reorders the dx sum: close to the unfused step (the
    JAX package's own bound for it, test_fused_matmul.py), not equal;
    its forward is the same, so the step-0 loss is."""
    both = runs["fcdp_both"][1][0]["metrics"][0]
    ag = runs["fcdp_ag"][1][0]["metrics"][0]
    plain = runs["fcdp"][1][0]["metrics"][0]
    assert both["loss"] == ag["loss"] == plain["loss"]
    assert _rel(both["grad_norm"], plain["grad_norm"]) < GNORM_RTOL


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_matmul_chunk_calls_match_the_plans(runs):
    """The fused ring calls the chunk matmul n = 2 times per fused leaf
    (wo, w_out) and layer in the forward, 3n under 'both': 8 and 24 per
    step on this model; none unfused. On the CPU the plain version runs,
    so the kernel's launch counter stays at 0."""
    want = {"fcdp_ag": 8, "zero3_ag": 8, "mics_ag": 8, "fcdp_both": 24,
            "zero3_both": 24}
    for rid in RUNS:
        for r in runs[rid][1]:
            assert r["mm_plan"] == want.get(rid, 0), rid
            assert r["mm_calls"] == [r["mm_plan"]] * RUNS[rid].steps, rid
            assert not any(r["mm_launches"]), rid


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_runs_under_torchrun_env_on_one_pod(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train`` reads torchrun's
    environment. One CPU rank without --multi-pod: a (data 1, model 1)
    mesh has no stage 1, so the cache boundary sits after stage 2 and
    fcdp keeps the whole gathered weight on the host; nothing crosses a
    wire. (The launcher resumes from the latest checkpoint in its
    --ckpt-dir, so the run gets a directory of its own.)"""
    from repro_torch.launch import train as launcher
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    res = launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "2",
                         "--batch", "2", "--seq-len", "32",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    r = res["runs"][0]
    assert res["backend"] == "gloo" and res["coords"] == {"data": 0,
                                                          "model": 0}
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    assert r["bytes"] == [{}, {}]
    assert set(r["cached"][0]) == {"host"} and r["cached"][0]["host"] > 0


@pytest.mark.parametrize("cards,local,world,want", [
    (8, 8, 16, "nccl"),     # two 8-card hosts, one rank per card
    (8, 8, 8, "nccl"),
    (1, 4, 4, "gloo"),      # four ranks share one card
    (4, 8, 16, "gloo"),     # two ranks per card on each host
])
def test_backend_follows_the_ranks_of_this_host(monkeypatch, cards, local,
                                                 world, want):
    """NCCL when no host runs more ranks than it has cards, whatever the
    world size; under torchrun the launcher reads LOCAL_WORLD_SIZE."""
    from repro_torch.core.collectives import pick_backend
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pick_backend(torch.device("cuda", 0), local) == want
    assert pick_backend(torch.device("cpu"), local) == "gloo"
    seen = {}

    def fake_run_job(job, rank, world_, local_world, init_method):
        seen.update(world=world_, local=local_world)
        raise SystemExit
    monkeypatch.setattr(launcher, "run_job", fake_run_job)
    for k, v in {"RANK": "0", "WORLD_SIZE": str(world),
                 "LOCAL_WORLD_SIZE": str(local)}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--multi-pod",
                       "--device", "cpu"])
    assert seen == {"world": world, "local": local}


def test_launcher_raises_without_cuda(monkeypatch):
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke"])


def test_synthetic_batches_equal_jax():
    """The same (seed, step) gives the same packed batch in both."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticPackedLM as JSynthetic
    from repro_torch.data.pipeline import DataConfig, SyntheticPackedLM
    cell = dict(name="t", kind="train", seq_len=SEQ, global_batch=BATCH)
    for seed, step in ((0, 0), (3, 5)):
        want = JSynthetic(JModelConfig(**DENSE), JShapeCell(**cell),
                          JDataConfig(seed)).batch_np(step)
        got = SyntheticPackedLM(ModelConfig(**DENSE), ShapeCell(**cell),
                                DataConfig(seed)).batch_np(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_each_rank_gets_the_jax_devices_rows():
    """``StepBundle.shard_batch`` hands the rank at mesh coordinates c
    the rows the JAX batch spec places on the device at c (split over
    the fsdp axes, data-major, pod minor)."""
    from jax.sharding import NamedSharding
    from repro_torch.core.engine import StepBundle
    jb = _jax_bundle(ModeRun("fcdp"))
    spec = jb.batch_spec(jb.run.shape)["ids"]
    ids = np.arange(BATCH * SEQ, dtype=np.int32).reshape(BATCH, SEQ)
    placed = jax.device_put(ids, NamedSharding(jb.mesh, spec))
    where = {d: idx for idx, d in np.ndenumerate(jb.mesh.devices)}
    pb = StepBundle(RunConfig(model=ModelConfig(**DENSE),
                              shape=ShapeCell("t", "train", SEQ, BATCH)),
                    device="cpu", mesh=MESH)
    for shard in placed.addressable_shards:
        p, d, m = where[shard.device]
        pb.coords = {"pod": p, "data": d, "model": m}
        got = pb.shard_batch({"ids": ids})["ids"].numpy()
        np.testing.assert_array_equal(got, np.asarray(shard.data))
