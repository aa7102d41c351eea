"""The port's checkpoint/restart path (``runtime/fault_tolerance.py``,
``runtime/elastic.py``, ``launch/train.py``'s ``RunState`` and
``drive``): the port counterparts of ``tests/test_restart.py``, on the
CPU.

``run_with_restarts``: the flush before the restore, a failing flush
swallowed, the consecutive-failure counter reset after a clean
interval. ``remesh`` over the surviving ranks.

The schedule's cases, on 8 gloo ranks at (2, 2, 2) (in the spawn
``tests/test_torch_checkpoint.py`` shares): ``tests/test_restart.py``'s
``DENSE`` model under fcdp with streams 2 and 3 at microbatch 2, over
its per-step batches, each case held to the port's own uninterrupted
piped run (the JAX package's ``build_train_piped`` does not trace on
this JAX, so its cases that run it fail there):

  * a checkpoint taken mid-pipeline (carry section present, the mesh in
    ``meta``) restored into a fresh ``RunState`` resumes to the same
    losses and shards bit for bit;
  * a crash past a checkpoint replays to the same losses and shards;
  * the pipeline off at restore drops the carry, and the fused async
    step re-run from ``saved_step - 1`` lands on the uninterrupted
    run's shards bit for bit;
  * a downscale that loses 'pod' ((4, 2) on the same 8 ranks) drops the
    carry and resumes fused, with finite losses;
  * the elastic downscale (2, 2, 2) -> (2, 1, 2), on 4 ranks spawned
    after: the carry dropped, the parameters and optimizer state
    restored bit for bit (saved again, byte-equal to the source
    checkpoint), the run re-primed at ``saved_step - 1`` and tracking
    the uninterrupted one (losses rtol 3e-4, parameters rtol 2e-2 /
    atol 3e-4: another mesh sums in another order).

The driver: qwen2.5-3b SMOKE at seq 64, batch 8, 7 steps, a checkpoint
every 3, through ``spawn(TrainJob)`` with a ``ckpt_dir`` (the launcher's
``drive``), fused and piped at microbatch 2: a failure injected at step
5 replays from the step-3 checkpoint to the uninterrupted run's
per-step losses and final shards bit for bit.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.launch.mesh import MeshShape
from repro_torch.runtime.elastic import remesh, surviving_mesh_shape
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 run_with_restarts)

AXES = ("pod", "data", "model")
DENSE = dict(name="t-dense", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
SEQ, BATCH, NM = 64, 8, 2
RUN = RunConfig(model=ModelConfig(**DENSE),
                shape=ShapeCell("t", "train", SEQ, BATCH),
                system=SystemConfig(min_shard_size=8),
                optimizer=OptimizerConfig(total_steps=8, warmup_steps=2,
                                          lr=1e-3))
XSTEP = dict(mode="fcdp", async_grad_reduce=True, cross_step_pipeline=True)
N_BATCHES = 6
DRIVER_STEPS, DRIVER_EVERY, DRIVER_FAIL = 7, 3, 5
SCHEDULES = {"fused": dict(),
             "piped": dict(async_grad_reduce=True, cross_step_pipeline=True)}


def make_batches(n, vocab=256):
    """``tests/test_restart.py:make_batches`` as numpy."""
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        out.append({"ids": rng.integers(1, vocab, (BATCH, SEQ))
                    .astype(np.int32),
                    "labels": rng.integers(1, vocab, (BATCH, SEQ))
                    .astype(np.int32),
                    "mask": np.ones((BATCH, SEQ), bool)})
    return out


# -- the ranks' side (called from tests/test_torch_checkpoint.py's spawn) --

def _state(mesh, coll, device, **kw):
    from repro_torch.launch.train import ModeRun, RunState, TrainJob
    job = TrainJob(run=RUN, mesh=mesh.mesh_shape, runs=[], device="cpu",
                   batches=make_batches(N_BATCHES))
    return RunState(job, ModeRun(microbatch=NM, **dict(XSTEP, **kw)), mesh,
                    coll, device)


def _run(st, start, stop, losses=None):
    for s in range(start, stop):
        m = st.do_train_step(st.batch(s))
        if losses is not None:
            losses[s] = m["loss"]
    return losses


def _save(path, step, st):
    from test_torch_checkpoint import _ckpt
    from repro_torch.runtime.elastic import mesh_meta
    ck = _ckpt(path)
    tree = st.state_tree()
    ck.save(step, tree, meta=mesh_meta(st.bundle),
            blocks=st.bundle.state_blocks(tree))
    return ck


def _restore(ck, step, st):
    from repro_torch.runtime.elastic import reshard_state
    state, invalidated = reshard_state(ck, step, st.bundle,
                                       {"params": st.train_p, "opt": st.opt})
    st.load_state(state)
    return {"invalidated": invalidated, "carry": "carry" in state,
            "cross_step": st.cross_step}


def scenarios(root, mesh, coll, device):
    """The schedule's cases on the 8 ranks at (2, 2, 2)."""
    from repro_torch.core.collectives import Collectives
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.train import state_digest
    root = Path(root) / "restart"
    out = {}

    def state(**kw):
        return _state(mesh, coll, device, **kw)

    # the uninterrupted run, checkpointed mid-pipeline at steps 3 and 4
    ref = state()
    losses = _run(ref, 0, 3, {})
    crash = _save(root / "crash", 3, ref)
    _run(ref, 3, 4, losses)
    mid = _save(root / "mid", 4, ref)
    out["mid"] = {"saved_carry": ref.carry is not None}
    _run(ref, 4, N_BATCHES, losses)
    # its shards after batch 5's piped call hold the updates of batches
    # 0-4: those of a 5-batch run, flushed
    out["ref5"] = {"digest": state_digest(ref.params)}
    ref.flush_carry()
    out["ref6"] = {"losses": losses, "digest": state_digest(ref.params)}
    _save(root / "ref6", N_BATCHES, ref)
    del ref
    # the mid-pipeline checkpoint restored into a fresh state
    r = state()
    out["mid"].update(_restore(mid, 4, r))
    out["mid"]["losses"] = _run(r, 4, N_BATCHES, {})
    r.flush_carry()
    out["mid"]["digest"] = state_digest(r.params)
    # a crash past the step-3 checkpoint: replay from it
    r = state()
    out["crash"] = _restore(crash, 3, r)
    out["crash"]["losses"] = _run(r, 3, N_BATCHES, {})
    r.flush_carry()
    out["crash"]["digest"] = state_digest(r.params)
    # the pipeline off at restore: re-run step 3 fused, then step 4
    r = state(cross_step_pipeline=False)
    out["pipe_off"] = _restore(mid, 4, r)
    _run(r, 3, 5)
    out["pipe_off"]["digest"] = state_digest(r.params)
    # a downscale that loses 'pod': (data 4, model 2) on the same ranks
    rm = RankMesh(MeshShape(("data", "model"), (4, 2)), mesh.backend)
    r = _state(rm, Collectives(rm), device)
    out["no_pod"] = _restore(crash, 3, r)
    out["no_pod"]["losses"] = _run(r, 2, 4, {})
    return out


def _elastic_task(root, job, mesh, coll, device, state):
    """The 4 ranks at (2, 1, 2): the mid-pipeline checkpoint restored,
    saved again, re-primed at step 3 and run to the end."""
    from test_torch_checkpoint import _ckpt
    root = Path(root) / "restart"
    r = _state(mesh, coll, device)
    out = _restore(_ckpt(root / "mid"), 4, r)
    _save(root / "elastic_restored", 4, r)
    out["losses"] = _run(r, 3, N_BATCHES, {})
    r.flush_carry()
    _save(root / "elastic_final", N_BATCHES, r)
    return out


def elastic_job(root):
    from repro_torch.launch.train import TrainJob
    return TrainJob(run=RUN, mesh=MeshShape(AXES, (2, 1, 2)), runs=[],
                    device="cpu",
                    task=functools.partial(_elastic_task, str(root)))


def driver_job(root):
    """The driver's runs: qwen2.5-3b SMOKE, fused and piped, clean and
    with a failure at step 5, each through ``drive``."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import ModeRun, TrainJob
    run = RunConfig(model=get_smoke_config("qwen2.5-3b"),
                    shape=ShapeCell("train", "train", SEQ, BATCH),
                    system=SystemConfig(min_shard_size=8),
                    optimizer=OptimizerConfig(lr=1e-3,
                                              total_steps=DRIVER_STEPS,
                                              warmup_steps=1))
    runs = [ModeRun("fcdp", microbatch=NM, steps=DRIVER_STEPS,
                    ckpt_dir=str(Path(root) / "driver" / f"{sched}-{tag}"),
                    ckpt_every=DRIVER_EVERY, fail_at=fail, **kw)
            for sched, kw in SCHEDULES.items()
            for tag, fail in (("clean", ()), ("crash", (DRIVER_FAIL,)))]
    return TrainJob(run=run, mesh=MeshShape(AXES, (2, 2, 2)), runs=runs,
                    device="cpu")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from test_torch_checkpoint import shared_runs
    return shared_runs(tmp_path_factory)


def _cases(shared, name):
    return [r["task"]["restart"][name] for r in shared["ranks"]]


def _global(d, step):
    """{leaf path: global array as float32 (bf16 decoded)} of a
    checkpoint directory."""
    d = Path(d) / f"step_{step:08d}"
    man = json.loads((d / "manifest.json").read_text())
    out = {}
    for i, l in enumerate(man["leaves"]):
        a = np.load(d / f"leaf_{i:05d}.npy")
        if l["dtype"] == "bfloat16":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                .float().numpy()
        out[l["path"]] = a
    return man, out


# -- run_with_restarts ---------------------------------------------------------

def test_flush_fn_runs_before_restore_on_failure():
    events = []
    inj = FailureInjector(fail_at_steps=(2,))

    def step_fn(step):
        inj.maybe_fail(step)
        events.append(("step", step))

    def save(step):
        events.append(("save", step))

    def restore():
        events.append(("restore",))
        return 0

    def flush():
        events.append(("flush",))

    res = run_with_restarts(4, step_fn, save, restore, checkpoint_every=10,
                            flush_fn=flush)
    assert res["final_step"] == 4 and res["restarts"] == 1
    i = events.index(("flush",))
    assert events[i - 1] == ("step", 1)
    assert events[i + 1] == ("restore",)


def test_flush_fn_failure_is_swallowed():
    inj = FailureInjector(fail_at_steps=(1,))

    def step_fn(step):
        inj.maybe_fail(step)

    def flush():
        raise RuntimeError("the carry is gone")

    res = run_with_restarts(3, step_fn, lambda s: None, lambda: 0,
                            checkpoint_every=10, flush_fn=flush)
    assert res["final_step"] == 3


def test_restart_counter_resets_after_clean_interval():
    ckpt = {"step": 0}

    def save(step):
        ckpt["step"] = step

    inj = FailureInjector(fail_at_steps=(1, 11, 21, 31, 41))

    def step_fn(step):
        inj.maybe_fail(step)

    res = run_with_restarts(50, step_fn, save, lambda: ckpt["step"],
                            checkpoint_every=5, max_restarts=2)
    assert res["final_step"] == 50
    assert res["restarts"] == 5
    assert res["consecutive_restarts"] == 0

    class AlwaysFail(Exception):
        pass

    def bad_step(step):
        raise AlwaysFail()

    with pytest.raises(AlwaysFail):
        run_with_restarts(10, bad_step, lambda s: None, lambda: 0,
                          checkpoint_every=5, max_restarts=2)


def test_remesh_uses_only_surviving_ranks():
    """The mesh of 4 survivors at tp 2 covers exactly 4 ranks; 300
    survivors at tp 16 give an (18, 16) mesh of 288 (the other 12 stay
    out); the shapes equal the JAX package's."""
    from repro.runtime.elastic import surviving_mesh_shape as jshape
    m = remesh(4, tp=2)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 2} and m.world == 4
    assert remesh(300, tp=16).world == 288
    for n, tp in ((4, 2), (300, 16), (512, 16), (1030, 8), (1, 16)):
        assert surviving_mesh_shape(n, tp) == jshape(n, tp)


# -- the schedule's cases ------------------------------------------------------

def test_mid_pipeline_checkpoint_roundtrip_bit_exact(shared):
    """A checkpoint taken mid-pipeline (the carry section in the
    manifest, the mesh in meta) restored into a fresh RunState resumes
    with losses and final shards bit-identical to the uninterrupted
    run."""
    man, _ = _global(Path(shared["root"]) / "restart" / "mid", 4)
    assert any(l["section"] == "carry" for l in man["leaves"])
    assert man["meta"]["mesh"] == {"shape": [2, 2, 2],
                                   "axes": ["pod", "data", "model"]}
    for ref, mid in zip(_cases(shared, "ref6"), _cases(shared, "mid")):
        assert mid["saved_carry"] and mid["carry"]
        assert not mid["invalidated"]
        assert mid["losses"] == {k: ref["losses"][k] for k in (4, 5)}
        assert mid["digest"] == ref["digest"]


def test_crash_between_checkpoints_replays_bit_exact(shared):
    for ref, c in zip(_cases(shared, "ref6"), _cases(shared, "crash")):
        assert c["carry"] and not c["invalidated"]
        assert c["losses"] == {k: ref["losses"][k] for k in (3, 4, 5)}
        assert c["digest"] == ref["digest"]


def test_restore_with_pipeline_off_drops_carry(shared):
    """The pipeline off at restore: the carry is dropped, and re-running
    step 3 under the fused async step re-derives the update it held:
    the shards equal the uninterrupted run's after 5 batches bit for
    bit."""
    for ref, c in zip(_cases(shared, "ref5"), _cases(shared, "pipe_off")):
        assert c["invalidated"] and not c["carry"] and not c["cross_step"]
        assert c["digest"] == ref["digest"]


def test_no_pod_downscale_also_invalidates(shared):
    for c in _cases(shared, "no_pod"):
        assert c["invalidated"] and not c["carry"] and not c["cross_step"]
        assert sorted(c["losses"]) == [2, 3]
        assert all(np.isfinite(v) for v in c["losses"].values())


def test_elastic_downscale_invalidates_carry_and_reprimes(shared):
    """(2, 2, 2) -> (2, 1, 2) on 4 ranks: the carry dropped, the
    parameters and optimizer state restored bit for bit (their files
    saved again equal the source checkpoint's), the run re-primed at
    step 3, tracking the uninterrupted run."""
    root = Path(shared["root"]) / "restart"
    for c in shared["elastic"]:
        assert c["invalidated"] and not c["carry"] and c["cross_step"]
    man, saved = _global(root / "mid", 4)
    _, again = _global(root / "elastic_restored", 4)
    kept = {p: a for p, a in saved.items() if not p.startswith("['carry']")}
    assert kept.keys() == again.keys()
    for p in kept:
        np.testing.assert_array_equal(again[p], kept[p], err_msg=p)
    ref = _cases(shared, "ref6")[0]["losses"]
    losses = shared["elastic"][0]["losses"]
    assert sorted(losses) == [3, 4, 5]
    np.testing.assert_allclose([losses[k] for k in (4, 5)],
                               [ref[k] for k in (4, 5)], rtol=3e-4)
    _, want = _global(root / "ref6", N_BATCHES)
    _, got = _global(root / "elastic_final", N_BATCHES)
    for p in want:
        if p.startswith("['params']"):
            np.testing.assert_allclose(got[p], want[p], rtol=2e-2,
                                       atol=3e-4, err_msg=p)


# -- the driver ------------------------------------------------------------------

@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_driver_crash_resume_parity(shared, schedule):
    """A run through the launcher's driver killed at step 5 by the
    FailureInjector and restarted from the step-3 checkpoint: the same
    per-step losses and final shards bit for bit as the uninterrupted
    run; on the piped schedule the restored checkpoint carried the
    carry."""
    i = list(SCHEDULES).index(schedule) * 2
    for r in shared["ranks"]:
        clean, crash = r["runs"][i], r["runs"][i + 1]
        assert clean["restart"]["restarts"] == 0
        assert crash["restart"]["restarts"] == 1
        assert crash["restart"]["restored"] == [{
            "step": DRIVER_EVERY, "resume": DRIVER_EVERY,
            "carry": schedule == "piped", "carry_invalidated": False}]
        assert crash["restart"]["losses"] == clean["restart"]["losses"]
        assert sorted(clean["restart"]["losses"]) == list(range(DRIVER_STEPS))
        assert crash["final_digest"] == clean["final_digest"]
        assert clean["restart"]["ckpt_steps"] == [3, 6, 7]
        assert clean["kinds"][-1] == ("flush" if schedule == "piped"
                                      else "step")
