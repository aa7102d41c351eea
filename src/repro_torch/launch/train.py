"""Training launcher: the FCDP train step on a (pod, data, model)
mesh, tensor-parallel over 'model', one process per rank, under the JAX
package's checkpoint/restart driver (``drive``: checkpoints in its
format, failure injection with ``--fail-at``, the heartbeat and the
straggler monitor).

Under torchrun (world size and rank from its environment)::

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch qwen2.5-3b --smoke --multi-pod --device cpu

(8 ranks: a (pod 2, data 2, model 2) mesh, the JAX package's smoke mesh)

or spawned by a caller (``spawn``), which gives the ranks a
``FileStore`` rendezvous in a directory of its own and collects one
result per rank. The wire is NCCL when every rank has a card of its
own (no host runs more ranks than it has cards), gloo otherwise (``core.collectives.pick_backend``). Weights are
random, drawn from ``--seed``; batches are ``SyntheticPackedLM``'s.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import (SHAPE_CELLS, ModelConfig,
                                      OptimizerConfig, RunConfig, ShapeCell,
                                      shape_cell)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.cache import cache_bytes_per_chip
from repro_torch.core.collectives import Collectives, pick_backend
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.train import (act_int8_launch_plan,
                                           carry_bytes, int8_launch_plan,
                                           mamba_scan_launch_plan,
                                           matmul_chunk_launch_plan)
from repro_torch.core.partition import tree_items
from repro_torch.core.peft import unfreeze_all
from repro_torch.core.schedule import (async_buffer_bytes,
                                      cross_step_buffer_bytes,
                                      prefetch_buffer_bytes)
from repro_torch.data.pipeline import (DataConfig, ShardedLoader,
                                       SyntheticPackedLM, enc_embed_dim)
from repro_torch.kernels import ops
from repro_torch.launch.cli import add_system_args, system_config_from_args
from repro_torch.launch.mesh import (MeshShape, RankMesh, device_for_rank,
                                     train_mesh_shape)
from repro_torch.optim.adamw import init_opt_state
from repro_torch.runtime.elastic import mesh_meta, reshard_state
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 HeartbeatMonitor,
                                                 StragglerMonitor,
                                                 run_with_restarts)

TIMEOUT = timedelta(seconds=900)


@dataclass(frozen=True)
class ModeRun:
    """One run of the job: the strategy (``mode``, and the per-leaf
    ``mode_overrides`` rules), int8, dtype, loss-chunk and fused-matmul
    knobs of the system, PEFT (``peft``: frozen trunk and LoRA adapters
    of rank ``lora_rank`` scaled by ``lora_alpha`` / rank; with
    ``all_trainable`` every leaf of that tree trains, the reference
    arm), the transport of the tensor-parallel activation all-reduces
    (``act_psum``: "bf16" | "int8"), the depth of the stage-1 prefetch
    ring (``prefetch_depth``), the scheduler's streams 2 and 3
    (``async_grad_reduce``, ``cross_step_pipeline``), the microbatch
    count, FCDP-Cache's device fraction, activation policy and host
    offload (``device_cache_fraction``, ``activation_policy``,
    ``host_offload``), the MoE's dispatch chunk and expert residency
    (``moe_token_chunk``, ``moe_weight_resident``), and its steps
    (batches: under the cross-step
    schedule S batches take a prime, S - 1 piped calls and a flush).
    With ``ckpt_dir`` the run goes through the checkpoint/restart driver
    (``drive``: a checkpoint every ``ckpt_every`` steps, failures
    injected at the steps ``fail_at``). ``model`` trains another model
    than the job's (its weights drawn from the job's seed; not with the
    job's ``params``), so one job's ranks can take several models in
    turn. ``defs_fn`` transforms the
    classified def tree (``StepBundle``'s hook, as the JAX bundle's; a
    module-level function, since the job is pickled to the ranks)."""
    mode: str
    param_compress: str = "none"
    grad_compress: str = "none"
    steps: int = 1
    dtype: str = "bfloat16"
    microbatch: int = 0
    loss_chunk: int = 0
    master_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    fused_matmul: str = "none"
    peft: bool = False
    lora_rank: int = 8
    lora_alpha: Optional[float] = None
    mode_overrides: tuple = ()
    all_trainable: bool = False
    act_psum: str = "bf16"
    prefetch_depth: int = 0
    async_grad_reduce: bool = False
    cross_step_pipeline: bool = False
    device_cache_fraction: float = 0.0
    activation_policy: str = "save_all"
    host_offload: bool = True
    moe_token_chunk: int = 8192
    moe_weight_resident: bool = False
    defs_fn: Optional[Callable] = None
    model: Optional[ModelConfig] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    fail_at: tuple = ()


@dataclass
class TrainJob:
    """What every rank of a spawned job runs: each ``ModeRun`` in turn,
    from the same initial weights (``params``, the JAX package's full
    numpy tree, or drawn from ``seed`` on ``draw_device``) and the same
    batches (``batches``, global numpy batches per step, or
    ``SyntheticPackedLM``'s). A run with a ``ckpt_dir`` runs under the
    checkpoint/restart driver (``drive``). ``return_params`` returns each
    rank's
    shards after the first step (``params``) and after the last
    (``final_params``). Every run returns a SHA-256 of the bytes of
    this rank's shards after its last call (``final_digest``), which is
    equal for two runs whose shards are equal bit for bit. ``task``, a
    module-level function, runs on every rank after the runs as
    ``task(job, mesh, coll, device, state)``, ``state`` the last run's
    final ``RunState`` under ``keep_last`` (else None); its result comes
    back under "task" (e.g. a ``core.cache.MemoryPlanner`` search, whose
    attempts run steps on every rank)."""
    run: RunConfig
    mesh: MeshShape
    runs: List[ModeRun]
    device: Optional[str] = None          # None -> cuda
    seed: int = 0
    draw_device: Optional[str] = None
    params: Optional[dict] = None
    batches: Optional[list] = None
    return_params: bool = False
    task: Optional[Callable] = None
    keep_last: bool = False


class RunState:
    """The training state of one run on this rank, as the JAX launcher's
    ``RunState`` holds it: the bundle, this rank's parameter shards
    (``params``; ``train_p`` / ``frozen_p`` its two lists), the
    optimizer state, the step and, under the cross-step schedule, the
    outstanding carry. ``do_train_step`` runs one step under whichever
    schedule is live (``last_kind``: "step", "prime" or "piped");
    ``flush_carry`` drains the pipeline; ``state_tree`` / ``load_state``
    are what a checkpoint persists and restores."""

    def __init__(self, job: "TrainJob", mr: ModeRun, mesh: RankMesh,
                 coll: Collectives, device: torch.device):
        sysc = dataclasses.replace(
            job.run.system, mode=mr.mode, param_compress=mr.param_compress,
            grad_compress=mr.grad_compress, dtype=mr.dtype,
            loss_chunk=mr.loss_chunk, master_dtype=mr.master_dtype,
            opt_state_dtype=mr.opt_state_dtype,
            fused_matmul=mr.fused_matmul, peft=mr.peft,
            lora_rank=mr.lora_rank, lora_alpha=mr.lora_alpha,
            mode_overrides=mr.mode_overrides, act_psum=mr.act_psum,
            prefetch_depth=mr.prefetch_depth,
            async_grad_reduce=mr.async_grad_reduce,
            cross_step_pipeline=mr.cross_step_pipeline,
            device_cache_fraction=mr.device_cache_fraction,
            activation_policy=mr.activation_policy,
            host_offload=mr.host_offload,
            moe_token_chunk=mr.moe_token_chunk,
            moe_weight_resident=mr.moe_weight_resident)
        if mr.model is not None and job.params is not None:
            raise ValueError("a run with a model of its own draws its "
                             "weights; the job's params are another "
                             "model's")
        self.run = run = dataclasses.replace(
            job.run, model=mr.model or job.run.model, system=sysc,
            microbatch=mr.microbatch)
        self.bundle = bundle = StepBundle(
            run, device=device, mesh=mesh,
            defs_fn=unfreeze_all if mr.all_trainable else mr.defs_fn)
        if job.params is not None:
            from repro_torch.convert import shards_from_jax
            self.params = shards_from_jax(job.params, bundle)
        else:
            self.params = bundle.init_all_params(job.seed, job.draw_device)
        self.train_p, self.frozen_p = bundle.split(self.params)
        self.opt = init_opt_state(bundle.opt_shards(self.train_p), sysc)
        self.step_fn = bundle.make_train_step(coll)
        self.cross_step = self.step_fn.use_xstep
        self.carry = None
        self.steps_taken = 0     # steps since init / restore
        self.last_primed = False
        self.last_kind: Optional[str] = None
        self.metrics_log: List[dict] = []
        self.batches = job.batches
        self.loader = ShardedLoader(SyntheticPackedLM(run.model, run.shape,
                                                      DataConfig(job.seed)),
                                    bundle, enc_embed_dim(run.model))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This rank's rows of batch ``step`` (the job's, else the
        synthetic data's)."""
        if self.batches:
            return self.bundle.shard_batch(self.batches[step])
        return self.loader.get(step)

    def do_train_step(self, batch) -> Dict[str, float]:
        """One step under the live schedule. With the cross-step
        pipeline the first call primes the carry (no update; its grad
        norm is 0, not a norm: ``last_primed``), the next ones run piped;
        call ``flush_carry`` before reading the final state."""
        self.last_primed = False
        self.steps_taken += 1
        if not self.cross_step:
            self.last_kind = "step"
            return self.step_fn(self.params, self.opt, batch)
        if self.carry is None:
            self.last_primed, self.last_kind = True, "prime"
            self.carry, m = self.step_fn.prime(self.params, self.opt, batch)
        else:
            self.last_kind = "piped"
            self.carry, m = self.step_fn.piped(self.params, self.opt,
                                               self.carry, batch)
        return m

    def flush_carry(self) -> Optional[Dict[str, float]]:
        """Finalize the outstanding cross-step epilogue, if any, so the
        shards and the optimizer state reflect every step taken (the
        next step re-primes). The flushed grad norm, the last step's, is
        appended to ``metrics_log`` as a ``flush`` row."""
        if self.carry is None:
            return None
        self.last_kind = "flush"
        m = self.step_fn.flush(self.params, self.opt, self.carry)
        self.carry = None
        self.metrics_log.append({"flush": True, "grad_norm": m["grad_norm"]})
        return m

    def state_tree(self) -> dict:
        """The persisted training state: the trainable shards and the
        optimizer state, and the cross-step carry exactly when one is
        outstanding, so a checkpoint taken mid-pipeline round-trips
        bit-exactly."""
        tree = {"params": self.train_p, "opt": self.opt}
        if self.carry is not None:
            tree["carry"] = self.carry
        return tree

    def load_state(self, tree: dict) -> None:
        """Load a restored state (this rank's blocks) into the live
        tensors in place, so nothing the step keeps points at old
        storage; a restored carry resumes the pipeline mid-flight,
        without one the next step re-primes."""
        with torch.no_grad():
            for dst, src in zip(self.train_p, tree["params"]):
                dst.copy_(src)
            for k in ("m", "v", "master"):
                for dst, src in zip(self.opt[k], tree["opt"][k]):
                    dst.copy_(src)
        self.opt["step"] = int(tree["opt"]["step"])
        self.carry = tree.get("carry")
        self.step_fn.primed = self.carry is not None
        self.steps_taken = 0


def drive(st: RunState, steps: int, ckpt_dir: str, ckpt_every: int = 10,
          fail_at: tuple = (), call: Optional[Callable] = None,
          flush: Optional[Callable] = None, log: Optional[Callable] = None
          ) -> dict:
    """The JAX launcher's checkpoint/restart loop over ``st``, on every
    rank: a blocking step-0 checkpoint when ``ckpt_dir`` holds none, an
    async checkpoint every ``ckpt_every`` steps and at the end (taken
    mid-pipeline: the carry rides along, with the mesh signature in
    ``meta``), failures injected at the steps ``fail_at`` (on every
    rank), and on a failure the in-flight epilogue flushed, the pending
    writes drained and the last checkpoint restored; a carry the restore
    had to drop (a mesh change) re-runs the step before it to re-prime.
    ``call(step)`` runs one step (default ``st.do_train_step``),
    ``flush()`` drains the pipeline at the end (default
    ``st.flush_carry``), ``log`` takes a line per restore. Returns
    ``run_with_restarts``' result with the last loss of every step, the
    checkpoints left, what each restore did, and the seconds each save
    took on this thread and each restore took."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ckpt = Checkpointer(ckpt_dir, rank=rank, world=world,
                        barrier=dist.barrier if world > 1 else None)
    injector = FailureInjector(fail_at_steps=tuple(fail_at))
    monitor = StragglerMonitor()
    hb = HeartbeatMonitor(timeout_s=600).start()
    call = call or (lambda s: st.do_train_step(st.batch(s)))
    io = {"save_s": [], "restore_s": [], "restored": []}

    def do_step(step: int):
        injector.maybe_fail(step)
        m = call(step)
        row = {"step": step, "loss": m["loss"], "grad_norm": m["grad_norm"]}
        if st.last_primed:
            row["primed"] = True
        st.metrics_log.append(row)

    def save(step: int, blocking: bool = False):
        t0 = time.perf_counter()
        tree = st.state_tree()
        ckpt.save(step, tree, blocking=blocking, meta=mesh_meta(st.bundle),
                  blocks=st.bundle.state_blocks(tree))
        io["save_s"].append(time.perf_counter() - t0)

    def restore() -> int:
        # drain the in-flight save first (every rank's part of it), or
        # latest_step() would miss it and resume a whole interval early
        ckpt.wait()
        latest = ckpt.latest_step()
        if latest == 0 and st.steps_taken == 0 and st.carry is None:
            return 0            # the step-0 seed just written: live state
        if latest is None:
            st.flush_carry()
            return 0
        t0 = time.perf_counter()
        state, carry_invalidated = reshard_state(
            ckpt, latest, st.bundle, {"params": st.train_p, "opt": st.opt})
        st.load_state(state)
        io["restore_s"].append(time.perf_counter() - t0)
        resume = max(latest - 1, 0) if carry_invalidated else latest
        io["restored"].append({"step": latest, "resume": resume,
                               "carry": "carry" in state,
                               "carry_invalidated": carry_invalidated})
        if log is not None:
            log(f"restored checkpoint at step {latest}"
                + (f"; cross-step carry invalidated -> re-running step "
                   f"{resume} to re-prime" if carry_invalidated else ""))
        return resume

    try:
        if ckpt.latest_step() is None:
            save(0, blocking=True)
        result = run_with_restarts(steps, do_step, save, restore,
                                   checkpoint_every=ckpt_every,
                                   monitor=monitor, heartbeat=hb,
                                   flush_fn=st.flush_carry)
        (flush or st.flush_carry)()
    finally:
        hb.stop()
    ckpt.wait()
    losses = {}
    for row in st.metrics_log:           # the last run of a step wins
        if "step" in row:
            losses[row["step"]] = row["loss"]
    return dict(result, losses=losses, ckpt_steps=ckpt.all_steps(), **io)


def _run_mode(job: "TrainJob", mr: ModeRun, mesh: RankMesh,
              coll: Collectives, device: torch.device):
    """Run ``mr`` on this rank: its steps (through ``drive`` when it has
    a ``ckpt_dir``), each call recorded. Returns (the record, the final
    ``RunState``)."""
    st = RunState(job, mr, mesh, coll, device)
    bundle, step, run = st.bundle, st.step_fn, st.run
    # host copies: the check must not add to the peak device memory
    frozen0 = [t.detach().to("cpu", copy=True) for t in st.frozen_p]
    sched = step.gather.scheduler
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    mm, scan = ops.matmul_chunk, ops.mamba_scan
    for f in (*ops.INT8_KERNELS.values(), mm, scan):  # 0 at each run's start
        f.launches = f.calls = 0
    ms, strategy = bundle.mesh_shape, bundle.strategy
    out = {"run": dataclasses.asdict(mr), "metrics": [], "bytes": [],
           "launches": [], "calls": [], "step_s": [], "cached": [],
           "cache_places": [], "int8_plan": int8_launch_plan(bundle),
           "act_int8_plan": act_int8_launch_plan(bundle),
           "mm_launches": [], "mm_calls": [],
           "mm_plan": matmul_chunk_launch_plan(bundle),
           "scan_launches": [], "scan_calls": [],
           "scan_plan": mamba_scan_launch_plan(bundle),
           "live_depth": [], "ring_bytes": [],
           "prefetch_buffer_bytes": prefetch_buffer_bytes(
               strategy, bundle.def_leaves, bundle.plan_leaves, ms,
               min([sched.depth] + [n for _, _, n in bundle.model.stacks])),
           "async_live": step.use_async, "cross_step_live": step.use_xstep,
           "async_buffer_bytes": async_buffer_bytes(
               strategy, bundle.def_leaves, bundle.plan_leaves, ms),
           "cross_step_buffer_bytes": cross_step_buffer_bytes(
               strategy, bundle.def_leaves, bundle.plan_leaves, ms),
           "kinds": [], "carry_bytes": [], "memory": [],
           "cache_accounting": cache_bytes_per_chip(bundle),
           "widened": {bundle.paths[bundle.train_idx[j]]: list(axes)
                       for j, (_, axes) in bundle.widen.items()},
           "params_total": sum(d.size() for d in bundle.def_leaves),
           "params_trainable": sum(bundle.def_leaves[i].size()
                                   for i in bundle.train_idx)}
    peak = 0               # the run's peak: the step resets it each call

    def call(s: int, flush: bool = False):
        """One call of the step (a fused step, or the cross-step
        schedule's prime, piped or flush), timed and recorded."""
        nonlocal peak
        before = coll.snapshot()
        launches = {k: f.launches for k, f in ops.INT8_KERNELS.items()}
        calls = {k: f.calls for k, f in ops.INT8_KERNELS.items()}
        mm_launches, mm_calls = mm.launches, mm.calls
        scan_launches, scan_calls = scan.launches, scan.calls
        batch = None if flush else st.batch(s)
        dist.barrier()
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated(device))
        t0 = time.perf_counter()
        m = st.flush_carry() if flush else st.do_train_step(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["kinds"].append(st.last_kind)
        out["memory"].append(dict(step.memory))
        peak = max([peak] + [p for p, _ in step.memory.values()])
        out["carry_bytes"].append(carry_bytes(st.carry) if st.carry else 0)
        if step.use_xstep:       # prime's grad norm is not a norm yet
            m = dict(m, primed=st.last_kind == "prime")
        out["metrics"].append(m)
        after = coll.snapshot()
        out["bytes"].append({k: v - before.get(k, 0.0)
                             for k, v in after.items()
                             if v != before.get(k, 0.0)})
        out["launches"].append({k: f.launches - launches[k]
                                for k, f in ops.INT8_KERNELS.items()})
        out["calls"].append({k: f.calls - calls[k]
                             for k, f in ops.INT8_KERNELS.items()})
        out["mm_launches"].append(mm.launches - mm_launches)
        out["mm_calls"].append(mm.calls - mm_calls)
        out["scan_launches"].append(scan.launches - scan_launches)
        out["scan_calls"].append(scan.calls - scan_calls)
        out["live_depth"].append(sched.live_depth)
        out["ring_bytes"].append(sched.ring_bytes)
        out["cached"].append(dict(step.gather.cached))
        out["cache_places"].append({k: sorted(v) for k, v in
                                    step.gather.cache_places.items()})
        return m

    def final_flush():
        if st.carry is not None:
            call(mr.steps, flush=True)

    if mr.ckpt_dir is not None:
        out["restart"] = drive(
            st, mr.steps, mr.ckpt_dir, mr.ckpt_every, mr.fail_at, call=call,
            flush=final_flush, log=print if dist.get_rank() == 0 else None)
    else:
        for s in range(mr.steps):
            call(s)
            if job.return_params and s == 0:
                # a copy: an fp32 shard on the CPU is updated in place
                out["params"] = {path: t.detach().cpu().float().numpy().copy()
                                 for path, t in tree_items(st.params)}
                out["specs"] = dict(zip(bundle.paths, bundle.leaf_specs))
                out["opt_dtypes"] = {
                    k: str(st.opt[k][0].dtype).split(".")[-1]
                    for k in ("m", "v", "master")}
        final_flush()
    out["final_digest"] = state_digest(st.params)
    if job.return_params:
        out["final_params"] = {path: t.detach().cpu().float().numpy()
                               for path, t in tree_items(st.params)}
    if st.frozen_p:
        out["frozen_unchanged"] = all(
            torch.equal(a, b.detach().cpu())
            for a, b in zip(frozen0, st.frozen_p))
        out["lora_b_moved"] = any(
            bool(t.detach().abs().max() > 0)
            for path, t in tree_items(st.params) if path.endswith("_lora_b"))
    if device.type == "cuda":
        out["peak_mem_bytes"] = max(
            peak, torch.cuda.max_memory_allocated(device))
    return out, st


def state_digest(tree) -> str:
    """A SHA-256 of the bytes of a tree's tensors (and the values of its
    other leaves) in checkpoint order: equal for two trees equal bit for
    bit."""
    from repro_torch.checkpoint.checkpointer import flatten_with_path
    digest = hashlib.sha256()
    for _, leaf in flatten_with_path(tree)[0]:
        if torch.is_tensor(leaf):
            digest.update(leaf.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes())
        else:
            digest.update(repr(leaf).encode())
    return digest.hexdigest()


def _init_group(rank: int, world: int, local_world: int,
                init_method: str, device: torch.device) -> str:
    backend = pick_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return backend


def run_job(job: TrainJob, rank: int, world: int, local_world: int,
            init_method: str) -> dict:
    """Run ``job`` as ``rank`` of ``world``, one of ``local_world`` ranks
    on this host (joins the process group at ``init_method`` and leaves
    it at the end)."""
    device = device_for_rank(job.device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the host's ranks share its cores: one share each, not all of them
    # each (which oversubscribes the cores local_world times; a card's
    # ranks run their wire's copies and sums there too)
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, cores // local_world))
    backend = _init_group(rank, world, local_world, init_method, device)
    try:
        mesh = RankMesh(job.mesh, backend)
        coll = Collectives(mesh)
        results, st = [], None
        for mr in job.runs:
            st = None           # the previous run's state is freed first
            out, st = _run_mode(job, mr, mesh, coll, device)
            results.append(out)
        if not job.keep_last:
            st = None
        task = (job.task(job, mesh, coll, device, st)
                if job.task is not None else None)
        del st
        dist.barrier()
        return {"rank": rank, "coords": mesh.coords, "backend": backend,
                "device": str(device), "runs": results, "task": task}
    finally:
        dist.destroy_process_group()


def _worker(rank: int, world: int, init_method: str, job_path: str,
            results) -> None:
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        # every spawned rank runs on this host
        results.put((rank, run_job(job, rank, world, world, init_method),
                     None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def spawn(job: TrainJob, rdzv_dir: Optional[str] = None,
          timeout_s: float = 1200.0) -> List[dict]:
    """Run ``job`` on ``job.mesh.world`` spawned ranks of this machine,
    rendezvous through a ``FileStore`` in a fresh temporary directory
    (under ``rdzv_dir`` when given). Returns the ranks' results in rank
    order; raises with the first failing rank's traceback. The job
    reaches the ranks through a file in that directory: a large one
    (the caller's weights and batches) passed as a process argument
    would hold each start until that rank had imported its modules, so
    the ranks would start one after another."""
    import torch.multiprocessing as mp
    world = job.mesh.world
    # the ranks fork from one server process that imported torch and
    # this module once, rather than each importing them anew; the server
    # holds no CUDA context, and it starts once per program
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_rdzv_",
                                     dir=rdzv_dir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        job_path = os.path.join(tmp, "job.pickle")
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        procs = [ctx.Process(target=_worker,
                             args=(r, world, init_method, job_path, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: Dict[int, dict] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                try:
                    rank, res, err = results.get(timeout=5.0)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"train ranks did not finish in "
                                           f"{timeout_s} s") from None
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(f"a train rank died (exit codes "
                                           f"{dead}) without a result")
                    continue
                if err is not None:
                    raise RuntimeError(f"train rank {rank} failed:\n{err}")
                got[rank] = res
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [got[r] for r in range(world)]


# -- the command line -----------------------------------------------------------

def build_run(args) -> RunConfig:
    """The run of the command line: the smoke config on a cell of
    ``--seq-len`` x ``--batch`` with ``--smoke``; the full config on the
    shape cell ``--cell`` without it, or on ``--seq-len`` x ``--batch``
    when no cell is named."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.cell is not None:
        cell = shape_cell(args.cell)
    else:
        cell = ShapeCell("train", "train", args.seq_len, args.batch)
    sysc = system_config_from_args(
        args, min_shard_size=8 if args.smoke else 2048)
    return RunConfig(model=cfg, shape=cell, system=sysc,
                     microbatch=args.microbatch,
                     optimizer=OptimizerConfig(
                         lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 1)))


def parser() -> argparse.ArgumentParser:
    """The command line of ``main``; the system knobs are the shared
    ones of ``launch/cli.py``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cell", default=None,
                    choices=[c.name for c in SHAPE_CELLS
                             if c.kind == "train"],
                    help="train on this shape cell's sequence length and "
                         "global batch (not with --smoke; default: "
                         "--seq-len x --batch)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a (pod 2, data world/2/m, model m) mesh, m = "
                         "gcd(world/2, 2); without it (data world/m, "
                         "model m), m = gcd(world, 2)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    add_system_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="checkpoint directory; a run resumes from its "
                         "latest checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject a failure (on every rank) at these steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    return ap


def main(argv=None):
    """Train under torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_WORLD_SIZE``/
    ``MASTER_ADDR``/``MASTER_PORT`` from its environment). Rank 0 prints one line per
    step and a JSON summary; returns this rank's result."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.smoke and args.cell is not None:
        ap.error("--cell names a full config's cell; --smoke trains "
                 "--seq-len x --batch")

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    run = build_run(args)
    sysc = run.system
    job = TrainJob(run=run,
                   mesh=train_mesh_shape(world, args.multi_pod),
                   runs=[ModeRun(args.mode, args.param_compress,
                                 args.grad_compress, args.steps,
                                 microbatch=args.microbatch,
                                 loss_chunk=sysc.loss_chunk,
                                 fused_matmul=args.fused_matmul,
                                 peft=sysc.peft, lora_rank=sysc.lora_rank,
                                 lora_alpha=sysc.lora_alpha,
                                 mode_overrides=sysc.mode_overrides,
                                 prefetch_depth=sysc.prefetch_depth,
                                 async_grad_reduce=sysc.async_grad_reduce,
                                 cross_step_pipeline=(
                                     sysc.cross_step_pipeline),
                                 device_cache_fraction=(
                                     sysc.device_cache_fraction),
                                 activation_policy=(
                                     sysc.activation_policy),
                                 ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every,
                                 fail_at=tuple(args.fail_at))],
                   device=args.device, seed=args.seed)
    t0 = time.perf_counter()
    res = run_job(job, rank, world, local_world, "env://")
    if rank == 0:
        r = res["runs"][0]
        for s, (kind, m) in enumerate(zip(r["kinds"], r["metrics"])):
            loss = f"loss {m['loss']:.4f} " if "loss" in m else ""
            print(f"{kind} {s:5d} {loss}gnorm {m['grad_norm']:.3f} "
                  f"({r['step_s'][s]:.2f}s)")
        restart = {k: r["restart"][k] for k in
                   ("final_step", "restarts", "ckpt_steps", "restored")}
        if not r["kinds"]:
            print(json.dumps({"restart": restart,
                              "note": "no step left to run"}))
            return res
        last = max(i for i, k in enumerate(r["kinds"]) if k != "flush")
        print(json.dumps({
            "mode": args.mode, "mesh": job.mesh.shape,
            "backend": res["backend"], "device": res["device"],
            "final_loss": r["metrics"][last]["loss"],
            "bytes_per_step": r["bytes"][last],
            "int8_calls_per_step": r["calls"][last],
            "int8_act_allreduce_plan": r["act_int8_plan"],
            "fused_matmul": args.fused_matmul,
            "matmul_chunk_calls_per_step": r["mm_calls"][last],
            "mamba_scan_calls_per_step": r["scan_calls"][last],
            "final_aux_loss": r["metrics"][last]["aux_loss"],
            "peft": args.peft, "mode_overrides": sysc.mode_overrides,
            "prefetch_depth": args.prefetch_depth,
            "live_depth": r["live_depth"][last],
            "ring_bytes": r["ring_bytes"][last],
            "prefetch_buffer_bytes": r["prefetch_buffer_bytes"],
            "async_live": r["async_live"],
            "cross_step_live": r["cross_step_live"],
            "async_buffer_bytes": r["async_buffer_bytes"],
            "cross_step_buffer_bytes": r["cross_step_buffer_bytes"],
            "carry_bytes": max(r["carry_bytes"]),
            "widened": r["widened"],
            "cache_places": r["cache_places"][last],
            "device_cache_fraction": args.device_cache_fraction,
            "activation_policy": args.activation_policy,
            "cached_bytes": r["cached"][last],
            "cache_accounting": r["cache_accounting"],
            "memory": r["memory"][last],
            "trainable_frac": r["params_trainable"] / r["params_total"],
            "restart": restart,
            "wall_s": time.perf_counter() - t0}))
    return res


if __name__ == "__main__":
    main()
