"""Dry run: one rank's train step of an (arch x shape) cell at the
production mesh, traced on fake tensors, with the JAX package's JSON
row (its ``launch/dryrun.py``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --cell train_4k --multi-pod --mode fcdp --prefetch-depth 0
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mode fcdp

The reference lowers and compiles its step on 512 forced host devices;
the port has no compiler to ask. So the dry run runs rank 0's step, the
whole of it (every microbatch, the gradient reduce, the clip and AdamW),
on fake CPU tensors (``torch._subclasses.fake_tensor.FakeTensorMode``:
shapes and dtypes, no data), over a collective with no wire
(``core/collectives.NoWire``: every op is counted as on the real wire
and returns a tensor of the real op's shape). Per-rank bytes are the
same on every rank of the mesh, as in the reference's per-device
program. On CPU tensors each kernel's wrapper takes its plain version
(``kernels/ops.py``), so the FLOPs are the plain versions', as the
reference's dry run traces its ``jnp`` path.

What a row counts: the collective bytes and calls per (op, axis)
(``collective_bytes``, ``collective_calls``), the FLOPs a chip
(``FlopCounterMode``'s formulas), the HBM bytes of the reference's
model (``roofline.major_bytes``), the cache accounting
(``core/cache.cache_bytes_per_chip``), the roofline terms on the H100
(``launch/roofline.py``), and the rank's memory: ``argument_bytes``
(its parameters, optimizer state and batch at the step's start),
``temp_bytes`` (what the step adds at its peak), ``peak_est_bytes``
(their sum) and ``host_bytes`` (the peak of the host tier's caches,
which the fcdp step keeps off the device), from a tracker of live fake
storage. What it does not count: the serve cells (prefill, decode)
report ``"status": "unported"``: at the production mesh they need the
multi-rank paged path and the seq-sharded decode, which the port does
not have; the allocator's rounding and fragmentation; the wire's own
buffers (gloo stages through pinned host memory).

As in the reference, the dry run pins ``loss_chunk=2048`` and the
``block_io`` activation policy unless ``system_overrides`` says
otherwise, and the prefetch ring's depth defaults to 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (SHAPE_CELLS, RunConfig, SystemConfig,
                                      shape_cell)
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.core.strategy import DEFAULT_STRATEGY
from repro_torch.launch.cli import add_system_args, system_config_from_args
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (CollectiveStats,
                                         fused_overlap_credit, major_bytes,
                                         roofline_report)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results"

UNPORTED_SERVE = ("the serve cells at the production mesh need the "
                  "multi-rank paged path and the seq-sharded decode "
                  "(ROADMAP.md Queue 1 item 4); the port serves on one "
                  "rank")


class StepTracker(TorchDispatchMode):
    """What the ops run under it allocate, compute and read: the bytes of
    the storages alive, device and host apart, with their peaks (every
    op's outputs are tracked by storage until the storage is freed;
    ``host_copy`` makes the host tier's copy of a cache,
    ``core/fcdp.ParamGather.host_copy``, and counts it as host storage),
    and, while ``counting``, the FLOPs of ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
    attention) and the HBM bytes of the reference's model
    (``roofline.major_bytes``). One mode, not a ``FlopCounterMode``
    beside it: each mode is a Python call on every op, and that one
    nearly doubled a fake step's time."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, tuple] = {}
        self.now = {"device": 0, "host": 0}
        self.peak = {"device": 0, "host": 0}
        self.counting = False
        self.flops = 0.0
        self.hbm_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:
            return out
        if self.counting:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            self.hbm_bytes += major_bytes(func, args, kwargs, out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage(), "device")
        return out

    def _track(self, st, tier: str) -> None:
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = (n, tier)
        self.now[tier] += n
        self.peak[tier] = max(self.peak[tier], self.now[tier])
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n, tier = self.live.pop(key, (0, "device"))
        self.now[tier] -= n

    def host_copy(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty_like(t)
        host.copy_(t)
        st = host.untyped_storage()
        n, _ = self.live[st._cdata]
        self.live[st._cdata] = (n, "host")
        self.now["device"] -= n
        self.now["host"] += n
        self.peak["host"] = max(self.peak["host"], self.now["host"])
        return host

    def reset_peak(self) -> None:
        gc.collect()
        self.peak = dict(self.now)


_DEVICE = torch.ops.prim.device.default


def _fake_batch(bundle) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch, as ``bundle.shard_batch`` cuts the
    loader's: ids and labels int32, the mask bool, an encoder-decoder's
    frames bf16."""
    from repro_torch.core.partition import block_index
    from repro_torch.launch.mesh import fsdp_axes
    from repro_torch.models.encdec import enc_len
    run, ms = bundle.run, bundle.mesh_shape
    rows, seq = run.shape.global_batch, run.shape.seq_len
    count = block_index(fsdp_axes(ms), ms, bundle.coords)[1]
    if rows % count == 0:
        rows //= count
    out = {"ids": torch.ones((rows, seq), dtype=torch.int32),
           "labels": torch.ones((rows, seq), dtype=torch.int32),
           "mask": torch.ones((rows, seq), dtype=torch.bool)}
    if run.model.num_encoder_layers:
        out["enc_embeds"] = torch.zeros(
            (rows, enc_len(seq), run.model.d_model), dtype=torch.bfloat16)
    return out


def _nbytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace_train_step(run: RunConfig, mesh_shape, defs_fn=None) -> Dict:
    """Run one train step of ``run`` as rank 0 of ``mesh_shape``
    on fake tensors over a ``NoWire`` collective. Under the cross-step
    schedule the step is the steady-state ``piped`` call, after a
    ``prime`` that is not counted (``carry_bytes``: the carry it
    handed over). Returns the bundle, the step, the collective bytes and
    calls per (op, axis), the FLOPs, the HBM bytes, the memory and the
    seconds the step took to run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.collectives import NoWire
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.train import carry_bytes
    from repro_torch.core.partition import tree_items
    from repro_torch.optim.adamw import init_opt_state
    coll = NoWire(mesh_shape)
    tracker = StepTracker()
    with FakeTensorMode(), tracker:
        bundle = StepBundle(run, device="cpu", mesh=coll.mesh,
                            defs_fn=defs_fn)
        params = bundle.init_all_params(0)
        train, _ = bundle.split(params)
        opt = init_opt_state(bundle.opt_shards(train), run.system)
        step = bundle.make_train_step(coll)
        step.host_metrics = False
        step.gather.host_copy = tracker.host_copy
        batch = _fake_batch(bundle)
        carry, carried = None, 0
        if step.use_xstep:
            carry, _ = step.prime(params, opt, batch)
            carried = carry_bytes(carry)
            coll.counts.clear()
            coll.calls.clear()
            coll.hbm_bytes = 0.0
        tracker.reset_peak()
        args = [t for _, t in tree_items(params)] + opt["m"] + opt["v"] \
            + opt["master"] + list(batch.values()) \
            + [t for ts in (carry or {}).values() for t in ts]
        argument = _nbytes(args)
        tracker.counting = True
        t0 = time.perf_counter()
        if carry is not None:
            step.piped(params, opt, carry, batch)
        else:
            step(params, opt, batch)
        trace_s = time.perf_counter() - t0
        tracker.counting = False
        del carry
        gc.collect()
    peak = tracker.peak["device"]
    return {"bundle": bundle, "step": step,
            "bytes": {k: v for k, v in coll.counts.items() if v},
            "calls": dict(coll.calls),
            "flops": tracker.flops,
            "hbm_bytes": tracker.hbm_bytes + coll.hbm_bytes,
            "memory": {"argument_bytes": argument,
                       "temp_bytes": peak - argument,
                       "peak_est_bytes": peak,
                       "host_bytes": tracker.peak["host"]},
            "carry_bytes": carried, "trace_s": trace_s}


def dryrun_run(run: RunConfig, mesh_shape, defs_fn=None) -> Dict:
    """The JSON row's measured part for ``run`` at ``mesh_shape``: the
    traced step's numbers, the cache accounting and the roofline."""
    from repro_torch.core.cache import cache_bytes_per_chip
    t = trace_train_step(run, mesh_shape, defs_fn)
    bundle = t["bundle"]
    sizes = mesh_shape.shape
    n_chips = mesh_shape.world
    acct = cache_bytes_per_chip(bundle)
    stats = CollectiveStats.from_counts(t["bytes"], t["calls"])
    fused_credit = fused_overlap_credit(
        bundle.def_leaves, bundle.plan_leaves, sizes, run.shape,
        tp=bundle.model.tp)
    rep = roofline_report(
        t["flops"], t["hbm_bytes"], stats, run.model, run.shape, n_chips,
        prefetch=acct["prefetch_depth"],
        inflight_bytes=acct["prefetch_buffer_bytes_per_chip"],
        group_bytes=acct["by_group"],
        cross_step=acct["cross_step"],
        cross_step_bytes=acct["cross_step_buffer_bytes_per_chip"],
        fused=fused_credit)
    sysc = run.system
    return {
        "mode_overrides": list(map(list, sysc.mode_overrides)),
        "n_chips": n_chips,
        "prefetch_depth": acct["prefetch_depth"],
        "prefetch_buffer_bytes_per_chip":
            acct["prefetch_buffer_bytes_per_chip"],
        "async_buffer_bytes_per_chip": acct["async_buffer_bytes_per_chip"],
        "cross_step": acct["cross_step"],
        "cross_step_buffer_bytes_per_chip":
            acct["cross_step_buffer_bytes_per_chip"],
        "param_compress": acct["param_compress"],
        "kv_page_bytes_per_chip": acct["kv_page_bytes_per_chip"],
        "fused_matmul": sysc.fused_matmul,
        "fused_n_leaves": fused_credit["n_fused_leaves"],
        "fused_overlap_credit_s": fused_credit["credit_s"],
        "stage1_dcn_gather_bytes_per_chip":
            acct["stage1_dcn_gather_bytes_per_chip"],
        "stage1_dcn_gather_bytes_exact":
            acct["stage1_dcn_gather_bytes_exact"],
        "cache_by_group": acct["by_group"],
        "cached_bytes": dict(t["step"].gather.cached),
        "carry_bytes": t["carry_bytes"],
        "trace_s": t["trace_s"],
        "memory": t["memory"],
        "flops_per_chip": t["flops"],
        "bytes_per_chip": t["hbm_bytes"],
        "collective_bytes": t["bytes"],
        "collective_calls": t["calls"],
        "roofline": rep,
    }


def dryrun_cell(arch: str, cell_name: str, multi_pod: bool,
                mode: str = DEFAULT_STRATEGY, system_overrides=None,
                verbose: bool = True, prefetch_depth=None,
                mode_overrides=(), microbatch: int = 0,
                async_grad_reduce: bool = False,
                cross_step: bool = False, param_compress: str = "none",
                fused_matmul: str = "none", system: SystemConfig = None,
                model=None):
    """One cell's JSON row, with the reference's arguments:
    ``mode_overrides`` per-tensor strategy rules on top of ``mode``;
    ``cross_step`` runs the steady-state piped step (needs
    ``async_grad_reduce`` and ``microbatch`` >= 2); ``system`` a built
    ``SystemConfig`` (``launch/cli.py``) used as it is in place of the
    knob arguments; ``model`` a ``ModelConfig`` in place of the arch's
    (its depth cut, say). ``loss_chunk=2048`` and ``block_io`` are
    pinned unless ``system_overrides`` says otherwise."""
    cfg = model or get_config(arch)
    cell = shape_cell(cell_name)
    if system is not None:
        mode = system.mode
    head = {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
            "mode": mode}
    ok, why = cell_supported(cfg, cell)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    if cell.kind != "train":
        return {**head, "status": "unported", "reason": UNPORTED_SERVE}
    mesh = make_production_mesh(multi_pod=multi_pod)
    if system is None:
        if prefetch_depth is None:
            prefetch_depth = 1      # the reference dry run's default
        system = SystemConfig(mode=mode, prefetch_depth=prefetch_depth,
                              async_grad_reduce=async_grad_reduce,
                              cross_step_pipeline=cross_step,
                              param_compress=param_compress,
                              fused_matmul=fused_matmul,
                              mode_overrides=tuple(mode_overrides or ()))
    sysc = dataclasses.replace(system, loss_chunk=2048,
                               activation_policy="block_io")
    if system_overrides:
        sysc = dataclasses.replace(sysc, **system_overrides)
    run = RunConfig(model=cfg, shape=cell, system=sysc,
                    microbatch=microbatch)
    result = {**head, "status": "ok", **dryrun_run(run, mesh)}
    if verbose:
        mem, rep = result["memory"], result["roofline"]
        print(f"[{arch} x {cell_name} x {'2pod' if multi_pod else '1pod'} "
              f"x {mode}] trace={result['trace_s']:.1f}s "
              f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"host={mem['host_bytes'] / 2**30:.2f}GiB "
              f"flops/chip={result['flops_per_chip']:.3e} "
              f"pod_ag={result['collective_bytes'].get('all_gather/pod', 0):.4g}"
              f" dom={rep['dominant']} "
              f"roofline={rep['roofline_fraction']:.3f}")
    gc.collect()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--cell", default=None,
                    choices=[c.name for c in SHAPE_CELLS] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    # the reference dry run's default depth is 1; --prefetch-depth 0 is
    # the sequential schedule the paper's comparisons are defined on
    add_system_args(ap, default_prefetch_depth=1)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation microbatches for train "
                         "cells (>= 2 for --cross-step-pipeline)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x cell) on both meshes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cross_step_pipeline and (not args.async_grad_reduce
                                     or args.microbatch < 2):
        ap.error("--cross-step-pipeline requires --async-grad-reduce "
                 "and --microbatch >= 2")

    if args.all:
        combos = [(a, c.name, mp) for a in ARCH_IDS for c in SHAPE_CELLS
                  for mp in (False, True)]
    else:
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        cells = [args.cell] if args.cell else [c.name for c in SHAPE_CELLS]
        pods = []
        if args.multi_pod or not args.single_pod:
            pods.append(True)
        if args.single_pod or not args.multi_pod:
            pods.append(False)
        combos = [(a, c, mp) for a in archs for c in cells for mp in pods]

    sysc = system_config_from_args(args)
    results, failures = [], 0
    for arch, cell, mp in combos:
        try:
            r = dryrun_cell(arch, cell, mp, system=sysc,
                            microbatch=args.microbatch)
        except Exception as e:  # a failure here is a fault of the port
            traceback.print_exc()
            r = {"arch": arch, "cell": cell, "multi_pod": mp,
                 "mode": args.mode, "status": "FAILED",
                 "error": f"{type(e).__name__}: {e}"}
            failures += 1
        results.append(r)
        if r["status"] in ("skipped", "unported"):
            print(f"[{arch} x {cell} x {'2pod' if mp else '1pod'}] "
                  f"{r['status'].upper()}: {r['reason']}")

    if args.out:
        out = Path(args.out)
    else:
        RESULTS_DIR.mkdir(exist_ok=True)
        out = RESULTS_DIR / (f"torch_dryrun_{args.mode}"
                             f"{'_mixed' if sysc.mode_overrides else ''}"
                             ".json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "unported", "skipped")}
    print(f"\nwrote {out}; {len(results)} cells: {n['ok']} ok, "
          f"{n['unported']} unported, {n['skipped']} skipped, "
          f"{failures} failures")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
