#!/usr/bin/env python3
"""Time the one-card train path's wire: a few train arms of qwen2.5-3b at
full width, depth 2, on 4 gloo ranks sharing the card (pod 2 x data 2),
under the port found in SRC (this checkout's ``src`` by default).

  python3 train_wire_ab.py [--src SRC] [--tag TAG]

Run it for two trees in turns within one call (A, B, B, A) to compare
their wires: a step's time moves by up to 2x between calls on a shared
host. Prints one JSON line: the spawn's wall seconds, rank 0's step
seconds per arm, the first losses, the last grad norms and the first
arms' bytes per (op, axis), which must agree between the trees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_wire_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                          ShapeCell, SystemConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.train import ModeRun, TrainJob, spawn

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    runs = [ModeRun("zero3"), ModeRun("zero3"), ModeRun("fcdp"),
            ModeRun("fcdp", "int8_pod", "int8_pod"),
            ModeRun("fcdp", fused_matmul="ag_matmul"),
            ModeRun("fcdp", microbatch=2, steps=2, async_grad_reduce=True,
                    cross_step_pipeline=True),
            ModeRun("zero3", microbatch=2, async_grad_reduce=True)]
    run = RunConfig(model=cfg, shape=ShapeCell("train", "train", 512, 8),
                    system=SystemConfig(dtype="bfloat16"),
                    optimizer=OptimizerConfig(lr=3e-4, total_steps=100,
                                              warmup_steps=10, grad_clip=1.0))
    job = TrainJob(run=run, mesh=MeshShape(("pod", "data", "model"),
                                           (2, 2, 1)), runs=runs, seed=0)
    t0 = time.perf_counter()
    ranks = spawn(job, timeout_s=600)
    wall = time.perf_counter() - t0
    r0 = ranks[0]["runs"]
    print(json.dumps({
        "tag": args.tag, "src": args.src, "wall_s": wall,
        "step_s": [r["step_s"] for r in r0],
        "loss": [r["metrics"][0]["loss"] for r in r0],
        "grad_norm": [r["metrics"][-1].get("grad_norm") for r in r0],
        "bytes": [r["bytes"][0] for r in r0[:3]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
