"""Serving launcher: continuous batching over the paged KV cache on one
device (``cuda`` unless ``--device`` says otherwise).

A mixed-length synthetic workload streams through the request scheduler
(``core/serve_schedule.py``): sequences are admitted the moment a batch
slot and their full KV page reservation free up, long prompts prefill in
chunks between decode steps, and finished sequences retire immediately.
``--policy static`` runs the same steps with wait-for-full-batch
admission for comparison. Weights are random, drawn from ``--seed``.
A model the paged path does not take (a moe, ssm or hybrid stack, an
encoder-decoder) is refused with a ``ValueError`` before any weight is
drawn: those serve through the contiguous steps.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 16 --seq-len 512 --gen-len 16 --batch 8 --chunk 128
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import RunConfig, ShapeCell, SystemConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.serve import (check_paged_plan,
                                           default_paged_kv, paged_replicas)
from repro_torch.core.kv_cache import PagedKVConfig
from repro_torch.core.serve_schedule import (PagedServeEngine, Request,
                                             summarize)


def mixed_requests(n: int, seq_len: int, gen_len: int, vocab: int,
                   seed: int = 0):
    """Mixed-length synthetic workload: prompt lengths spread over
    [gen_len, seq_len - gen_len] so short and long requests interleave.
    The same numpy stream as the JAX launcher's, so both packages serve
    identical requests for one seed."""
    rng = np.random.default_rng(seed)
    lo = min(gen_len, seq_len - gen_len)
    plens = rng.integers(max(lo, 1), seq_len - gen_len, endpoint=True,
                         size=n)
    return [Request(rid=i,
                    prompt=rng.integers(1, vocab, (int(p),)).astype(np.int32),
                    max_new_tokens=gen_len)
            for i, p in enumerate(plens)]


def main(argv=None):
    """Serve the workload; prints the summary JSON and returns
    (summary, results)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="max prompt+generation length per request")
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--policy", choices=["continuous", "static"],
                    default="continuous")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size (tokens per scheduler tick)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size (0 = default_paged_kv sizing)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the workload and of the random weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("serve", "decode", args.seq_len, args.batch)
    run = RunConfig(model=cfg, shape=cell, system=SystemConfig())
    bundle = StepBundle(run, device=args.device)
    check_paged_plan(bundle.model)
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=args.seed)

    if args.page_size:
        mpps = -(-args.seq_len // args.page_size)
        slots = args.batch // paged_replicas(bundle, cell)
        kv = PagedKVConfig(page_size=args.page_size,
                           pages_per_replica=1 + slots * mpps,
                           max_pages_per_seq=mpps)
    else:
        kv = default_paged_kv(bundle, cell)
    engine = PagedServeEngine(bundle, kv, chunk=args.chunk,
                              policy=args.policy)
    requests = mixed_requests(args.requests, args.seq_len, args.gen_len,
                              cfg.vocab_size, seed=args.seed)

    results, wall = engine.serve(params, requests)
    summary = summarize(results, wall)
    summary["policy"] = args.policy
    summary["device"] = str(bundle.device)
    summary["kv"] = {"page_size": kv.page_size,
                     "pages_per_replica": kv.pages_per_replica,
                     "max_pages_per_seq": kv.max_pages_per_seq,
                     "pool_shape": list(
                         engine.state["pos0"]["attn"]["k"].shape)}
    summary["scheduler_steps"] = engine.steps
    summary["prefill_calls"] = engine.prefill_calls
    summary["decode_calls"] = engine.decode_calls
    print(json.dumps(summary, indent=2))
    done = sorted(results, key=lambda r: r.rid)[0]
    print(f"request 0 (prompt {done.prompt_len}): "
          f"continuation ids[:8] = {done.tokens[:8]}")
    print(f"total (incl. init): {time.perf_counter() - t0:.2f}s; "
          f"scheduler steps: {engine.steps}")
    return summary, results


if __name__ == "__main__":
    main()
