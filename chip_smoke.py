#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  -- the card (nvidia-smi name and power limit), torch/CUDA
                versions, and the build of every kernel from the sources
                in this checkout (timed as set-up).
  2. kernels -- each kernel of the serve path against its plain PyTorch
                version on the card, at the TPU kernel's own function
                and at the shapes the main path gives it; times of the
                kernel, the plain version and one PyTorch library call
                (the yardstick, never called by the port).
  3. serve   -- the main path: ``repro_torch.launch.serve.main`` serving
                16 requests through qwen2.5-3b at full width and depth
                (random weights from a seed); checks every request's
                token count and that the attention kernel ran 36 times
                per prefill and per decode call.
  4. parity  -- the same port at full width and depth 2, same weights,
                on the card (kernel) and on the CPU (plain version):
                first-token logits within tolerance, greedy tokens
                equal.

Then the card's name and power limit, the kernels' JSON line, and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port beside this script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention.py:25"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# H100 SXM published peaks (dense): bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs plain version, bf16 outputs. Per element |diff| <= 2e-2: the
# two sum in different orders and round to bf16, and the largest
# outputs (|out| in [2, 4), rows that see a handful of keys) are one
# bf16 step (0.0156) apart at worst. Per case mean |diff| <= 1e-2 x
# mean |plain|: rounding p and the output to bf16 costs ~2e-3 of the
# mean, while one key too many or too few at the causal edge moves a
# row by ~1/n of |v|, several percent of mean |out| at the main path's
# windows (n ~ 250 keys).
MAX_ABS_TOL = 2e-2
MEAN_REL_TOL = 1e-2
SERVE_ARGS = ["--arch", "qwen2.5-3b", "--requests", "16", "--seq-len", "512",
              "--gen-len", "16", "--batch", "8", "--chunk", "128",
              "--seed", "0"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_summary(log: Path) -> dict:
    """Registers and spill bytes per compiled kernel, from nvcc's
    ``-Xptxas -v`` report kept beside the library."""
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            tmpl = re.search(r"ILi(\d+)E", m.group(1))
            name = f"hd{tmpl.group(1)}" if tmpl else m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2 -----------------------------------------------------------------

def attention_bound(B, Sq, Skv, H, Hk, hd, offsets, causal):
    """Least time for the work these inputs need: 4*hd flops per (query,
    head, visible key); bytes of q and out, of the K/V rows some query
    of the row can see, and of q_offset. Returns (ms, bound_by)."""
    flops, kv_rows = 0, 0
    for off in offsets:
        keys = [min(Skv, off + i + 1) if causal else Skv for i in range(Sq)]
        flops += 4 * H * hd * sum(keys)
        kv_rows += max(keys)
    nbytes = 2 * (2 * B * Sq * H * hd + 2 * kv_rows * Hk * hd) + 4 * B
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_case(name, B, Sq, Skv, H, Hk, hd, offsets, causal, gen,
                timed=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).bfloat16()
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, off, causal)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, off, causal)
    d = (got.float() - want.float()).abs()
    out = {"case": name, "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H,
                                   "Hk": Hk, "hd": hd, "causal": causal},
           "max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(),
           "mean_abs_plain": want.float().abs().mean().item(),
           "finite": bool(torch.isfinite(got).all().item())}
    check(out["finite"], f"{name}: kernel output not finite")
    check(out["max_abs_err"] <= MAX_ABS_TOL,
          f"{name}: kernel disagrees with plain version "
          f"(max |diff| {out['max_abs_err']} > {MAX_ABS_TOL})")
    check(out["mean_abs_err"] <= MEAN_REL_TOL * out["mean_abs_plain"],
          f"{name}: kernel disagrees with plain version on average "
          f"(mean |diff| {out['mean_abs_err']} > {MEAN_REL_TOL} x mean "
          f"|plain| {out['mean_abs_plain']})")
    if timed:
        out["ms"] = cuda_ms(lambda: ops.flash_attention(q, k, v, off, causal),
                            50)
        out["plain_ms"] = cuda_ms(
            lambda: ref.attention_plain(q, k, v, off, causal), 20)
        # yardstick: one PyTorch call computing the same function
        kpos = torch.arange(Skv, device=dev)
        qpos = off[:, None] + torch.arange(Sq, device=dev)[None, :]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask if causal else None,
                enable_gqa=True)
        lib = library().transpose(1, 2)
        out["library_max_abs_err"] = (lib.float() - want.float()
                                      ).abs().max().item()
        out["library_ms"] = cuda_ms(library, 50)
        out["bound_ms"], out["bound_by"] = attention_bound(
            B, Sq, Skv, H, Hk, hd, offsets, causal)
    return out


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for S in (512, 200):                  # the TPU kernel's own function
        for causal in (True, False):
            cases.append(kernel_case(
                f"tpu_fn_S{S}_{'causal' if causal else 'full'}", 2, S, S,
                16, 16, 128, [0, 0], causal, gen))
    # the main path's shapes: seq-len 512 in pages of 16 -> a 512-key
    # window per row; prefill chunks start at multiples of the chunk
    prefill = kernel_case("prefill_chunk", 8, 128, 512, 16, 2, 128,
                          [0, 128, 256, 384, 0, 128, 256, 0], True, gen,
                          timed=True)
    offs = torch.randint(16, 512, (8,), generator=gen, device="cuda")
    decode = kernel_case("decode", 8, 1, 512, 16, 2, 128,
                         offs.tolist(), True, gen, timed=True)
    cases += [prefill, decode]
    cases.append(kernel_case("hd16", 8, 32, 128, 4, 2, 16,
                             [0, 32, 64, 96, 0, 32, 64, 0], True, gen))
    for c in cases:
        emit("kernels", **c)
    return prefill, decode


# -- phase 3 -----------------------------------------------------------------

def phase_serve():
    import contextlib
    import io

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    ops.flash_attention.launches = 0
    with contextlib.redirect_stdout(buf):
        summary, results = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    layers = get_config("qwen2.5-3b").num_layers
    calls = summary["prefill_calls"] + summary["decode_calls"]
    check(len(results) == 16, f"served {len(results)} of 16 requests")
    check(all(len(r.tokens) == 16 for r in results),
          "a request did not return 16 tokens")
    vocab = get_config("qwen2.5-3b").vocab_size
    check(all(0 <= t < vocab for r in results for t in r.tokens),
          "a token id lies outside the vocabulary")
    check(launches == layers * calls,
          f"flash kernel launched {launches} times, expected "
          f"{layers} x {calls}")
    emit("serve", args=" ".join(SERVE_ARGS), launches=launches,
         expected_launches=layers * calls,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         summary=summary,
         request0_tokens=sorted(results, key=lambda r: r.rid)[0].tokens)
    return launches


def phase_profile():
    """Where the serve time goes: the phase-3 workload served again under
    torch.profiler (phase 3's numbers are taken with tracing off).
    Device busy time is the sum of the CUDA kernels' and copies' own
    times (one stream, so they do not overlap); idle share is the rest
    of the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.serve_schedule import PagedServeEngine
    from repro_torch.launch.serve import mixed_requests

    cfg = get_config("qwen2.5-3b")
    cell = ShapeCell("serve", "decode", 512, 8)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    params = bundle.init_all_params(seed=0)
    engine = PagedServeEngine(bundle, default_paged_kv(bundle, cell),
                              chunk=128)
    reqs = mixed_requests(16, 512, 16, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(params, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in dev)
    n_kernels = sum(e.count for e in dev)
    steps = engine.prefill_calls + engine.decode_calls

    def top(rows, key, n=12):
        rows = sorted(rows, key=key, reverse=True)[:n]
        return [{"name": e.key[:90], "count": e.count,
                 "ms": key(e) / 1e3} for e in rows]
    emit("profile", wall_s=wall, device_busy_s=busy_us / 1e6,
         device_idle_share=1 - busy_us / 1e6 / wall,
         prefill_calls=engine.prefill_calls,
         decode_calls=engine.decode_calls,
         device_launches=n_kernels, launches_per_step=n_kernels / steps,
         top_device=top(dev, lambda e: e.self_device_time_total),
         top_host=top(host, lambda e: e.self_cpu_time_total))


# -- phase 4 -----------------------------------------------------------------

def phase_parity():
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.partition import tree_map
    from repro_torch.core.serve_schedule import PagedServeEngine
    from repro_torch.launch.serve import mixed_requests

    tol = 0.1          # logits ~N(0,1) in bf16: a few bf16 steps
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    run = RunConfig(model=cfg, shape=ShapeCell("parity", "decode", 64, 3))
    cpu = StepBundle(run, device="cpu")
    gpu = StepBundle(run)
    p_cpu = cpu.init_all_params(seed=0)
    p_gpu = tree_map(lambda t: t.to(gpu.device), p_cpu)
    reqs = mixed_requests(3, 64, 4, cfg.vocab_size, seed=1)
    out = {}
    for name, b, p in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        eng = PagedServeEngine(b, default_paged_kv(b, run.shape), chunk=32,
                               capture_logits=True)
        t0 = time.perf_counter()
        res, _ = eng.serve(p, list(reqs))
        out[name] = ({r.rid: r.tokens for r in res}, eng.captured,
                     time.perf_counter() - t0)
    (tok_c, cap_c, t_c), (tok_g, cap_g, t_g) = out["cpu"], out["gpu"]
    first = [float(np.abs(cap_g[r][0] - cap_c[r][0]).max()) for r in tok_c]
    check(max(first) <= tol, f"first-token logits differ by {max(first)}")
    compared, diverged = 0, []
    for rid in tok_c:
        for step, (a, b) in enumerate(zip(tok_c[rid], tok_g[rid])):
            if a != b:
                # only a near-tie may flip: the CPU's top-2 margin at that
                # step must lie within the logit tolerance
                top2 = np.sort(cap_c[rid][step])[-2:]
                check(float(top2[1] - top2[0]) <= tol,
                      f"request {rid} step {step}: tokens {a} vs {b}")
                diverged.append([rid, step])
                break
            compared += 1
    emit("parity", layers=cfg.num_layers, requests=len(reqs),
         logit_tol=tol, first_token_max_abs_diff=first,
         tokens_cpu=tok_c, tokens_gpu=tok_g, tokens_compared=compared,
         near_tie_divergences=diverged, cpu_s=t_c, gpu_s=t_g)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port (src/repro_torch) is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    gpu = gpu_line()
    t0 = time.perf_counter()
    built = _build.build()
    emit("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=time.perf_counter() - t0, built=built,
         ptxas={n: ptxas_summary(_build.library_path(n).with_suffix(".log"))
                for n in _build.SOURCES})

    prefill, decode = phase_kernels()
    launches = phase_serve()
    phase_profile()
    phase_parity()

    def entry(c):
        return {k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}
    kernels = {"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL, "launches": launches,
        **entry(prefill), "shape": "prefill_chunk",
        "decode": entry(decode)}]}
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
