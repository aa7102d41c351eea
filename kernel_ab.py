#!/usr/bin/env python3
"""Time the chunk matmul, the flash-attention kernel and the RWKV-6 WKV
kernel of this tree against those of another tree of the repo (e.g. the
parent commit), on one card, in turns: other, this, this, other, each in
its own process.

  git archive <parent> | tar -x -C .smoke_archive/parent
  python3 kernel_ab.py --other .smoke_archive/parent [--out FILE]

Each process builds its tree's kernels and times (``chip_smoke.py``'s
timers: CUDA events over 50 eager launches after 3 warm-up ones, the
same 50 captured in a CUDA graph for the device time alone, and 200
calls on a host clock for the host time) the cases of ``chip_smoke.py``'s
kernel phases that ride on these two kernels: the chunk matmul as the
fused ring calls it (``_chunk_mm``, so a tree that copies transposed
operands pays its copies) at the train phase's shapes, and the flash
kernel at the paged and jamba serve shapes (prefill and decode), and the
WKV kernel at the rwkv serve shapes (prefill and decode); beside the
first two the one PyTorch call that computes the same function
(``torch.matmul``, ``scaled_dot_product_attention``; none computes the
WKV). Inputs come from fixed seeds, so every process sees the same ones,
and the WKV's outputs and final state are compared bit for bit across
the trees by digest. Prints one JSON line per process and one per WKV
shape saying whether the bits agree (and writes the runs to ``--out``
when given). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from chip_smoke import cuda_ms, graph_ms, host_us  # noqa: E402

ITERS = 50


def timed(fn, library) -> dict:
    """Eager ms per call (CUDA events), device ms per call (a CUDA
    graph) and host us per call of ``fn``; eager and device ms of the
    library call."""
    return {"ms": cuda_ms(fn, ITERS), "device_ms": graph_ms(fn, ITERS),
            "host_us": host_us(fn), "library_ms": cuda_ms(library, ITERS),
            "library_device_ms": graph_ms(library, ITERS)}


def matmul_cases(gen):
    """(name, a, b) as the ring hands them to ``_chunk_mm``: qwen2.5-3b,
    1,024 tokens a rank, d_model 2,048, d_ff 11,008, chunks of 1,024."""
    import torch

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").bfloat16()
    tok, d, f = 1024, 2048, 11008
    x2, chunk, g2 = rnd(tok, f), rnd(f, d // 2), rnd(tok, d)
    return [("w_out_chunk", x2, rnd(f, d // 2)),
            ("wo_chunk", rnd(tok, d), rnd(d, d // 2)),
            ("both_dx_w_out", g2[:, :d // 2], chunk.t()),
            ("both_dw_w_out", x2.t(), g2[:, d // 2:])]


def flash_cases(gen):
    """(name, q, k, v, q_offset) at chip_smoke.py's timed shapes."""
    import torch

    def qkv(B, Sq, Skv, H, Hk):
        return tuple(torch.randn(B, s, h, 128, generator=gen,
                                 device="cuda").bfloat16()
                     for s, h in ((Sq, H), (Skv, Hk), (Skv, Hk)))

    def off(vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")
    return [("prefill_chunk", *qkv(8, 128, 512, 16, 2),
             off([0, 128, 256, 384, 0, 128, 256, 0])),
            ("decode", *qkv(8, 1, 512, 16, 2),
             off([37, 511, 200, 16, 300, 128, 64, 400])),
            ("jamba_prefill", *qkv(8, 512, 544, 32, 8), off([0] * 8)),
            ("jamba_decode", *qkv(8, 1, 544, 32, 8),
             off([512, 520, 530, 543, 515, 525, 535, 540]))]


def wkv_cases(gen):
    """(name, r, k, v, logw, u, s0) at chip_smoke.py's timed WKV shapes
    (rwkv6-3b: 40 heads of 64, batch 8): the bf16 prefill over 512
    tokens from zero state and a decode step from a drawn state."""
    import torch

    def inputs(S, with_s0):
        shape = (8, S, 40, 64)
        r, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        logw = -torch.exp(torch.randn(shape, generator=gen, device="cuda")
                          - 0.5)
        u = torch.randn(40, 64, generator=gen, device="cuda")
        s0 = (torch.randn(8, 40, 64, 64, generator=gen, device="cuda")
              if with_s0 else None)
        return r, k, v, logw, u, s0
    return [("prefill", *inputs(512, False)), ("decode", *inputs(1, True))]


def digest(t) -> str:
    """sha256 of a tensor's bytes: equal digests, equal bits."""
    import hashlib
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def time_tree(tree: Path) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import collective_matmul as cm, ops
    assert Path(cm.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": str(tree), "gpu": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "matmul_chunk": {}, "flash_attention": {},
        "wkv6": {}}
    for name, a, b in matmul_cases(gen):
        out["matmul_chunk"][name] = {
            **timed(lambda: cm._chunk_mm(a, b), lambda: torch.matmul(a, b)),
            "equal_library": bool(torch.equal(cm._chunk_mm(a, b),
                                              torch.matmul(a, b)))}
    for name, q, k, v, off in flash_cases(gen):
        Sq, Skv = q.shape[1], k.shape[1]
        kpos = torch.arange(Skv, device="cuda")
        qpos = off[:, None] + torch.arange(Sq, device="cuda")[None, :]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out["flash_attention"][name] = timed(
            lambda: ops.flash_attention(q, k, v, off),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
    for name, r, k, v, logw, u, s0 in wkv_cases(gen):
        def call():
            return ops.wkv6(r, k, v, logw, u, s0)
        o, st = call()
        out["wkv6"][name] = {"ms": cuda_ms(call, ITERS),
                             "device_ms": graph_ms(call, ITERS),
                             "host_us": host_us(call),
                             "out_sha256": digest(o),
                             "state_sha256": digest(st)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the tree to compare with")
    ap.add_argument("--out", type=Path,
                    help="also write the runs to this JSON file")
    ap.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.time_tree:
        print(json.dumps(time_tree(args.time_tree)), flush=True)
        return 0
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        print("kernel_ab: --other must name a tree of the repo",
              file=sys.stderr)
        return 2
    runs = []
    for tree in (args.other, ROOT, ROOT, args.other):
        r = subprocess.run([sys.executable, __file__, "--time-tree",
                            str(tree)], capture_output=True, text=True,
                           timeout=600)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return r.returncode
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    # the WKV's fp32 final state, and its outputs, bit for bit across the
    # trees (the same per-element update chain in both kernels)
    for name in runs[0]["wkv6"]:
        print(json.dumps({"wkv6": name, **{
            f"{what}_equal_other": len({r["wkv6"][name][f"{what}_sha256"]
                                        for r in runs}) == 1
            for what in ("state", "out")}}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
