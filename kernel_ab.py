#!/usr/bin/env python3
"""Time the chunk matmul, the flash-attention kernel, the RWKV-6 WKV
kernel and the int8 quantize / dequantize kernels with their callers of
this tree against those of another tree of the repo (e.g. the parent
commit), on one card, in turns: other, this, this, other, each in its
own process.

  git archive <parent> | tar -x -C .smoke_archive/parent
  python3 kernel_ab.py --other .smoke_archive/parent [--out FILE]
  python3 kernel_ab.py --acc-variant .smoke_archive/acc [--out FILE]

``--acc-variant DIR`` copies this tree's ``src/`` to DIR with the other
of dequant-accumulate's two dispatches at n = 2 (the instance that
issues both sources' loads before the first fold, or the generic loop a
source at a time) and takes that copy as the other tree.

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
WKV), and the int8 kernels (quantize, dequantize, dequant-accumulate)
at ``chip_smoke.py``'s timed shapes in the whole-block fp32 layout both
trees take, beside the callers' local passes (qwZ's issue and arrival,
qgZ's issue and arrival, the int8 TP all-reduce) run through a
``Loopback`` wire, so a tree's own pad, widening, slice, cast and
requantize are timed with its kernels. The int8 kernels' cases take
copies of their inputs in turn (``chip_smoke.rotations``), so a timed
call reads them from HBM, not from the L2 its predecessor filled; the
callers' passes are timed on one set of inputs (L2-warm below ~25 MB).
The cases of the entry points a tree lacks (the parent's
``int8_dequant_accumulate`` takes no chunk or dtype, and it has no
``int8_dequant_requantize``) are left out of that tree's run. Inputs
come from fixed seeds, so every process sees the same ones, and the
WKV's outputs and final state, the int8 kernels' results and the
callers' results and wire bytes are compared bit for bit across the
trees by digest. Prints one JSON line per process and one per WKV shape
and int8 case saying whether the bits agree (and writes the runs to
``--out`` when given). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (Loopback, cuda_ms, graph_ms, host_us,  # noqa: E402
                        rotations)

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


def int8_kernel_cases(gen):
    """(name, kernel, args, keywords) of the int8 kernels at
    chip_smoke.py's timed shapes, in the whole-block fp32 layout both
    trees take: qwen2.5-3b's MLP shard (qwZ's quantize) and stage-1 view
    (qwZ's fp32 dequantize, qgZ's fp32 quantize and its fold of 2
    sources), the embedding's stage-1 view and its fold, tp_train's
    activation all-reduce (quantize, fold, requantize, dequantize) and
    seamless-m4t-medium's attention shard, its stage-1 view and its
    fold; then, where the tree has them, qgZ's fold into the MLP
    gradient's bf16 chunk and the TP all-reduce's requantizing fold."""
    import torch

    def x(nb, dtype):
        return (torch.randn(nb, 256, generator=gen, device="cuda")
                * 0.02).to(dtype)

    def qs(nb):
        return (torch.randint(-127, 128, (nb, 256), generator=gen,
                              device="cuda", dtype=torch.int8),
                torch.rand(nb, 1, generator=gen, device="cuda") * 1e-3)
    def sources(nb):
        q, s = qs(2 * nb)
        return q.reshape(2, nb, 256), s.reshape(2, nb, 1)
    w_nb, e_nb, t_nb = 22016, 303872, 8192
    bf16, f32 = torch.bfloat16, torch.float32
    return [("quantize/mlp_shard_bf16", "quantize", (x(w_nb, bf16),), {}),
            ("quantize/mlp_stage1_grad_f32", "quantize", (x(2 * w_nb, f32),),
             {}),
            ("quantize/tp_act_bf16", "quantize", (x(t_nb, bf16),), {}),
            ("quantize/tp_act_requant_f32", "quantize",
             (x(t_nb // 2, f32),), {}),
            ("quantize/seamless_attn_shard_bf16", "quantize",
             (x(1024, bf16),), {}),
            ("dequantize/mlp_stage1", "dequantize", qs(2 * w_nb), {}),
            ("dequantize/embed_stage1", "dequantize", qs(2 * e_nb), {}),
            ("dequantize/tp_act_gather", "dequantize", qs(t_nb), {}),
            ("dequantize/seamless_attn_stage1", "dequantize", qs(2048), {}),
            ("dequant_accumulate/mlp_stage1_grad", "dequant_accumulate",
             sources(w_nb), {}),
            ("dequant_accumulate/embed_stage1_grad", "dequant_accumulate",
             sources(e_nb), {}),
            ("dequant_accumulate/tp_act_reduce", "dequant_accumulate",
             sources(t_nb // 2), {}),
            ("dequant_accumulate/seamless_attn_stage1_grad",
             "dequant_accumulate", sources(1024), {}),
            ("dequant_accumulate/mlp_stage1_grad_bf16", "dequant_accumulate",
             sources(w_nb), {"chunk_elems": w_nb * 256, "out_dtype": bf16}),
            ("dequant_requantize/tp_act_reduce", "dequant_requantize",
             sources(t_nb // 2), {})]


def int8_caller_cases(gen):
    """(name, make) of the callers' local passes over a ``Loopback`` wire
    of 2 ranks, bf16 as the train step runs them: ``make(tree modules)``
    returns the call to time and a function of its result giving the
    tensors to digest. qwZ's issue (``QuantizedPending``: quantize the
    shard) and arrival (its ``wait``: dequantize, drop the padding,
    cast), qgZ's issue (``QuantizedReducePending``: quantize the stage-1
    gradient in 2 chunks) and arrival (its ``wait``: fold the 2 sources,
    drop the padding, cast), and the int8 TP all-reduce whole
    (``_int8_allreduce``: quantize, dequant-accumulate, requantize,
    dequantize), at qwen2.5-3b's MLP shard (2048 x 11008 / 4),
    seamless-m4t-medium's attention and MLP shards (1024 x 1024 / 4,
    1024 x 4096 / 4), a ragged shard (300 x 7) and tp_train's [2, 512,
    2048] activation."""
    import torch

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.02).bfloat16()
    cases = []
    for tag, shape in (("mlp", (512, 11008)), ("seamless_attn", (256, 1024)),
                       ("seamless_mlp", (256, 4096)), ("ragged", (300, 7))):
        w, g = bf16(*shape), bf16(2 * shape[0], *shape[1:])

        def issue(m, w=w):
            coll = Loopback(2)
            return (lambda: m.gc.QuantizedPending(w, coll, "pod", 0),
                    lambda p: coll.sent)

        def arrival(m, w=w):
            p = m.gc.QuantizedPending(w, Loopback(2), "pod", 0)
            return p.wait, lambda out: [out]

        def reduce_issue(m, g=g):
            coll = Loopback(2)
            return (lambda: m.gc.QuantizedReducePending(g, coll, "pod", 0),
                    lambda p: coll.sent)

        def reduce_arrival(m, g=g):
            p = m.gc.QuantizedReducePending(g, Loopback(2), "pod", 0)
            parts = p.parts

            def call():             # the wait again on the same arrival
                p.parts = parts
                return p.wait()
            return call, lambda out: [out]
        cases += [(f"qwz_issue_{tag}", issue), (f"qwz_arrival_{tag}", arrival),
                  (f"qgz_issue_{tag}", reduce_issue),
                  (f"qgz_arrival_{tag}", reduce_arrival)]
    x = bf16(2, 512, 2048)

    def allreduce(m):
        coll = Loopback(2)
        return (lambda: m.ac._int8_allreduce(x, coll, "model"),
                lambda out: [out] + coll.sent)
    return cases + [("act_allreduce_tp", allreduce)]


def time_int8(gen) -> dict:
    """The int8 kernels alone and the callers' local passes: eager,
    device and host time per call, and the digests of their results."""
    from repro_torch.core import act_compress, grad_compress
    from repro_torch.kernels import ops
    new_api = hasattr(ops, "int8_dequant_requantize")
    out = {}
    for name, kind, args, kw in int8_kernel_cases(gen):
        if kind.startswith("dequant_"):
            fn = getattr(ops, f"int8_{kind}", None)
        else:
            fn = getattr(ops, f"int8_{kind}_blocks")
        if fn is None or (kw and not new_api):
            continue
        res = fn(*args, **kw)
        res = res if isinstance(res, tuple) else (res,)
        nbytes = sum(t.numel() * t.element_size() for t in args + res)
        runs = [args] + [tuple(a.clone() for a in args)
                         for _ in range(rotations(nbytes) - 1)]
        calls = [lambda a=a: fn(*a, **kw) for a in runs]
        out[name] = {"ms": cuda_ms(calls, ITERS),
                     "device_ms": graph_ms(calls, ITERS),
                     "host_us": host_us(calls[0]), "copies": len(runs),
                     "sha256": [digest(t) for t in res]}
    mods = SimpleNamespace(gc=grad_compress, ac=act_compress)
    for name, make in int8_caller_cases(gen):
        call, result = make(mods)
        res = call()
        out[name] = {"ms": cuda_ms(call, ITERS),
                     "device_ms": graph_ms(call, ITERS),
                     "host_us": host_us(call),
                     "sha256": [digest(t) for t in result(res)]}
    return out


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
        "wkv6": {}, "int8": {}}
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
    out["int8"] = time_int8(gen)
    return out


# dequant-accumulate's two dispatches at n = 2 in csrc/quant.cu
ACC_DISPATCHES = ("auto kernel = n == 2 ? acc_kernel<2, Out>(part) : "
                  "acc_kernel<0, Out>(part);",
                  "auto kernel = acc_kernel<0, Out>(part);")


def flipped_acc_tree(dest: Path) -> Path:
    """A copy of this tree's ``src/`` under ``dest`` whose
    dequant-accumulate launches the other of ``ACC_DISPATCHES`` at
    n = 2: the unrolled instance, or the loop this tree takes."""
    import shutil
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    cu = dest / "src" / "repro_torch" / "kernels" / "csrc" / "quant.cu"
    text = cu.read_text()
    for have, other in (ACC_DISPATCHES, ACC_DISPATCHES[::-1]):
        if text.count(have) == 1:
            cu.write_text(text.replace(have, other))
            return dest
    raise SystemExit("kernel_ab: csrc/quant.cu has neither dispatch of "
                     "ACC_DISPATCHES")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the tree to compare with")
    ap.add_argument("--acc-variant", type=Path,
                    help="compare with a copy of this tree, made here, "
                    "whose dequant-accumulate takes its other n = 2 "
                    "dispatch")
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
    if args.acc_variant:
        args.other = flipped_acc_tree(args.acc_variant)
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
    # the int8 kernels' and the callers' results, bit for bit across the
    # trees (the redesigns move the pad, widening, slice, cast and
    # requantize into the kernels; the values and the wire's bytes stay)
    for name in runs[0]["int8"]:
        print(json.dumps({"int8": name, "equal_other": len(
            {json.dumps(r["int8"][name]["sha256"]) for r in runs}) == 1}),
            flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
