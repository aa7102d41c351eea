"""int8 block-quantized stage-1 (pod-axis) collectives, after ZeRO++
(arXiv:2306.10209), as the JAX package's ``core/grad_compress.py``
builds them on the shared per-256-block quantization
(``kernels/ops.py``: the CUDA kernels on the card, their plain versions
on the CPU).

  * qgZ -- ``CompressedStage1Gather``: the exact stage-1 all-gather whose
    gradient reduce-scatter carries int8 (``int8_psum_scatter``).
  * qwZ -- ``QuantizedStage1Gather``: the stage-1 weight all-gather
    itself carries int8 blocks and fp32 scales, dequantized on arrival.
    Its gradient reduce-scatter is exact, or int8 as well with
    ``compress_bwd``. Under FCDP the dequantized result is what the host
    cache keeps, so the backward reuse stays free.

The two gathers are ``torch.autograd.Function``s with the forward and
backward of the JAX package's ``custom_vjp``s.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.quant import BLOCK


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 block quantization of the flattened tensor, padded
    with zeros to whole blocks. Returns (q int8 [nb, BLOCK], scale
    float32 [nb, 1]). A bf16 tensor goes to the kernel as it is (it
    widens exactly); the plain version widens to fp32 first."""
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.float()
    return kops.int8_quantize_blocks(flat.reshape(-1, BLOCK).contiguous())


def int8_psum_scatter(g: torch.Tensor, coll, axis: str,
                      dim: int) -> torch.Tensor:
    """Reduce-scatter of ``g`` over ``axis`` along ``dim``, carried in
    int8: split into n chunks along dim, quantize each (padded to whole
    blocks), all-to-all the chunks so rank j receives every rank's chunk
    j, then fold them with the dequant-accumulate loop. Returns this
    rank's block of the sum, in g's dtype."""
    n = coll.mesh.mesh_shape.size(axis)
    if n == 1:
        return g
    moved = g.movedim(dim, 0)
    lead = moved.shape[0]
    if lead % n:
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                         f"over {n} ranks")
    chunk_elems = (lead // n) * math.prod(moved.shape[1:])
    flat = moved.reshape(n, chunk_elems).float()
    pad = (-chunk_elems) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    nb = flat.shape[1] // BLOCK                    # blocks per chunk
    q, scale = kops.int8_quantize_blocks(flat.reshape(n * nb, BLOCK))
    q_x = coll.all_to_all(q, axis).reshape(n, nb, BLOCK)
    s_x = coll.all_to_all(scale, axis).reshape(n, nb, 1)
    summed = kops.int8_dequant_accumulate(q_x, s_x).reshape(-1)
    out = summed[:chunk_elems].reshape((lead // n,) + tuple(moved.shape[1:]))
    return out.movedim(0, dim).to(g.dtype)


def quantized_gather(w: torch.Tensor, coll, axis: str,
                     dim: int) -> torch.Tensor:
    """qwZ forward: quantize the local shard, all-gather blocks and
    scales over ``axis``, dequantize on arrival, drop each rank's block
    padding and return the gathered tensor in w's dtype."""
    n = coll.mesh.mesh_shape.size(axis)
    moved = w.movedim(dim, 0)
    elems = moved.numel()
    q, s = _quantize(moved)
    q_all = coll.all_gather(q, axis, 0)
    s_all = coll.all_gather(s, axis, 0)
    vals = kops.int8_dequantize_blocks(q_all, s_all)
    vals = vals.reshape(n, -1)[:, :elems]
    out = vals.reshape((n * moved.shape[0],) + tuple(moved.shape[1:]))
    return out.movedim(0, dim).to(w.dtype)


class CompressedStage1Gather(torch.autograd.Function):
    """qgZ: exact all-gather over ``axis`` whose gradient reduce-scatter
    is int8."""

    @staticmethod
    def forward(ctx, w, coll, axis, dim):
        ctx.coll, ctx.axis, ctx.dim = coll, axis, dim
        return coll.all_gather(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return int8_psum_scatter(g, ctx.coll, ctx.axis, ctx.dim), None, \
            None, None


class QuantizedStage1Gather(torch.autograd.Function):
    """qwZ: stage-1 all-gather in int8 blocks and fp32 scales. The
    gradient reduce-scatter is exact unless ``compress_bwd`` also sends
    it through qgZ."""

    @staticmethod
    def forward(ctx, w, coll, axis, dim, compress_bwd):
        ctx.coll, ctx.axis, ctx.dim = coll, axis, dim
        ctx.compress_bwd = compress_bwd
        return quantized_gather(w, coll, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.compress_bwd:
            gw = int8_psum_scatter(g, ctx.coll, ctx.axis, ctx.dim)
        else:
            gw = ctx.coll.reduce_scatter(g, ctx.axis, ctx.dim)
        return gw, None, None, None, None
