"""int8 block-quantized tensor-parallel activation all-reduce, as the
JAX package's ``core/act_compress.py`` builds it.

The Megatron pair's all-reduces over 'model' (a sublayer's output in the
forward, its normed input's gradient in the backward) carry the largest
activation tensors of a dense train step. An all-reduce is a
reduce-scatter and an all-gather; ``_int8_allreduce`` runs both hops in
int8 blocks with an fp32 scale each (``kernels/quant.py``'s 256-element
blocks), about half the bf16 bytes:

  quantize the tensor (the kernel pads its tail) -> all-to-all of the
  blocks and scales -> dequant-requantize (this rank's chunk of the sum,
  folded and quantized again in one kernel) -> all-gather of the blocks
  and scales -> dequantize

Every quantize, dequantize and dequant-requantize goes through
``kernels/ops.py``: the CUDA kernel on a card tensor, its plain version
on a CPU tensor.

  int8_psum      forward int8 all-reduce, backward identity (the
                 transpose of a psum): gradients see no quantization
                 beyond what the forward activations carry
  int8_bwd_psum  forward identity, backward int8 all-reduce: the entry of
                 a column-parallel region, whose input gradient is summed
                 over 'model'
"""
from __future__ import annotations

import torch

from repro_torch.core.grad_compress import _dequantize, _quantize
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quant import BLOCK


def _int8_allreduce(x: torch.Tensor, coll, axis: str) -> torch.Tensor:
    """The (approximate) sum of ``x`` over ``axis``, carried in int8.
    The flattened tensor is quantized as one chunk over n * nb blocks,
    its tail zeros, so each of the n chunks of the wire is a whole
    number of blocks; the arrived chunks fold and requantize in one
    kernel; the gathered blocks dequantize straight into the first
    ``total`` elements in x's dtype (``grad_compress._quantize`` and
    ``_dequantize``: no pad, widening, slice or cast around them)."""
    n = coll.size(axis)
    total = x.numel()
    nb = -(-total // (n * BLOCK))                   # blocks per rank chunk
    q, scale = _quantize(x, blocks_per_chunk=n * nb)
    # reduce-scatter hop: rank j receives every rank's chunk j
    q_x = coll.all_to_all(q, axis).reshape(n, nb, BLOCK)
    s_x = coll.all_to_all(scale, axis).reshape(n, nb, 1)
    # this rank's chunk of the sum, requantized for the all-gather hop
    q2, s2 = kops.int8_dequant_requantize(q_x, s_x)
    q_full = coll.all_gather(q2, axis, 0)
    s_full = coll.all_gather(s2, axis, 0)
    return _dequantize(q_full, s_full, 1, total, x.dtype).reshape(x.shape)


class _Int8Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, axis):
        return _int8_allreduce(x, coll, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Int8BwdPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, axis):
        ctx.coll, ctx.axis = coll, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _int8_allreduce(g, ctx.coll, ctx.axis), None, None


def int8_psum(x: torch.Tensor, coll, axis: str) -> torch.Tensor:
    """psum over ``axis`` with int8 transport; exact gradient (the
    identity)."""
    return _Int8Psum.apply(x, coll, axis)


def int8_bwd_psum(x: torch.Tensor, coll, axis: str) -> torch.Tensor:
    """Identity whose backward all-reduce over ``axis`` runs in int8."""
    return _Int8BwdPsum.apply(x, coll, axis)

