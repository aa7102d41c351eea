"""int8 block-quantized stage-1 (pod-axis) collectives, after ZeRO++
(arXiv:2306.10209), as the JAX package's ``core/grad_compress.py``
builds them on the shared per-256-block quantization
(``kernels/ops.py``: the CUDA kernels on the card, their plain versions
on the CPU).

  * qgZ -- ``int8_psum_scatter``: the stage-1 gather's gradient
    reduce-scatter carries int8; ``QuantizedReducePending`` issues it
    as async work (the async 'pod' gradient reduce).
  * qwZ -- ``QuantizedPending`` / ``quantized_gather``: the stage-1
    weight all-gather itself carries int8 blocks and fp32 scales,
    dequantized on arrival. Under FCDP the dequantized result is what
    the host cache keeps, so the backward reuse stays free.

``core/fcdp.py``'s ``Stage1Gather`` puts them together in autograd, with
the forward and backward of the JAX package's ``custom_vjp``s.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.quant import BLOCK, OUT_DTYPES


def _quantize(g: torch.Tensor, n_chunks: int = 1,
              blocks_per_chunk: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The issue side of every int8 transport: symmetric int8 block
    quantization of the flattened tensor in ``n_chunks`` equal chunks,
    each padded with zeros to ``blocks_per_chunk`` blocks (default:
    whole blocks). Returns (q int8 [n_chunks * blocks_per_chunk, BLOCK],
    scale float32 [..., 1]). A float32 or bfloat16 tensor goes to the
    kernel as it is (it reads the chunks in place; bf16 widens exactly),
    any other widens to fp32 first."""
    flat = g.contiguous().reshape(-1)
    if flat.dtype not in OUT_DTYPES:
        flat = flat.float()
    return kops.int8_quantize_blocks(flat, n_chunks=n_chunks,
                                     blocks_per_chunk=blocks_per_chunk)


def _dequantize(q: torch.Tensor, s: torch.Tensor, n_chunks: int,
                chunk_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """The arrival side: the values of ``n_chunks`` chunks of
    ``chunk_elems`` elements (each chunk's block padding dropped) as a
    flat tensor of ``dtype``. The kernel writes float32 and bfloat16
    itself; any other dtype is cast from fp32."""
    out_dtype = dtype if dtype in OUT_DTYPES else torch.float32
    vals = kops.int8_dequantize_blocks(q, s, n_chunks=n_chunks,
                                       chunk_elems=chunk_elems,
                                       out_dtype=out_dtype)
    return vals.to(dtype)


def _accumulate(q: torch.Tensor, s: torch.Tensor, chunk_elems: int,
                dtype: torch.dtype) -> torch.Tensor:
    """qgZ's arrival: the n sources' blocks (q int8 [n, nb, BLOCK], s
    float32 [n, nb, 1]) folded in order, the first ``chunk_elems``
    elements as a flat tensor of ``dtype``. The kernel writes float32
    and bfloat16 itself; any other dtype is cast from fp32."""
    out_dtype = dtype if dtype in OUT_DTYPES else torch.float32
    vals = kops.int8_dequant_accumulate(q, s, chunk_elems=chunk_elems,
                                        out_dtype=out_dtype)
    return vals.to(dtype)


def int8_psum_scatter(g: torch.Tensor, coll, axis: str,
                      dim: int) -> torch.Tensor:
    """Reduce-scatter of ``g`` over ``axis`` along ``dim``, carried in
    int8: split into n chunks along dim, quantize each (the kernel pads
    each to whole blocks), all-to-all the chunks so rank j receives
    every rank's chunk j, then fold them with the dequant-accumulate
    loop, which writes this rank's block of the sum in g's dtype."""
    return QuantizedReducePending(g, coll, axis, dim).wait()


class QuantizedReducePending:
    """A qgZ reduce-scatter in flight (``int8_psum_scatter`` issued as
    async work): the chunks were quantized at issue and their blocks and
    scales are in the all-to-all; ``wait()`` folds them with the
    dequant-accumulate loop straight into the block's elements in g's
    dtype (``_accumulate``: no slice or cast around the kernel). The
    same bytes and kernel calls as ``int8_psum_scatter``."""

    def __init__(self, g: torch.Tensor, coll, axis: str, dim: int):
        self.n = n = coll.mesh.mesh_shape.size(axis)
        self.dim, self.dtype = dim, g.dtype
        if n == 1:
            self.value, self.parts = g, None
            return
        moved = g.movedim(dim, 0)
        lead = moved.shape[0]
        if lead % n:
            raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                             f"over {n} ranks")
        self.shape = (lead // n,) + tuple(moved.shape[1:])
        self.chunk_elems = math.prod(self.shape)
        self.nb = -(-self.chunk_elems // BLOCK)        # blocks per chunk
        q, scale = _quantize(moved, n)
        self.value = None
        self.parts = (coll.all_to_all_async(q, axis),
                      coll.all_to_all_async(scale, axis))

    def wait(self) -> torch.Tensor:
        if self.parts is not None:
            q_x, s_x = (p.wait() for p in self.parts)
            self.parts = None
            vals = _accumulate(q_x.reshape(self.n, self.nb, BLOCK),
                               s_x.reshape(self.n, self.nb, 1),
                               self.chunk_elems, self.dtype)
            self.value = vals.reshape(self.shape).movedim(0, self.dim)
        return self.value


class QuantizedPending:
    """A qwZ gather in flight: the shard was quantized at issue and its
    blocks and scales are being all-gathered; ``wait()`` dequantizes
    them on arrival, drops each rank's block padding and returns the
    gathered tensor in the shard's dtype."""

    def __init__(self, w: torch.Tensor, coll, axis: str, dim: int):
        self.n = coll.mesh.mesh_shape.size(axis)
        moved = w.movedim(dim, 0)
        self.shape, self.dim, self.dtype = moved.shape, dim, w.dtype
        q, s = _quantize(moved)
        self.parts = (coll.all_gather_async(q, axis, 0),
                      coll.all_gather_async(s, axis, 0))

    def wait(self) -> torch.Tensor:
        q_all, s_all = (p.wait() for p in self.parts)
        vals = _dequantize(q_all, s_all, self.n, math.prod(self.shape),
                           self.dtype)
        out = vals.reshape((self.n * self.shape[0],)
                           + tuple(self.shape[1:]))
        return out.movedim(0, self.dim)


def quantized_gather(w: torch.Tensor, coll, axis: str,
                     dim: int) -> torch.Tensor:
    """qwZ forward: quantize the local shard, all-gather blocks and
    scales over ``axis``, dequantize on arrival, drop each rank's block
    padding and return the gathered tensor in w's dtype."""
    return QuantizedPending(w, coll, axis, dim).wait()
