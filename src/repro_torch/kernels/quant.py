"""Wrappers of the hand-written int8 block-quantization kernels
(``csrc/quant.cu``; replace the JAX package's Pallas kernels in
``kernels/quant.py``: ``quantize_blocks``, ``dequantize_blocks``,
``dequant_accumulate``; ``dequant_requantize`` is the last one's kernel
with its fold quantized again in the same launch).

Every int8 transport of the train step shares one block layout: a tensor
is flattened, cut into chunks (one per rank of the collective, or one),
each chunk padded with zeros to whole blocks of ``BLOCK`` elements, and
each block carries one fp32 scale ``max(max|x| * INV_QMAX, SCALE_EPS)``.
Quantize and dequantize take that chunked layout themselves
(``chunk_layout``): they read and write the callers' dense tensors in
the callers' dtype, and do the padding, the widening, the slicing and
the cast in their own pass. Dequant-accumulate writes its fold's first
``chunk_elems`` elements in the caller's dtype (``acc_layout``);
dequant-requantize quantizes the fold into int8 blocks instead.

The wrappers check what the kernels take, allocate the outputs and
launch on PyTorch's current stream. They never fall back: a tensor the
kernel does not take raises. The plain versions are in
``kernels/ref.py``; ``kernels/ops.py`` dispatches between the two by
device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

BLOCK = 256        # quantization block: elements sharing one fp32 scale
SCALE_EPS = 1e-12  # scale floor: keeps all-zero blocks finite
# The scale multiplies by float32(1)/float32(127) (bits 0x3c010204), never
# divides by 127: kernel and plain version must round alike.
INV_QMAX = float(np.float32(1.0) / np.float32(127.0))
OUT_DTYPES = (torch.float32, torch.bfloat16)   # what dequantize writes
MAX_BLOCKS = 2 ** 31    # quantize / dequantize count rows in 31 bits


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("quant")
    ptr, ll, stream = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p
    for name in ("int8_quantize_blocks_f32", "int8_quantize_blocks_bf16",
                 "int8_dequantize_blocks_f32", "int8_dequantize_blocks_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ll, ll, ll, stream]
        fn.restype = ctypes.c_int
    for name in ("int8_dequant_accumulate_f32",
                 "int8_dequant_accumulate_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ll, ll, stream]
        fn.restype = ctypes.c_int
    lib.int8_dequant_requantize.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int,
                                            ll, stream]
    lib.int8_dequant_requantize.restype = ctypes.c_int
    return lib


def chunk_layout(numel: int, n_chunks: int = 1,
                 chunk_elems: Optional[int] = None,
                 blocks_per_chunk: Optional[int] = None) -> Tuple[int, int]:
    """(chunk_elems, blocks_per_chunk) of the chunked layout: ``numel``
    dense elements in ``n_chunks`` chunks of ``chunk_elems`` each
    (default: numel / n_chunks), each quantized into
    ``blocks_per_chunk`` blocks (default: ceil(chunk_elems / BLOCK)),
    the elements past chunk_elems counting as zeros. Raises on a layout
    the kernels do not take; the plain versions take the same ones."""
    if n_chunks < 1 or numel % n_chunks:
        raise ValueError(f"{numel} elements do not split into n_chunks="
                         f"{n_chunks} chunks")
    if chunk_elems is None:
        chunk_elems = numel // n_chunks
    if chunk_elems < 1 or n_chunks * chunk_elems != numel:
        raise ValueError(f"n_chunks={n_chunks} x chunk_elems={chunk_elems} "
                         f"is not the tensor's {numel} elements")
    least = -(-chunk_elems // BLOCK)
    if blocks_per_chunk is None:
        blocks_per_chunk = least
    if blocks_per_chunk < least:
        raise ValueError(f"blocks_per_chunk={blocks_per_chunk} cannot hold "
                         f"chunk_elems={chunk_elems} ({least} blocks)")
    _check_blocks(n_chunks * blocks_per_chunk)
    return chunk_elems, blocks_per_chunk


def _check_blocks(nb: int) -> None:
    if nb >= MAX_BLOCKS:
        raise ValueError(f"{nb} blocks: the kernels count blocks in 31 bits")


def dequant_layout(nb: int, n_chunks: int = 1,
                   chunk_elems: Optional[int] = None,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[int, int, Tuple[int, ...]]:
    """(chunk_elems, blocks_per_chunk, output shape) of a dequantize of
    ``nb`` blocks in ``n_chunks`` chunks: with chunk_elems left at its
    default (whole blocks) the [nb, BLOCK] grid, else the dense
    [n_chunks * chunk_elems] values. Raises on what the kernel does not
    take."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, is "
                         f"{out_dtype}")
    if n_chunks < 1 or nb % n_chunks:
        raise ValueError(f"{nb} blocks do not split into n_chunks="
                         f"{n_chunks} chunks")
    _check_blocks(nb)
    bpc = nb // n_chunks
    if chunk_elems is None:
        return bpc * BLOCK, bpc, (nb, BLOCK)
    if not 1 <= chunk_elems <= bpc * BLOCK:
        raise ValueError(f"chunk_elems={chunk_elems} does not fit the "
                         f"{bpc} blocks of a chunk")
    return chunk_elems, bpc, (n_chunks * chunk_elems,)


def acc_layout(q_shape, chunk_elems: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32
               ) -> Tuple[int, int, int, Tuple[int, ...]]:
    """(n, nb, chunk_elems, output shape) of a dequant-accumulate of q
    [n, nb, BLOCK]: the fold's first ``chunk_elems`` elements in
    ``out_dtype`` (``dequant_layout`` of one chunk: [nb, BLOCK] by
    default, else [chunk_elems]). Raises on what the kernel does not
    take."""
    if len(q_shape) != 3 or q_shape[2] != BLOCK or 0 in q_shape[:2]:
        raise ValueError(f"q must be [n>0, nb>0, {BLOCK}], is "
                         f"{tuple(q_shape)}")
    n, nb = q_shape[0], q_shape[1]
    chunk_elems, _, shape = dequant_layout(nb, 1, chunk_elems, out_dtype)
    return n, nb, chunk_elems, shape


def _check(name: str, t: torch.Tensor, dtypes, shape, device,
           align: int = 16) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on a CUDA device"
                         f"{'' if device is None else f' ({device})'}, is on "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, is "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(fn, *args, device) -> None:
    err = _build.launch(device, fn, *args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def quantize_blocks(x: torch.Tensor, *, n_chunks: int = 1,
                    chunk_elems: Optional[int] = None,
                    blocks_per_chunk: Optional[int] = None):
    """x: float32 or bfloat16 on the card, contiguous, read in place as
    ``n_chunks`` chunks of ``chunk_elems`` elements (``chunk_layout``;
    the defaults take x [nb, BLOCK] as nb whole blocks) -> (q int8
    [n_chunks * blocks_per_chunk, BLOCK], scale float32 [..., 1]). A
    chunk's blocks past its elements quantize zeros. bf16 is widened in
    registers, which is exact: the result equals that of ``x.float()``."""
    chunk_elems, bpc = chunk_layout(x.numel(), n_chunks, chunk_elems,
                                    blocks_per_chunk)
    _check("x", x, (torch.float32, torch.bfloat16), x.shape, None,
           align=x.element_size())
    nb = n_chunks * bpc
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = (lib.int8_quantize_blocks_f32 if x.dtype == torch.float32
          else lib.int8_quantize_blocks_bf16)
    _launch(fn, x.data_ptr(), q.data_ptr(), s.data_ptr(), n_chunks,
            chunk_elems, bpc, device=x.device)
    return q, s


def dequantize_blocks(q: torch.Tensor, s: torch.Tensor, *, n_chunks: int = 1,
                      chunk_elems: Optional[int] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q int8 [nb, BLOCK], s float32 [nb, 1]) -> their values q * s in
    ``out_dtype`` (float32 or bfloat16), written dense: the nb blocks
    are ``n_chunks`` chunks of nb / n_chunks blocks holding
    ``chunk_elems`` elements each, and each chunk's padding is dropped
    (``dequant_layout``: [nb, BLOCK] by default, else [n_chunks *
    chunk_elems])."""
    if q.dim() != 2 or q.shape[1] != BLOCK or q.shape[0] == 0:
        raise ValueError(f"q must be [nb>0, {BLOCK}], is {tuple(q.shape)}")
    nb = q.shape[0]
    chunk_elems, bpc, shape = dequant_layout(nb, n_chunks, chunk_elems,
                                             out_dtype)
    _check("q", q, (torch.int8,), (nb, BLOCK), None)
    _check("s", s, (torch.float32,), (nb, 1), q.device, align=4)
    out = torch.empty(shape, dtype=out_dtype, device=q.device)
    lib = _lib()
    fn = (lib.int8_dequantize_blocks_f32 if out_dtype == torch.float32
          else lib.int8_dequantize_blocks_bf16)
    _launch(fn, q.data_ptr(), s.data_ptr(), out.data_ptr(), n_chunks,
            chunk_elems, bpc, device=q.device)
    return out


def _check_sources(q: torch.Tensor, s: torch.Tensor, n: int,
                   nb: int) -> None:
    _check("q", q, (torch.int8,), (n, nb, BLOCK), None)
    _check("s", s, (torch.float32,), (n, nb, 1), q.device, align=4)


def dequant_accumulate(q: torch.Tensor, s: torch.Tensor, *,
                       chunk_elems: Optional[int] = None,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """(q int8 [n, nb, BLOCK], s float32 [n, nb, 1]) -> the n dequantized
    sources summed in order 0..n-1 in fp32, written as its first
    ``chunk_elems`` elements in ``out_dtype`` (float32 or bfloat16;
    ``acc_layout``: [nb, BLOCK] by default, else [chunk_elems])."""
    n, nb, chunk_elems, shape = acc_layout(q.shape, chunk_elems, out_dtype)
    _check_sources(q, s, n, nb)
    out = torch.empty(shape, dtype=out_dtype, device=q.device)
    lib = _lib()
    fn = (lib.int8_dequant_accumulate_f32 if out_dtype == torch.float32
          else lib.int8_dequant_accumulate_bf16)
    _launch(fn, q.data_ptr(), s.data_ptr(), out.data_ptr(), n, nb,
            chunk_elems, device=q.device)
    return out


def dequant_requantize(q: torch.Tensor, s: torch.Tensor):
    """(q int8 [n, nb, BLOCK], s float32 [n, nb, 1]) -> (q int8 [nb,
    BLOCK], s float32 [nb, 1]): ``dequant_accumulate``'s fp32 fold
    quantized in registers in the same launch, what ``quantize_blocks``
    makes of it."""
    n, nb, _, _ = acc_layout(q.shape)
    _check_sources(q, s, n, nb)
    q2 = torch.empty((nb, BLOCK), dtype=torch.int8, device=q.device)
    s2 = torch.empty((nb, 1), dtype=torch.float32, device=q.device)
    _launch(_lib().int8_dequant_requantize, q.data_ptr(), s.data_ptr(),
            q2.data_ptr(), s2.data_ptr(), n, nb, device=q.device)
    return q2, s2
