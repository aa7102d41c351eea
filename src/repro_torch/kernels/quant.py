"""Wrappers of the hand-written int8 block-quantization kernels
(``csrc/quant.cu``; replace the JAX package's Pallas kernels in
``kernels/quant.py``: ``quantize_blocks``, ``dequantize_blocks``,
``dequant_accumulate``).

Every int8 transport of the train step shares one block layout: a tensor
is flattened, padded to whole blocks of ``BLOCK`` elements, and each
block carries one fp32 scale ``max(max|x| * INV_QMAX, SCALE_EPS)``.

The wrappers check what the kernels take, allocate the outputs and
launch on PyTorch's current stream. They never fall back: a tensor the
kernel does not take raises. The plain versions are in
``kernels/ref.py``; ``kernels/ops.py`` dispatches between the two by
device.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

BLOCK = 256        # quantization block: elements sharing one fp32 scale
SCALE_EPS = 1e-12  # scale floor: keeps all-zero blocks finite
# The scale multiplies by float32(1)/float32(127) (bits 0x3c010204), never
# divides by 127: kernel and plain version must round alike.
INV_QMAX = float(np.float32(1.0) / np.float32(127.0))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("quant")
    ptr, ll, stream = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p
    for name in ("int8_quantize_blocks_f32", "int8_quantize_blocks_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ll, stream]
        fn.restype = ctypes.c_int
    lib.int8_dequantize_blocks.argtypes = [ptr, ptr, ptr, ll, stream]
    lib.int8_dequantize_blocks.restype = ctypes.c_int
    lib.int8_dequant_accumulate.argtypes = [ptr, ptr, ptr, ctypes.c_int, ll,
                                            stream]
    lib.int8_dequant_accumulate.restype = ctypes.c_int
    return lib


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
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def quantize_blocks(x: torch.Tensor):
    """x: [nb, BLOCK] float32 or bfloat16 on the card -> (q int8 [nb,
    BLOCK], scale float32 [nb, 1]). bf16 is widened in registers, which
    is exact: the result equals that of ``x.float()``."""
    if x.dim() != 2 or x.shape[1] != BLOCK or x.shape[0] == 0:
        raise ValueError(f"x must be [nb>0, {BLOCK}], is {tuple(x.shape)}")
    nb = x.shape[0]
    _check("x", x, (torch.float32, torch.bfloat16), (nb, BLOCK), None)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = (lib.int8_quantize_blocks_f32 if x.dtype == torch.float32
          else lib.int8_quantize_blocks_bf16)
    _launch(fn, x.data_ptr(), q.data_ptr(), s.data_ptr(), nb,
            device=x.device)
    return q, s


def dequantize_blocks(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(q int8 [nb, BLOCK], s float32 [nb, 1]) -> float32 [nb, BLOCK]."""
    if q.dim() != 2 or q.shape[1] != BLOCK or q.shape[0] == 0:
        raise ValueError(f"q must be [nb>0, {BLOCK}], is {tuple(q.shape)}")
    nb = q.shape[0]
    _check("q", q, (torch.int8,), (nb, BLOCK), None)
    _check("s", s, (torch.float32,), (nb, 1), q.device, align=4)
    out = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    _launch(_lib().int8_dequantize_blocks, q.data_ptr(), s.data_ptr(),
            out.data_ptr(), nb, device=q.device)
    return out


def dequant_accumulate(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(q int8 [n, nb, BLOCK], s float32 [n, nb, 1]) -> float32 [nb,
    BLOCK]: the n dequantized sources summed in order 0..n-1."""
    if q.dim() != 3 or q.shape[2] != BLOCK or 0 in q.shape[:2]:
        raise ValueError(f"q must be [n>0, nb>0, {BLOCK}], is "
                         f"{tuple(q.shape)}")
    n, nb = q.shape[0], q.shape[1]
    _check("q", q, (torch.int8,), (n, nb, BLOCK), None)
    _check("s", s, (torch.float32,), (n, nb, 1), q.device, align=4)
    out = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    _launch(_lib().int8_dequant_accumulate, q.data_ptr(), s.data_ptr(),
            out.data_ptr(), n, nb, device=q.device)
    return out
