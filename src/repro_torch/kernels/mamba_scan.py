"""Wrapper of the hand-written Mamba scan kernel (``csrc/mamba_scan.cu``;
replaces the JAX package's Pallas ``kernels/mamba_scan.py:mamba_scan``,
plus the carried initial state the model's decode step needs).

It checks what the kernel takes, allocates the output and launches on
PyTorch's current stream. It never falls back: a tensor the kernel does
not take raises. ``kernels.ref.mamba_scan_plain`` is its plain version;
``kernels/ops.py`` dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

KERNELS = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}
MAX_BATCH = 65535            # the grid's y dimension


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mamba_scan")
    for name in KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on a CUDA device"
                         f"{'' if device is None else f' ({device})'}, is on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, is "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mamba_scan_fwd(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: [B,S,C] float32 or bfloat16 (one type); h0: [B,C] float32
    or None (zeros); all contiguous on one card. Returns every state hs
    [B,S,C] float32."""
    if a.dim() != 3:
        raise ValueError(f"a must be [B,S,C], is {tuple(a.shape)}")
    B, S, C = a.shape
    if min(B, S, C) == 0:
        raise ValueError(f"empty scan input {tuple(a.shape)}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} above the kernel's {MAX_BATCH}")
    if max(S, C) >= 2 ** 31:
        raise ValueError(f"S {S} or C {C} does not fit the kernel's int "
                         "arguments")
    if a.dtype not in KERNELS:
        raise ValueError(f"a must be one of {tuple(KERNELS)}, is {a.dtype}")
    dev = a.device
    _check("a", a, a.dtype, a.shape, None)
    _check("b", b, a.dtype, a.shape, dev)
    if h0 is not None:
        _check("h0", h0, torch.float32, (B, C), dev)
    fn = getattr(_lib(), KERNELS[a.dtype])
    hs = torch.empty((B, S, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), hs.data_ptr(), B, S,
                 C, stream)
    if err != 0:
        raise RuntimeError(f"{KERNELS[a.dtype]} launch failed: CUDA error "
                           f"{err}")
    return hs
