"""Wrapper of the hand-written RWKV-6 WKV kernel (``csrc/wkv6.cu``;
replaces the JAX package's Pallas ``kernels/rwkv6_scan.py:wkv6_chunked``,
plus the carried initial state the model's decode step needs).

It checks what the kernel takes, allocates the outputs and launches on
PyTorch's current stream. It never falls back: a tensor the kernel does
not take raises. ``kernels.ref.wkv6_plain`` is its plain version;
``kernels/ops.py`` dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64)
KERNELS = {torch.float32: "wkv6_fwd_f32", torch.bfloat16: "wkv6_fwd_bf16"}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("wkv6")
    for name in KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
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
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _new_outputs(r: torch.Tensor, B: int, H: int, hd: int):
    return (torch.empty_like(r),
            torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device))


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: [B,S,H,hd] float32 or bfloat16 (one type); logw:
    [B,S,H,hd] float32; u: [H,hd] float32; s0: [B,H,hd,hd] float32 or
    None (zeros); all contiguous and 16-byte aligned on one card, hd in
    ``HEAD_DIMS``.
    Returns (out [B,S,H,hd] in r's type, final state [B,H,hd,hd]
    float32)."""
    if r.dim() != 4:
        raise ValueError(f"r must be [B,S,H,hd], is {tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(B, S, H) == 0:
        raise ValueError(f"empty wkv input {tuple(r.shape)}")
    if r.dtype not in KERNELS:
        raise ValueError(f"r must be one of {tuple(KERNELS)}, is {r.dtype}")
    dev = r.device
    _check("r", r, r.dtype, r.shape, None)
    for name, t, dt, shape in (("k", k, r.dtype, r.shape),
                               ("v", v, r.dtype, r.shape),
                               ("logw", logw, torch.float32, r.shape),
                               ("u", u, torch.float32, (H, hd))):
        _check(name, t, dt, shape, dev)
    if s0 is not None:
        _check("s0", s0, torch.float32, (B, H, hd, hd), dev)
    fn = getattr(_lib(), KERNELS[r.dtype])
    out, state = _new_outputs(r, B, H, hd)
    err = _build.launch(dev, fn, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(),
                        None if s0 is None else s0.data_ptr(),
                        out.data_ptr(), state.data_ptr(), B, S, H, hd)
    if err != 0:
        raise RuntimeError(f"{KERNELS[r.dtype]} launch failed: CUDA error "
                           f"{err}")
    return out, state
