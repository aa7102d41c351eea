"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``; replaces the JAX package's Pallas
``kernels/flash_attention.py:_flash_fwd_kernel``).

It checks what the kernel takes, allocates the output and launches on
PyTorch's current stream. It never falls back: a tensor the kernel does
not take raises. ``kernels.ref.attention_plain`` is its plain version.

Three variants of one function (``variant``): the prefill variant
(wgmma + TMA, the GQA group's query heads packed into one CTA) takes hd
128, Sq >= 64 and a GQA group size H / Hk that divides 64 -- the prefill
of qwen2.5-3b's paged chunks and of jamba's prompts; the decode variant
(split-KV, one CTA per (key split, kv head, batch row) serving the whole
GQA group, the splits merged in the same launch) takes Sq 1, hd 64 or
128 and H / Hk <= 16 -- the decode of both serve paths; everything else
(Sq 2-63, hd 16/32, larger groups, and hd 112 / 256 at every Sq: kimi's
and gemma's prefill and decode) takes the mma.sync kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# the decode variant: head dims, the largest GQA group (the m16 tile's
# rows) and the keys of one split
SPLIT_HEAD_DIMS = (64, 128)
SPLIT_MAX_GROUP = 16
KEYS_PER_SPLIT = 64


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("flash_attention")
    fns = {"mma": lib.flash_attention_fwd_bf16,
           "tma": lib.flash_attention_fwd_bf16_tma,
           "split": lib.flash_attention_decode_bf16}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns["mma"].argtypes = ([ptr] * 5 + [i32] * 7 + [ctypes.c_float, ptr])
    fns["tma"].argtypes = ([ptr] * 5 + [i32] * 6 + [ctypes.c_float, ptr])
    fns["split"].argtypes = ([ptr] * 7 + [i32] * 7 + [ctypes.c_float, ptr])
    for fn in fns.values():
        fn.restype = i32
    return fns


def variant(Sq: int, H: int, Hk: int, hd: int) -> str:
    """"split" (the split-KV decode kernel) for Sq 1, hd 64 or 128 and
    H / Hk <= 16; "tma" (the wgmma + TMA prefill kernel) for hd 128,
    Sq >= 64 and H / Hk dividing 64; "mma" (the mma.sync kernel)
    otherwise."""
    if Sq == 1 and hd in SPLIT_HEAD_DIMS and H // Hk <= SPLIT_MAX_GROUP:
        return "split"
    return "tma" if hd == 128 and Sq >= 64 and 64 % (H // Hk) == 0 \
        else "mma"


def split_plan(B: int, H: int, Hk: int, Skv: int, hd: int
               ) -> Tuple[int, int, int]:
    """The decode variant's split of the keys: (keys per split, splits,
    fp32 workspace floats). 64 keys a split, the size that measured
    fastest at both serve shapes on the H100 (qwen2.5-3b's 16 (b, kv
    head) pairs over 512 keys, jamba's 64 over 544; ``chip_smoke.py``'s
    split sweep). The workspace holds every split's partial (acc [G, hd],
    then (m, l) per query head): none when one split covers the keys."""
    splits = -(-Skv // KEYS_PER_SPLIT)
    return (KEYS_PER_SPLIT, splits,
            0 if splits == 1 else splits * B * H * (hd + 2))


def _new_output(q: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(q)


def _new_workspace(q: torch.Tensor, floats: int) -> torch.Tensor:
    return torch.empty(floats, dtype=torch.float32, device=q.device)


_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode variant's per-(b, kv head) split counters for the
    current stream of ``device``: zeroed once, and left zero by every
    launch (the CTA that merges a row's splits resets its counter). One
    buffer a stream, so launches on two streams never share counts."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """q: [B,Sq,H,hd], k/v: [B,Skv,Hk,hd] bf16 CUDA tensors, contiguous;
    q_offset: int32 [B] (None = zeros). Returns [B,Sq,H,hd] bf16."""
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Skv, Hk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if Hk == 0 or H % Hk:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hk}")
    if min(B, Sq, Skv) == 0:
        raise ValueError("empty attention input")
    if q_offset is None:
        q_offset = torch.zeros(B, dtype=torch.int32, device=q.device)
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                        ("v", v, torch.bfloat16),
                        ("q_offset", q_offset, torch.int32)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, is on "
                             f"{t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q_offset.shape != (B,):
        raise ValueError(f"q_offset must be [{B}], is "
                         f"{tuple(q_offset.shape)}")
    scale = softmax_scale or (1.0 / math.sqrt(hd))
    kind = variant(Sq, H, Hk, hd)
    fn = _kernels()[kind]
    out = _new_output(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
            out.data_ptr())
    if kind == "split":
        keys, splits, floats = split_plan(B, H, Hk, Skv, hd)
        # both stay referenced until the launch is queued (a workspace
        # freed before it could be handed to the counters' allocation)
        cnt = None if splits == 1 else _counters(q.device, B * Hk)
        ws = None if splits == 1 else _new_workspace(q, floats)
        extra = ((None, None) if splits == 1 else
                 (ws.data_ptr(), cnt.data_ptr()))
        args = ptrs + extra + (B, Skv, H, Hk, hd, keys)
    else:
        args = ptrs + (B, Sq, Skv, H, Hk) + ((hd,) if kind == "mma" else ())
    err = _build.launch(q.device, fn, *args, int(causal), scale)
    if err != 0:
        raise RuntimeError(f"flash attention ({kind}) launch failed: CUDA "
                           f"error {err}")
    return out
