"""Dispatch for the port's kernels.

A CPU tensor goes to the kernel's plain version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel or raises -- there is no
fallback from the kernel to the plain version. Each dispatcher carries
a plain integer ``launches`` counter, raised by one per kernel launch
and nowhere else, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import collective_matmul, quant, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.mamba_scan import mamba_scan_fwd
from repro_torch.kernels.wkv6 import wkv6_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Skv,Hk,hd] (GQA by index); q_offset: int
    [B] absolute position of q[:, 0] (None = zeros)."""
    if q.device.type == "cpu":
        return ref.attention_plain(q, k, v, q_offset, causal, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    out = flash_attention_fwd(q, k, v, q_offset, causal, softmax_scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _kernel_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for {t.device}")
    return True


def int8_quantize_blocks(x: torch.Tensor, *, n_chunks: int = 1,
                         chunk_elems: Optional[int] = None,
                         blocks_per_chunk: Optional[int] = None):
    """x: float32/bfloat16 (any float on the CPU) in the chunked layout
    (``quant.chunk_layout``; by default x [nb, BLOCK], nb whole blocks)
    -> (q int8 [n_chunks * blocks_per_chunk, BLOCK], scale float32 [...,
    1])."""
    int8_quantize_blocks.calls += 1
    layout = dict(n_chunks=n_chunks, chunk_elems=chunk_elems,
                  blocks_per_chunk=blocks_per_chunk)
    if not _kernel_device(x, "int8 quantize"):
        return ref.int8_quantize_blocks_plain(x, **layout)
    out = quant.quantize_blocks(x, **layout)
    int8_quantize_blocks.launches += 1
    return out


def int8_dequantize_blocks(q: torch.Tensor, s: torch.Tensor, *,
                           n_chunks: int = 1,
                           chunk_elems: Optional[int] = None,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """(q int8 [nb, BLOCK], s float32 [nb, 1]) -> q * s in out_dtype
    (float32 or bfloat16), each of the n_chunks chunks' padding dropped
    past chunk_elems (``quant.dequant_layout``: [nb, BLOCK] by default,
    else [n_chunks * chunk_elems])."""
    int8_dequantize_blocks.calls += 1
    layout = dict(n_chunks=n_chunks, chunk_elems=chunk_elems,
                  out_dtype=out_dtype)
    if not _kernel_device(q, "int8 dequantize"):
        return ref.int8_dequantize_blocks_plain(q, s, **layout)
    out = quant.dequantize_blocks(q, s, **layout)
    int8_dequantize_blocks.launches += 1
    return out


def int8_dequant_accumulate(q: torch.Tensor, s: torch.Tensor, *,
                            chunk_elems: Optional[int] = None,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(q int8 [n, nb, BLOCK], s float32 [n, nb, 1]) -> the n sources
    folded in order in fp32, its first chunk_elems elements in out_dtype
    (float32 or bfloat16; ``quant.acc_layout``: [nb, BLOCK] by default,
    else [chunk_elems])."""
    int8_dequant_accumulate.calls += 1
    layout = dict(chunk_elems=chunk_elems, out_dtype=out_dtype)
    if not _kernel_device(q, "int8 dequant-accumulate"):
        return ref.int8_dequant_acc_plain(q, s, **layout)
    out = quant.dequant_accumulate(q, s, **layout)
    int8_dequant_accumulate.launches += 1
    return out


def int8_dequant_requantize(q: torch.Tensor, s: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 [n, nb, BLOCK], s float32 [n, nb, 1]) -> (q int8 [nb,
    BLOCK], scale float32 [nb, 1]): the fp32 fold of
    ``int8_dequant_accumulate`` quantized again in the same launch, as
    ``int8_quantize_blocks`` would. Its kernel is the dequant-accumulate
    kernel's, so its call and launch count on that dispatcher."""
    int8_dequant_accumulate.calls += 1
    if not _kernel_device(q, "int8 dequant-requantize"):
        return ref.int8_dequant_requant_plain(q, s)
    out = quant.dequant_requantize(q, s)
    int8_dequant_accumulate.launches += 1
    return out


# the int8 dispatchers by the names of core/engine/train.int8_launch_plan
INT8_KERNELS = {"quantize": int8_quantize_blocks,
                "dequantize": int8_dequantize_blocks,
                "dequant_accumulate": int8_dequant_accumulate}
for _fn in INT8_KERNELS.values():
    _fn.launches = _fn.calls = 0


def matmul_chunk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One chunk of the gather-fused matmul: x [M, K] @ w [K, N] -> [M,
    N] in their dtype (rows contiguous on the card)."""
    matmul_chunk.calls += 1
    if not _kernel_device(x, "matmul_chunk"):
        return ref.matmul_chunk_plain(x, w)
    out = collective_matmul.matmul_chunk(x, w)
    matmul_chunk.launches += 1
    return out


matmul_chunk.launches = matmul_chunk.calls = 0


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, chunk: int = 64):
    """RWKV-6 WKV: r, k, v, logw [B,S,H,hd], u [H,hd], s0 [B,H,hd,hd]
    fp32 or None (zeros) -> (out [B,S,H,hd] in r's dtype, final state
    [B,H,hd,hd] fp32). The chunk contract of the JAX package's
    ``_wkv_chunked`` (min(chunk, S) divides S) is held on every device,
    so the CPU and the card accept the same inputs; the kernel itself
    walks the steps one by one and has no chunk."""
    wkv6.calls += 1
    ref.wkv6_chunk_len(r.shape[1], chunk)
    if not _kernel_device(r, "wkv6"):
        return ref.wkv6_plain(r, k, v, logw, u, s0, chunk)
    out = wkv6_fwd(r, k, v, logw, u, s0)
    wkv6.launches += 1
    return out


wkv6.launches = wkv6.calls = 0


def mamba_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mamba's diagonal SSM scan h_t = a_t h_{t-1} + b_t: a, b [B,S,C]
    fp32 or bf16, h0 [B,C] fp32 or None (zeros) -> every state hs
    [B,S,C] fp32. Any S and C on both devices."""
    mamba_scan.calls += 1
    if not _kernel_device(a, "mamba_scan"):
        return _mamba_scan_plain(a, b, h0)
    out = mamba_scan_fwd(a, b, h0)
    mamba_scan.launches += 1
    return out


mamba_scan.launches = mamba_scan.calls = 0


@torch.library.custom_op("repro_torch::mamba_scan_plain", mutates_args=())
def _mamba_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ref.mamba_scan_plain`` as one op: on fake tensors (the dry run,
    ``launch/dryrun.py``) its S steps are one dispatch, its result's
    shape and dtype (below), not S steps of elementwise ops."""
    return ref.mamba_scan_plain(a, b, h0)


@_mamba_scan_plain.register_fake
def _(a, b, h0=None):
    return a.new_empty(a.shape, dtype=torch.promote_types(a.dtype,
                                                          torch.float32))


class _MambaScanTrain(torch.autograd.Function):
    """The scan with its gradient, both directions through
    ``mamba_scan`` (the kernel on the card, the plain scan on the CPU).

    The adjoint of h_t = a_t h_{t-1} + b_t is itself a first-order
    linear scan, backwards in time: with g_t the gradient of hs[:, t],
    lambda_t = g_t + a_{t+1} lambda_{t+1} (lambda_S = 0). So the same
    scan runs on the time-flipped g with the time-flipped a shifted by
    one step (its first coefficient meets the zero initial state, so
    its value is never read); then da_t = lambda_t h_{t-1} (h_{-1} = h0,
    or zeros), db_t = lambda_t and dh0 = a_0 lambda_0. The adjoint runs
    in fp32 whatever a's type."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs = mamba_scan(a, b, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.dtypes = (a.dtype, b.dtype)
        return hs

    @staticmethod
    def backward(ctx, g):
        a, hs, h0 = ctx.saved_tensors
        wide = torch.promote_types(a.dtype, torch.float32)
        rev = a.to(wide).flip(1)
        a_rev = torch.cat([torch.zeros_like(rev[:, :1]), rev[:, :-1]], 1)
        lam = mamba_scan(a_rev, g.to(wide).flip(1).contiguous()).flip(1)
        first = (torch.zeros_like(hs[:, :1]) if h0 is None
                 else h0.to(hs.dtype)[:, None])
        h_prev = torch.cat([first, hs[:, :-1]], 1)
        da = (lam * h_prev).to(ctx.dtypes[0])
        db = lam.to(ctx.dtypes[1])
        dh0 = None
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = (a[:, 0].to(lam.dtype) * lam[:, 0]).to(h0.dtype)
        return da, db, dh0


def mamba_scan_train(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mamba_scan`` (same arguments and result) with a gradient: the
    backward runs the adjoint scan on the same kernel
    (``_MambaScanTrain``), so on the card both directions count in
    ``mamba_scan.launches``. The train step's scan; serving calls
    ``mamba_scan``."""
    return _MambaScanTrain.apply(a, b, h0)


def collective_ag_matmul(x: torch.Tensor, w_shard: torch.Tensor, coll,
                         axis: str, mode: str = "ag_matmul",
                         sync_axes: Tuple[str, ...] = (),
                         reads: bool = True) -> torch.Tensor:
    """Gather-fused collective matmul (``kernels/collective_matmul.py``):
    ``x @ all_gather(w_shard, axis, dim 1)`` with the stage-2 column
    chunks consumed as the ring delivers them, each through
    ``matmul_chunk``; with ``reads`` False no ring runs and the product
    is zeros, for a caller that wants the backward only."""
    return collective_matmul.FusedMatmul.apply(x, w_shard, coll, axis, mode,
                                               tuple(sync_axes), reads)
