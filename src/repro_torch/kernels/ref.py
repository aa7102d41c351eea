"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against, and what the wrappers run on CPU
tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.quant import (BLOCK, INV_QMAX, SCALE_EPS,
                                      acc_layout, chunk_layout,
                                      dequant_layout)

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,KVH,hd] -> [B,S,KVH*n_rep,hd] by repeating each kv head
    (q head h reads kv head h // n_rep)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialization attention with per-row causal offsets.

    q: [B, Sq, H, hd]; k, v: [B, Skv, Hk, hd] with H % Hk == 0 (GQA:
    q head h reads kv head h // (H // Hk)). q_offset: int [B], the
    absolute position of q[b, 0] (None = all zeros). Key j is visible
    to query i of row b iff j < Skv and (not causal or
    j <= q_offset[b] + i). fp32 throughout; the output is
    ``acc / max(l, 1e-20)`` cast to q's dtype -- the function of the
    JAX package's ``flash_attention_fwd`` (q_offset = 0) and of its
    ``chunked_causal_attention`` with a [B] ``q_offset``.
    """
    B, Sq, H, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hk}")
    scale = softmax_scale or (1.0 / math.sqrt(hd))
    kf = expand_kv(k, H // Hk).float()
    vf = expand_kv(v, H // Hk).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        off = (torch.zeros(B, dtype=torch.int64, device=q.device)
               if q_offset is None else q_offset.to(torch.int64))
        qpos = off[:, None] + torch.arange(Sq, device=q.device)[None, :]
        kpos = torch.arange(Skv, device=q.device)
        mask = kpos[None, None, :] <= qpos[:, :, None]           # [B,Sq,Skv]
        s = torch.where(mask[:, None], s, torch.full((), NEG_INF,
                                                     device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                            # [B,H,Sq]
    acc = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = acc / torch.clamp(l, min=1e-20).permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def int8_quantize_blocks_plain(x: torch.Tensor, *, n_chunks: int = 1,
                               chunk_elems: Optional[int] = None,
                               blocks_per_chunk: Optional[int] = None):
    """Symmetric per-block int8 quantization of x in the chunked layout
    (``quant.chunk_layout``; the defaults take x [nb, BLOCK] as nb whole
    blocks): each chunk padded with zeros to its blocks, then per block
    scale = max(max|x| * INV_QMAX, SCALE_EPS) and q = clip(round_half_even(
    x / scale), -127, 127) -- ``torch.round`` rounds half to even, as
    ``jnp.round`` does. Returns (q int8 [n_chunks * blocks_per_chunk,
    BLOCK], scale float32 [..., 1])."""
    chunk_elems, bpc = chunk_layout(x.numel(), n_chunks, chunk_elems,
                                    blocks_per_chunk)
    flat = x.reshape(n_chunks, chunk_elems)
    if bpc * BLOCK != chunk_elems:
        padded = flat.new_zeros((n_chunks, bpc * BLOCK))
        padded[:, :chunk_elems] = flat
        flat = padded
    blocks = flat.reshape(-1, BLOCK).float()
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True)
                            * INV_QMAX, SCALE_EPS)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize_blocks_plain(q: torch.Tensor, s: torch.Tensor, *,
                                 n_chunks: int = 1,
                                 chunk_elems: Optional[int] = None,
                                 out_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """(q int8 [nb, BLOCK], s float32 [nb, 1]) -> q * s in fp32, each of
    the ``n_chunks`` chunks' padding dropped past ``chunk_elems``, cast
    to ``out_dtype`` (``quant.dequant_layout``: [nb, BLOCK] by default,
    else [n_chunks * chunk_elems])."""
    chunk_elems, bpc, shape = dequant_layout(q.shape[0], n_chunks,
                                             chunk_elems, out_dtype)
    vals = (q.float() * s).reshape(n_chunks, bpc * BLOCK)[:, :chunk_elems]
    return vals.reshape(shape).to(out_dtype)


def int8_dequant_acc_plain(q: torch.Tensor, s: torch.Tensor, *,
                           chunk_elems: Optional[int] = None,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The reduce-scatter inner loop: the n dequantized source chunks
    summed in source order, each product and each sum rounded on its own
    (two PyTorch ops, never contracted into an FMA). q: [n, nb, BLOCK]
    int8, s: [n, nb, 1] float32 -> the fold's first ``chunk_elems``
    elements cast to ``out_dtype`` (``quant.acc_layout``: [nb, BLOCK] by
    default, else [chunk_elems])."""
    n, nb, chunk_elems, shape = acc_layout(q.shape, chunk_elems, out_dtype)
    acc = torch.zeros((nb, BLOCK), dtype=torch.float32, device=q.device)
    for i in range(n):
        acc = acc + q[i].float() * s[i]
    return acc.reshape(-1)[:chunk_elems].reshape(shape).to(out_dtype)


def int8_dequant_requant_plain(q: torch.Tensor, s: torch.Tensor):
    """The int8 TP all-reduce's fold requantized: the fp32
    ``int8_dequant_acc_plain`` of q [n, nb, BLOCK], s [n, nb, 1] through
    ``int8_quantize_blocks_plain`` -> (q int8 [nb, BLOCK], s float32
    [nb, 1])."""
    return int8_quantize_blocks_plain(int8_dequant_acc_plain(q, s))


def matmul_chunk_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: x [M, K], w [K, N] -> [M, N] in their (common) dtype.
    The function of the JAX package's per-chunk matmul
    (``collective_matmul._chunk_mm`` with impl="jnp")."""
    return x @ w


def ag_matmul_plain(x: torch.Tensor, w_chunks: torch.Tensor) -> torch.Tensor:
    """Oracle of the all-gather -> matmul ring: the per-chunk products in
    rank order along the last dim. x: [M, K]; w_chunks: [n, K, Nc]
    (chunk j is rank j's shard)."""
    return torch.cat([x @ w_chunks[j] for j in range(w_chunks.shape[0])],
                     dim=-1)


def matmul_rs_plain(a_chunks: torch.Tensor, b_chunks: torch.Tensor,
                    rank: int) -> torch.Tensor:
    """Oracle of the matmul -> reduce-scatter ring, for one rank: chunk
    ``rank`` of sum_r(a_r @ b_r) added up in the ring's order (born on
    rank+1, then rank+2, ..., finally rank), left to right.
    a_chunks: [n, J, M]; b_chunks: [n, M, N] -> [J, N/n]."""
    n = a_chunks.shape[0]
    nc = b_chunks.shape[2] // n
    acc = None
    for h in range(n):
        src = (rank + 1 + h) % n
        part = a_chunks[src] @ b_chunks[src][:, rank * nc:(rank + 1) * nc]
        acc = part if acc is None else acc + part
    return acc


def fused_bwd_dx_plain(g: torch.Tensor, w_chunks: torch.Tensor,
                       rank: int) -> torch.Tensor:
    """Oracle of mode 'both''s dx on one rank: the per-chunk terms
    g[:, owner cols] @ w_owner.T added in ring order (owner = (rank + s)
    % n at step s). g: [M, N]; w_chunks: [n, K, Nc] -> [M, K]."""
    n, _, nc = w_chunks.shape
    dx = None
    for s in range(n):
        owner = (rank + s) % n
        part = g[:, owner * nc:(owner + 1) * nc] @ w_chunks[owner].T
        dx = part if dx is None else dx + part
    return dx


def wkv6_chunk_len(S: int, chunk: int = 64) -> int:
    """The chunk length of the chunked WKV over S steps: min(chunk, S),
    which must divide S (the JAX package's ``_wkv_chunked`` asserts the
    same)."""
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"wkv seq {S} not divisible by chunk {c}")
    return c


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None, chunk: int = 64):
    """RWKV-6 WKV with per-step, per-channel decay, chunked: the JAX
    package's ``models/sublayers._wkv_chunked`` in torch.

    r, k, v: [B,S,H,hd]; logw: [B,S,H,hd] (log decay, <= 0); u: [H,hd];
    s0: [B,H,hd,hd] fp32 carried state (None = zeros). Returns (out
    [B,S,H,hd] in r's dtype, final state [B,H,hd,hd] fp32, ``bhkv``).
    Recurrence: S = diag(w_t) S + k_t v_t^T; o_t = r_t (S_prev + u k_t
    v_t^T). Per chunk of c steps, in fp32: the inter-chunk term from the
    carried state, the intra-chunk term with the decay ratio
    exp(cw_prev[t] - cw[i]) masked to i < t in the log domain (so strong
    decay cannot overflow into inf * 0), the u-bonus diagonal, and the
    state update.
    """
    B, S, H, hd = r.shape
    c = wkv6_chunk_len(S, chunk)
    n = S // c

    def split(x):                      # [B,S,H,hd] -> [n,B,c,H,hd] fp32
        return x.float().reshape(B, n, c, H, hd).transpose(0, 1)
    rs, ks, vs, lws = split(r), split(k), split(v), split(logw)
    uf = u.float()
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device), -1)
    state = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    outs = []
    for rc, kc, vc, lwc in zip(rs, ks, vs, lws):        # [B,c,H,hd] each
        cw = torch.cumsum(lwc, dim=1)                  # log prod_{j<=t} w_j
        cw_prev = cw - lwc                             # log prod_{j<t} w_j
        o_inter = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cw_prev),
                               state)
        ratio_log = cw_prev[:, :, None] - cw[:, None, :]      # [B,t,i,H,hd]
        ratio_log = torch.where(tri[None, :, :, None, None], ratio_log,
                                torch.full((), NEG_INF, device=r.device))
        a = (rc[:, :, None] * kc[:, None, :] * torch.exp(ratio_log)).sum(-1)
        o_intra = torch.einsum("btih,bihv->bthv", a, vc)
        diag = (rc * (uf[None, None] * kc)).sum(-1)      # [B,c,H]
        outs.append(o_inter + o_intra + diag[..., None] * vc)
        cw_c = cw[:, -1]                               # [B,H,hd]
        kd = kc * torch.exp(cw_c[:, None] - cw)
        state = torch.exp(cw_c)[..., None] * state + torch.einsum(
            "bihk,bihv->bhkv", kd, vc)
    out = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return out.to(r.dtype), state


def mamba_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal SSM scan h_t = a_t h_{t-1} + b_t over [B,S,C] (C =
    d_inner x d_state flattened), walked step by step in fp32: the JAX
    package's ``kernels/ref.py:mamba_scan_ref`` (the oracle of its
    Pallas ``mamba_scan``) with the channels flattened.

    a, b: [B,S,C] fp32 or bf16 (or fp64, walked in fp64: the gradient
    checks); h0: [B,C] fp32 carried state (None = zeros, the Pallas
    kernel's function). Returns every state hs [B,S,C] fp32 (fp64 for
    fp64 inputs); hs[:, -1] is the state to carry."""
    B, S, C = a.shape
    wide = torch.promote_types(a.dtype, torch.float32)
    h = (torch.zeros(B, C, dtype=wide, device=a.device)
         if h0 is None else h0.to(wide))
    af, bf = a.to(wide), b.to(wide)
    hs = torch.empty(B, S, C, dtype=wide, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs
