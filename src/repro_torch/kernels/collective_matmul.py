"""Gather-fused collective matmul: consume the stage-2 shards as they
arrive (the JAX package's ``kernels/collective_matmul.py``).

For an output-dim-sharded weight (w: [K, N] sharded along N over one
intra axis of n ranks) the product splits into disjoint column blocks::

    x @ w_full = concat_j(x @ w_chunk_j)     # K is never split

so each rank multiplies its resident chunk at once and passes the chunks
round a ring (``ppermute``), the next chunk's hop in flight while the
current chunk's matmul runs. The ring moves the bytes the tiled
all-gather would ((n-1)/n of the gathered weight), so the swap is
byte-neutral.

  ring_ag_matmul   all-gather -> matmul ring (the forward)
  ring_matmul_rs   matmul -> reduce-scatter ring (mode 'both''s dw)
  FusedMatmul      the differentiable ring, modes 'ag_matmul' and 'both'

The per-chunk matmul ``matmul_chunk`` is the hand-written CUDA kernel of
``csrc/collective_matmul.cu`` (replaces the Pallas ``_matmul_kernel``):
one output tile per program, the contraction whole, its k-steps in a
fixed order, so ``kernel(x, w_full)[:, j*Nc:(j+1)*Nc]`` equals
``kernel(x, w_chunk_j)`` bit for bit. ``kernels/ops.py`` dispatches it by
device: a CPU tensor takes ``ref.matmul_chunk_plain`` (``x @ w``).

Bit identity with the unfused step. The unfused output projection stays
``x @ w_full``, outside any kernel, as in the JAX package: cuBLAS on the
card, which may take another algorithm for ``x @ w_full`` than for ``x @
w_chunk``. So on the card mode 'ag_matmul' equals the unfused step within
the train tests' tolerances, not bit for bit; what holds bit for bit
there is the ring's own contract, the column identity of the kernel. On
the CPU, where the plain chunk matmul is the same PyTorch matmul as the
unfused one, the fused step equals the unfused step bit for bit (losses
and parameters over several steps, at the tests' widths). Mode
'ag_matmul''s backward replays the unfused op sequence (stage-2 gather,
the two products in the layouts autograd's mm backward picks, the sum
over replicated axes, the reduce-scatter); mode 'both' ring-fuses the
backward too (dx ring and ``ring_matmul_rs``, each chunk through the
kernel), which reorders the dx sum: exact against ``kernels/ref.py``'s
ring oracles, close to the unfused gradients.

The kernel reads both operands by rows (row strides are arguments, so a
column slice of a row-major matrix is read in place). A column-major
operand is copied to row-major before it on the card: the stage-1
tensor (the tiled all-gather's layout) in the forward ring, and mode
'both''s transposed operands (``chunk.T``, ``x2.T``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("collective_matmul")
    ptr, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.matmul_chunk_bf16.argtypes = [ptr, ptr, ptr, i32, i32, i32, ll, ll,
                                      ll, i32, ptr]
    lib.matmul_chunk_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ll, ll,
                                     ll, ptr]
    lib.matmul_chunk_bf16.restype = lib.matmul_chunk_f32.restype = i32
    return lib


def _check_rows(name: str, t: torch.Tensor, device) -> None:
    """A 2-D CUDA matrix whose rows are contiguous (a row stride of at
    least its width: a column slice of a row-major matrix qualifies)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on a CUDA device"
                         f"{'' if device is None else f' ({device})'}, is on "
                         f"{t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} must be bfloat16 or float32, is {t.dtype}")
    if t.dim() != 2 or 0 in t.shape:
        raise ValueError(f"{name} must be a non-empty matrix, is "
                         f"{tuple(t.shape)}")
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must have contiguous rows, has strides "
                         f"{t.stride()}")


def matmul_chunk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` through the CUDA kernel: x [M, K], w [K, N], both
    bfloat16 or both float32 on one card, rows contiguous. Returns a new
    contiguous [M, N] of their dtype (fp32 accumulation; float32 on the
    CUDA cores, never TF32)."""
    _check_rows("x", x, None)
    _check_rows("w", w, x.device)
    if w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype: {x.dtype} vs "
                         f"{w.dtype}")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "chain")
    lib = _lib()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            vec = (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
                   and x.stride(0) % 8 == 0 and w.stride(0) % 8 == 0
                   and k % 8 == 0 and n % 8 == 0)
            err = lib.matmul_chunk_bf16(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, n, k, x.stride(0),
                                        w.stride(0), n, int(vec), stream)
        else:
            err = lib.matmul_chunk_f32(x.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), m, n, k, x.stride(0),
                                       w.stride(0), n, stream)
    if err != 0:
        raise RuntimeError(f"matmul_chunk launch failed: CUDA error {err}")
    return out


def _chunk_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One per-chunk matmul on x of any rank ([..., K] @ [K, Nc]),
    through the counting dispatcher. The kernel reads its operands by
    rows, so on the card a column-major chunk (the stage-1 tensor, as
    the tiled all-gather lays it out, or a transposed one) is copied to
    row-major first; the plain version takes any layout."""
    from repro_torch.kernels import ops
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    if w.stride(-1) != 1 and w.device.type == "cuda":
        w = w.contiguous()
    return ops.matmul_chunk(x2, w).reshape(x.shape[:-1] + (w.shape[1],))


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """(src, dst) pairs of one forward hop: rank j+1 sends to j, so after
    s hops rank i holds chunk (i + s) % n."""
    return [((j + 1) % n, j) for j in range(n)]


def ring_ag_matmul(x: torch.Tensor, w_shard: torch.Tensor, coll,
                   axis: str) -> torch.Tensor:
    """``x @ all_gather(w_shard, axis, dim 1)`` as a ring. x: [..., K]
    this rank's activations; w_shard: [K, N/n] this rank's column chunk
    (global column order = rank order along ``axis``). Each step starts
    the next chunk's hop before the current chunk's matmul; the results
    land in disjoint column slices of the output."""
    n = coll.size(axis)
    if n == 1:
        return _chunk_mm(x, w_shard)
    idx = coll.index(axis)
    nc = w_shard.shape[1]
    out = torch.empty(x.shape[:-1] + (n * nc,), dtype=w_shard.dtype,
                      device=x.device)
    perm = ring_perm(n)
    chunk = w_shard
    for s in range(n):
        hop = coll.ppermute(chunk, axis, perm) if s < n - 1 else None
        owner = (idx + s) % n
        out[..., owner * nc:(owner + 1) * nc] = _chunk_mm(x, chunk)
        if hop is not None:
            chunk = hop.wait()
    return out


def ring_matmul_rs(a: torch.Tensor, b: torch.Tensor, coll,
                   axis: str) -> torch.Tensor:
    """This rank's column chunk of ``sum_ranks(a @ b)`` as a ring (the
    fused ``reduce_scatter(a @ b, axis, dim 1)``). a: [J, M], b: [M, N]
    -> [J, N/n]. Chunk j's partial is born on rank j+1 and grows hop by
    hop (j sends to j+1) until it reaches rank j; the next hop is in
    flight while the receiver multiplies its own part."""
    n = coll.size(axis)
    if b.shape[1] % n:
        raise ValueError(f"{tuple(b.shape)} does not split over {n} ranks")
    if n == 1:
        return _chunk_mm(a, b)
    idx = coll.index(axis)
    nc = b.shape[1] // n
    perm = [(j, (j + 1) % n) for j in range(n)]

    def cols(h):
        c = (idx + n - 1 - h) % n
        return b[:, c * nc:(c + 1) * nc]
    buf = _chunk_mm(a, cols(0))
    for h in range(1, n):
        hop = coll.ppermute(buf, axis, perm)
        part = _chunk_mm(a, cols(h))
        buf = hop.wait() + part
    return buf


def _ring_dx(g2: torch.Tensor, w_shard: torch.Tensor, coll,
             axis: str) -> torch.Tensor:
    """Mode 'both''s dx: g2 [M, N] times the gathered weight's transpose,
    chunk by chunk as the forward ring delivers them, summed in ring
    order (owner (idx + s) % n at step s) from zeros."""
    n, idx = coll.size(axis), coll.index(axis)
    nc = w_shard.shape[1]
    dx = torch.zeros((g2.shape[0], w_shard.shape[0]), dtype=w_shard.dtype,
                     device=g2.device)
    perm = ring_perm(n)
    chunk = w_shard
    for s in range(n):
        hop = coll.ppermute(chunk, axis, perm) if s < n - 1 else None
        owner = (idx + s) % n
        dx = dx + _chunk_mm(g2[:, owner * nc:(owner + 1) * nc], chunk.t())
        if hop is not None:
            chunk = hop.wait()
    return dx


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def mm_grads(x2: torch.Tensor, w: torch.Tensor, g2: torch.Tensor):
    """(dx2, dw) of ``x2.mm(w)`` for the output gradient g2, formed as
    autograd's mm backward forms them (a column-major operand gets its
    gradient as the transpose of the transposed product), so the replay
    gives the unfused step's bits."""
    dx2 = w.mm(g2.t()).t() if _col_major(x2) else g2.mm(w.t())
    dw = g2.t().mm(x2).t() if _col_major(w) else x2.t().mm(g2)
    return dx2, dw


class FusedMatmul(torch.autograd.Function):
    """``x @ all_gather(w_shard, axis, dim 1)`` with the forward as a
    ring. Backward, mode 'ag_matmul': the unfused sequence replayed (the
    stage-2 gather of w, the mm backward, the sum over ``sync_axes`` on
    the full dw, the reduce-scatter over ``axis``); mode 'both': the dx
    ring and ``ring_matmul_rs``."""

    @staticmethod
    def forward(ctx, x, w_shard, coll, axis, mode, sync_axes):
        if mode not in ("ag_matmul", "both"):
            raise ValueError(f"unknown fused mode {mode!r}")
        if mode == "both" and sync_axes:
            raise ValueError("mode 'both' cannot sum its ring-scattered dw "
                             f"over replicated axes {sync_axes}")
        ctx.coll, ctx.axis, ctx.mode, ctx.sync_axes = coll, axis, mode, \
            sync_axes
        ctx.save_for_backward(x, w_shard)
        return ring_ag_matmul(x, w_shard, coll, axis)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        coll, axis = ctx.coll, ctx.axis
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.mode == "ag_matmul":
            dx2, dw_full = mm_grads(x2, coll.all_gather(w, axis, 1), g2)
            if ctx.sync_axes:
                dw_full = coll.all_reduce(dw_full, ctx.sync_axes)
            dw = coll.reduce_scatter(dw_full, axis, 1)
        else:
            g2 = g2.contiguous()
            dx2 = _ring_dx(g2, w, coll, axis)
            dw = ring_matmul_rs(x2.t(), g2, coll, axis)
        return dx2.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None, \
            None, None, None


def chunk_schedule(m_tokens: int, k: int, n_cols_local: int, n_ranks: int,
                   dtype_bytes: float = 2.0) -> List[Tuple[float, float]]:
    """The ring's per-step (transfer_bytes, matmul_flops): step s
    multiplies one [m, k] x [k, n_local] chunk while the next chunk's hop
    is in flight; the last step has no hop."""
    chunk_bytes = float(k) * n_cols_local * dtype_bytes
    chunk_flops = 2.0 * m_tokens * k * n_cols_local
    return [(chunk_bytes if s < n_ranks - 1 else 0.0, chunk_flops)
            for s in range(n_ranks)]
