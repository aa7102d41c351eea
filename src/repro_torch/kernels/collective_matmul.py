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

On the card bf16 operands are read in place, row-major or column-major
(``launch_plan``: the wgmma + TMA variant, with the transpose bits): the
stage-1 tensor in the forward ring and mode 'both''s transposed operands
(``chunk.T``, ``x2.T``) are not copied. Only an operand TMA cannot take
in a column-major layout (a leading dimension not a multiple of 8) is
copied to row-major, for the mma.sync variant; float32 operands too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("collective_matmul")
    ptr, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.matmul_chunk_bf16.argtypes = [ptr, ptr, ptr, i32, i32, i32, ll, ll,
                                      ll, i32, ptr]
    lib.matmul_chunk_bf16_tma.argtypes = [ptr, ptr, ptr, i32, i32, i32, ll,
                                          ll, ll, i32, i32, ptr]
    lib.matmul_chunk_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ll, ll,
                                     ll, ptr]
    for fn in (lib.matmul_chunk_bf16, lib.matmul_chunk_bf16_tma,
               lib.matmul_chunk_f32):
        fn.restype = i32
    return lib


def _layout(name: str, t: torch.Tensor, device) -> Tuple[bool, int]:
    """(column-major?, leading dimension) of a 2-D CUDA matrix whose rows
    or columns are contiguous; rows win where both are (a single row or
    column). A column slice of a row-major matrix, or a row slice of a
    column-major one, qualifies."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on a CUDA device"
                         f"{'' if device is None else f' ({device})'}, is on "
                         f"{t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} must be bfloat16 or float32, is {t.dtype}")
    if t.dim() != 2 or 0 in t.shape:
        raise ValueError(f"{name} must be a non-empty matrix, is "
                         f"{tuple(t.shape)}")
    (r, c), (s0, s1) = t.shape, t.stride()
    if s1 == 1 and (s0 >= c or r == 1):
        return False, max(s0, c) if r == 1 else s0
    if s0 == 1 and (s1 >= r or c == 1):
        return True, max(s1, r) if c == 1 else s1
    raise ValueError(f"{name} must have contiguous rows or columns, has "
                     f"strides {t.stride()}")


class Launch(NamedTuple):
    """How ``matmul_chunk`` runs a product: ``variant`` "tma" (wgmma +
    TMA, operands in place), "mma" (mma.sync, operands row-major) or
    "f32"; ``x_mn`` / ``w_mn`` the wgmma transpose bits (x column-major /
    w row-major); ``lda`` / ``ldb`` the leading dimensions; ``copy_x`` /
    ``copy_w``: the operand is column-major and its kernel reads rows, so
    it is copied to row-major first."""
    variant: str
    x_mn: bool
    lda: int
    w_mn: bool
    ldb: int
    copy_x: bool
    copy_w: bool


def _tma_ok(t: torch.Tensor, mn_major: bool, ld: int) -> bool:
    # TMA: a row pitch of a multiple of 16 bytes; a K-major base 16-byte
    # aligned (an MN-major map starts at the base rounded down)
    return ld % 8 == 0 and (mn_major or t.data_ptr() % 16 == 0)


def launch_plan(x: torch.Tensor, w: torch.Tensor) -> Launch:
    """The variant and operand layout for ``x @ w`` on the card.

    bf16 takes the wgmma + TMA variant when TMA reads both operands in
    place: each row- or column-major with a leading dimension of a
    multiple of 8 elements, and a K-major one (x row-major, w
    column-major) 16-byte aligned. An MN-major operand (x column-major, w
    row-major) may start at any element, so a column chunk of a weight
    takes the variant its full matrix takes. Anything else takes the
    mma.sync variant, which reads rows; float32 takes the CUDA-core
    kernel, which reads rows too. Both bf16 variants give the same bits
    (held on the card by chip_smoke.py)."""
    x_cols, lda = _layout("x", x, None)
    w_cols, ldb = _layout("w", w, x.device)
    if w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype: {x.dtype} vs "
                         f"{w.dtype}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "chain")
    x_mn, w_mn = x_cols, not w_cols
    if x.dtype == torch.bfloat16 and _tma_ok(x, x_mn, lda) \
            and _tma_ok(w, w_mn, ldb):
        return Launch("tma", x_mn, lda, w_mn, ldb, False, False)
    variant = "mma" if x.dtype == torch.bfloat16 else "f32"
    return Launch(variant, False, x.shape[1] if x_cols else lda, True,
                  w.shape[1] if w_cols else ldb, x_cols, w_cols)


def _new_output(m: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((m, n), dtype=like.dtype, device=like.device)


def matmul_chunk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` through the CUDA kernel: x [M, K], w [K, N], both
    bfloat16 or both float32 on one card, each with contiguous rows or
    columns (``launch_plan`` picks the variant). Returns a new contiguous
    [M, N] of their dtype (fp32 accumulation; float32 on the CUDA cores,
    never TF32)."""
    plan = launch_plan(x, w)
    lib = _lib()
    (m, k), n = x.shape, w.shape[1]
    out = _new_output(m, n, x)
    if plan.variant == "tma":
        err = _build.launch(x.device, lib.matmul_chunk_bf16_tma, x.data_ptr(),
                      w.data_ptr(), out.data_ptr(), m, n, k, plan.lda,
                      plan.ldb, n, int(plan.x_mn), int(plan.w_mn))
    else:
        if plan.copy_x:
            x = x.contiguous()
        if plan.copy_w:
            w = w.contiguous()
        if plan.variant == "mma":
            vec = (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
                   and plan.lda % 8 == 0 and plan.ldb % 8 == 0
                   and k % 8 == 0 and n % 8 == 0)
            err = _build.launch(x.device, lib.matmul_chunk_bf16, x.data_ptr(),
                          w.data_ptr(), out.data_ptr(), m, n, k, plan.lda,
                          plan.ldb, n, int(vec))
        else:
            err = _build.launch(x.device, lib.matmul_chunk_f32, x.data_ptr(),
                          w.data_ptr(), out.data_ptr(), m, n, k, plan.lda,
                          plan.ldb, n)
    if err != 0:
        raise RuntimeError(f"matmul_chunk ({plan.variant}) launch failed: "
                           f"CUDA error {err}")
    return out


def _chunk_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One per-chunk matmul on x of any rank ([..., K] @ [K, Nc]),
    through the counting dispatcher. On the card the kernel reads each
    operand in its layout (the stage-1 chunk, ``chunk.T`` and ``x2.T``
    in place); on the CPU a column-major x is made contiguous first, so
    the plain version's bits do not depend on it."""
    from repro_torch.kernels import ops
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type != "cuda" and x2.stride(-1) != 1:
        x2 = x2.contiguous()
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
    ring and ``ring_matmul_rs``. With ``reads`` False (the caller never
    reads the product: a recompute's dead output) the forward runs no
    ring and returns zeros; the backward is the same."""

    @staticmethod
    def forward(ctx, x, w_shard, coll, axis, mode, sync_axes, reads=True):
        if mode not in ("ag_matmul", "both"):
            raise ValueError(f"unknown fused mode {mode!r}")
        if mode == "both" and sync_axes:
            raise ValueError("mode 'both' cannot sum its ring-scattered dw "
                             f"over replicated axes {sync_axes}")
        ctx.coll, ctx.axis, ctx.mode, ctx.sync_axes = coll, axis, mode, \
            sync_axes
        ctx.save_for_backward(x, w_shard)
        if not reads:
            return w_shard.new_zeros(x.shape[:-1] + (coll.size(axis)
                                                     * w_shard.shape[1],))
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
            None, None, None, None


def chunk_schedule(m_tokens: int, k: int, n_cols_local: int, n_ranks: int,
                   dtype_bytes: float = 2.0) -> List[Tuple[float, float]]:
    """The ring's per-step (transfer_bytes, matmul_flops): step s
    multiplies one [m, k] x [k, n_local] chunk while the next chunk's hop
    is in flight; the last step has no hop."""
    chunk_bytes = float(k) * n_cols_local * dtype_bytes
    chunk_flops = 2.0 * m_tokens * k * n_cols_local
    return [(chunk_bytes if s < n_ranks - 1 else 0.0, chunk_flops)
            for s in range(n_ranks)]
