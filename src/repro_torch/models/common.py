"""Tensor parallelism over the mesh's 'model' axis: the context the
model code carries (the JAX package's ``MeshInfo``), the Megatron pair
and its relatives as ``torch.autograd.Function``s, and head / vocab
padding, as the JAX package's ``models/common.py`` defines them.

The JAX step types every value by the mesh axes it varies over, and
where a value that is the same on every 'model' rank (invariant) meets
one that differs (varying), it inserts a cast whose backward is a sum
over 'model'. PyTorch has no such types, so the port puts that cast by
hand where the JAX step's typing puts it:

  psum_tp(x)       forward all-reduce over 'model', backward identity
                   (the transpose of a psum is the cast)
  psum_tp_act(x)   psum_tp of a sublayer's output; with act_psum "int8"
                   the all-reduce carries int8 blocks
                   (``core/act_compress.int8_psum``)
  pvary_tp(x)      the cast itself: forward identity, backward
                   all-reduce over 'model'
  region_vary(x)   pvary_tp of a value of a column-parallel region that
                   meets a 'model'-sharded weight; inside an int8
                   region the identity (its values already vary)
  tp_region_in(x)  the entry of a column-parallel region: with act_psum
                   "int8" the cast whose backward all-reduce carries
                   int8 (``int8_bwd_psum``), so every value inside the
                   region varies; with "bf16" the identity, and each
                   consumer casts where it needs to (``region_vary``)
  pmax_tp(x)       forward max over 'model', no gradient (the
                   cross-entropy's stability shift)
  all_to_all_tp(x) the MoE's expert-parallel exchange (its backward the
                   same exchange of the gradient)
  psum_scatter_tp(x, dim)
                   sum over 'model' scattered on dim (backward: an
                   all-gather)
  all_gather_invariant_tp(x, dim)
                   the gather of a value that is then the same on every
                   rank (backward: this rank's block, no collective)

Under a recomputing activation policy the collective that ends each
sublayer (``psum_tp_act``, ``psum_tp_out``, ``all_gather_invariant_tp``)
goes through its context's ``CollectiveTape``: the recompute in the
backward runs it again (block_io, offload_acts) or takes the forward's
output from the tape (save_collectives), and never runs the layer's
last one, whose output the backward does not read; nor, where it does
not read a collective's input, the gather-fused ring of the output
projection that feeds it.

A parameter that is replicated over 'model' and used inside the varying
region has its gradient summed over 'model' too: ``ParamGather`` adds
'model' to that leaf's sum over its replicated axes, so the sum is one
all-reduce, as the JAX step's one cast of the weight over all its
missing axes is (``models/sublayers.model_summed``).

At tp 1 every function here is the identity and issues no collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

ACT_PSUM = ("bf16", "int8")


@dataclass(frozen=True)
class TPContext:
    """What the model code needs to know of tensor parallelism: the
    degree ``tp``, this rank's coordinate ``rank`` on 'model', the
    transport of the activation all-reduces (``act_psum``), the
    rank's collectives (``coll``: ``core.collectives.Collectives``; None
    at tp 1) and, inside a recomputed layer, its ``CollectiveTape``."""
    tp: int = 1
    rank: int = 0
    act_psum: str = "bf16"
    coll: Optional[object] = None
    tape: Optional["CollectiveTape"] = None

    def __post_init__(self):
        if self.act_psum not in ACT_PSUM:
            raise ValueError(f"unknown act_psum {self.act_psum!r}; known: "
                             f"{', '.join(ACT_PSUM)}")
        if self.tp > 1 and self.coll is None:
            raise ValueError("tensor parallelism needs the rank's "
                             "collectives")

    @classmethod
    def of(cls, coll, act_psum: str = "bf16") -> "TPContext":
        """The context of the rank behind ``coll`` (its mesh's 'model'
        size and this rank's coordinate on it)."""
        tp = coll.size("model")
        return cls(tp, coll.index("model") if tp > 1 else 0, act_psum,
                   coll if tp > 1 else None)

    @property
    def int8_act(self) -> bool:
        return self.act_psum == "int8" and self.tp > 1


SERIAL = TPContext()


class _PsumTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        return coll.all_reduce(x, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PvaryTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_reduce(g, ("model",)), None


def psum_tp(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """Sum over 'model' (forward all-reduce, backward identity)."""
    return _PsumTP.apply(x, tpc.coll) if tpc.tp > 1 else x


class CollectiveTape:
    """One layer's sublayer-output collectives under a recomputing
    activation policy (``models/stack.py``), carried by the layer's
    ``TPContext``: one a sublayer, the collective that ends it
    (``psum_tp_act`` after attention's, the MLP's and Mamba's output
    projections, the time-mix's ``psum_tp``, the MoE's and the
    channel-mix's invariant all-gather; at tp 1 the identity). The
    layer's forward counts them and, with ``keep`` (save_collectives)
    at tp > 1, records their outputs; its recompute (``replay``) runs
    them again, or takes the recorded outputs in order, except the
    last: its output is read only by the layer's output (the residual
    sum), which the backward never reads, so the recompute hands on a
    stand-in with the collective's backward in its place (the same
    gradient). ``reads(i)`` says whether the recompute reads collective
    i's input; where it does not, the output projection before it runs
    no gather-fused ring (``core.fcdp.FusedParam.reads``), as XLA's
    remat drops a value no backward reads."""

    def __init__(self, keep: bool):
        self.keep = keep
        self.calls = 0
        self.outs: List[torch.Tensor] = []
        self.next: Optional[int] = None      # the recompute's position
        # with keep, the outputs of the collectives inside the sublayers
        # (``kept``), taken in order by the recompute
        self.inner: List[torch.Tensor] = []
        self.inner_next = 0

    def recorded(self) -> None:
        """The forward is done: drop the last output, never read."""
        if self.outs:
            self.outs.pop()

    def replay(self) -> "CollectiveTape":
        self.next = self.inner_next = 0
        return self

    def reads(self, i: int) -> bool:
        """Whether the recompute reads the input of collective i: not
        for a recorded one nor for the layer's last."""
        return len(self.outs) <= i < self.calls - 1


class _Replayed(torch.autograd.Function):
    """A recorded or skipped collective's output standing in for the
    collective of ``x``: the value ``out``, the collective's backward
    ``bwd`` (the identity for an all-reduce)."""

    @staticmethod
    def forward(ctx, x, out, bwd):
        ctx.bwd = bwd
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def taped(x: torch.Tensor, tpc: "TPContext", op, bwd=None,
          shape=None) -> torch.Tensor:
    """``op(x)``, the collective that ends a sublayer, through
    ``tpc.tape``: counted and recorded in a recomputed layer's forward,
    run again, replayed or skipped in its recompute (``CollectiveTape``).
    ``bwd`` is the collective's backward on the output's gradient (None:
    the identity, an all-reduce's), ``shape`` its output shape (None:
    x's), for the stand-ins."""
    tape = tpc.tape
    if tape is not None and tape.next is not None:      # the recompute
        i = tape.next
        tape.next += 1
        if tpc.tp == 1:
            return op(x)
        if i < len(tape.outs):
            return _Replayed.apply(x, tape.outs[i], bwd or _identity)
        if not tape.reads(i):
            if bwd is None:
                return x
            return _Replayed.apply(x, x.new_zeros(shape), bwd)
        return op(x)
    out = op(x)
    if tape is not None:
        tape.calls += 1
        if tape.keep and tpc.tp > 1:
            tape.outs.append(out.detach())
    return out


def _identity(g):
    return g


def kept(x: torch.Tensor, tpc: "TPContext", op, bwd=None) -> torch.Tensor:
    """``op(x)``, a collective inside a sublayer (the MoE's
    ``all_to_all``s, Mamba's sum of its x_proj partial): under
    save_collectives (``tpc.tape.keep``) a recomputed layer's forward
    records its output and the recompute takes it from the record, with
    the collective's backward ``bwd`` (None: the identity, an
    all-reduce's), as the JAX policy saves psum and all_to_all outputs;
    under the other policies it runs again."""
    tape = tpc.tape
    if tape is None or not tape.keep or tpc.tp == 1:
        return op(x)
    if tape.next is None:                               # the forward
        out = op(x)
        tape.inner.append(out.detach())
        return out
    out = tape.inner[tape.inner_next]
    tape.inner_next += 1
    return _Replayed.apply(x, out, bwd or _identity)


def _allreduce_act(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    if tpc.tp == 1:
        return x
    if tpc.int8_act:
        from repro_torch.core.act_compress import int8_psum
        return int8_psum(x, tpc.coll, "model")
    return psum_tp(x, tpc)


def psum_tp_act(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """``psum_tp`` of a sublayer's output, carried in int8 blocks under
    act_psum "int8"; counted, recorded or replayed by ``tpc.tape``."""
    return taped(x, tpc, lambda t: _allreduce_act(t, tpc))


def psum_tp_out(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """``psum_tp`` of a sublayer's output that stays exact under act_psum
    "int8" (the time-mix's, as in the JAX package), through
    ``tpc.tape``."""
    return taped(x, tpc, lambda t: psum_tp(t, tpc))


class _GatherInvariant(torch.autograd.Function):
    """The JAX package's ``all_gather_invariant`` over 'model': every
    rank's block concatenated on ``dim``; the output is the same on every
    rank, so the backward takes this rank's block of the gradient and
    moves nothing."""

    @staticmethod
    def forward(ctx, x, coll, dim):
        ctx.dim, ctx.n, ctx.rank = dim, x.shape[dim], coll.index("model")
        return coll.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.n, ctx.rank), None, None


def _block(g, dim, n, rank):
    return g.narrow(dim, rank * n, n).contiguous()


def all_gather_invariant_tp(x: torch.Tensor, tpc: TPContext,
                            dim: int) -> torch.Tensor:
    """The invariant all-gather over 'model' that ends a sublayer (the
    MoE's tokens, the channel-mix's columns), through ``tpc.tape``."""
    if tpc.tp == 1:
        return taped(x, tpc, lambda t: t)
    n, rank = x.shape[dim], tpc.rank
    shape = list(x.shape)
    shape[dim] *= tpc.tp
    return taped(x, tpc,
                 lambda t: _GatherInvariant.apply(t, tpc.coll, dim),
                 lambda g: _block(g, dim, n, rank), tuple(shape))


class _AllToAllTP(torch.autograd.Function):
    """``all_to_all`` over 'model': block j of dim 0 goes to rank j, and
    block i of the result came from rank i; its transpose is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return coll.all_to_all(x, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_to_all(g, "model"), None


def all_to_all_tp(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """The JAX package's tiled ``all_to_all`` over 'model' with split
    and concat axis 0 (``x``'s dim 0 holds tp blocks), ``kept`` under
    save_collectives; the identity at tp 1."""
    if tpc.tp == 1:
        return x
    return kept(x, tpc, lambda t: _AllToAllTP.apply(t, tpc.coll),
                lambda g: tpc.coll.all_to_all(g, "model"))


class _PsumScatterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, dim):
        ctx.coll, ctx.dim = coll, dim
        return coll.reduce_scatter(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_gather(g, "model", ctx.dim), None, None


def psum_scatter_tp(x: torch.Tensor, tpc: TPContext,
                    dim: int) -> torch.Tensor:
    """Sum over 'model' scattered on ``dim`` (this rank's block); the
    backward all-gathers the gradient. The identity at tp 1."""
    return _PsumScatterTP.apply(x, tpc.coll, dim) if tpc.tp > 1 else x


def pvary_tp(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """An invariant value entering varying compute: identity forward,
    the backward sums the gradient over 'model'."""
    return _PvaryTP.apply(x, tpc.coll) if tpc.tp > 1 else x


def region_vary(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """A value of a column-parallel region meeting a 'model'-sharded
    weight (or the head slice of k/v): ``pvary_tp`` where the region's
    input is the same on every rank, the identity inside an int8 region,
    whose input already varies (``tp_region_in``)."""
    return x if tpc.int8_act else pvary_tp(x, tpc)


def tp_region_in(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """The entry of a column-parallel region (a sublayer's normed
    input): under act_psum "int8" the backward's all-reduce of this
    tensor's gradient carries int8 blocks (``int8_bwd_psum``) and every
    value of the region varies over 'model'; otherwise the identity."""
    if tpc.int8_act:
        from repro_torch.core.act_compress import int8_bwd_psum
        return int8_bwd_psum(x, tpc.coll, "model")
    return x


def pmax_tp(x: torch.Tensor, tpc: TPContext) -> torch.Tensor:
    """Max over 'model' of a value carrying no gradient. Like the JAX
    package's ``collect_collectives``, the byte count leaves it out."""
    if tpc.tp == 1:
        return x
    return tpc.coll.all_reduce_max(x.detach(), ("model",))


def pad_heads(n_heads: int, tp: int) -> int:
    """Heads padded to a multiple of ``tp``."""
    return -(-n_heads // tp) * tp


def pad_vocab(v: int, tp: int) -> int:
    """Vocabulary padded to a multiple of ``tp``."""
    return -(-v // tp) * tp


def local_head_mask(tpc: TPContext, padded_heads: int, real_heads: int,
                    device=None) -> torch.Tensor:
    """[local heads] bool: False for the padding heads, which sit on the
    last 'model' ranks."""
    local = padded_heads // tpc.tp
    idx = tpc.rank * local + torch.arange(local, device=device)
    return idx < real_heads
