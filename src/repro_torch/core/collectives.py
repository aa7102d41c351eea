"""Collectives per mesh axis, with a byte count per (op, axis).

The operations the train step needs, each over named mesh axes and
tiled like the JAX package's collectives inside ``shard_map``:

  all_gather(x, axis, dim)      blocks of every rank concatenated on dim
  all_gather_async(x, axis, dim)
                                the same, returning at once a handle
                                whose ``wait()`` gives the result (the
                                stage-1 prefetch ring, ``core/schedule.py``)
  reduce_scatter(x, axis, dim)  sum over ranks, this rank's block of dim
  reduce_scatter_async(x, axis, dim)
                                the same, returning at once a handle
                                (the async 'pod' gradient reduce,
                                ``core/engine/train.py``)
  all_to_all(x, axis)           block j of dim 0 goes to rank j
  all_to_all_async(x, axis)     the same, returning at once a handle
  all_reduce(x, axes)           sum over ranks
  all_reduce_max(x, axes)       max over ranks (not counted, as the JAX
                                package's count leaves pmax out)
  ppermute(x, axis, perm)       x goes from axis index src to dst for
                                each (src, dst) of perm; returns a handle
                                whose ``wait()`` gives what arrived, so the
                                caller computes while the hop is in flight

``counts`` adds up the bytes each call moves per device, keyed
``"<op>/<axis>"`` with the JAX package's op names (all_gather,
psum_scatter, all_to_all, psum, ppermute), under the convention of its
``launch/roofline.py:collect_collectives``: the payload is the output
bytes of an all-gather and the input bytes of the others; on an axis of
size n it moves (n-1)/n of the payload (2(n-1)/n for psum, all of it
for a ppermute hop); on the
'pod' axis of a call that also spans intra axes, the payload is first
divided by the intra axes' product (a hierarchical collective reduces
inside the pod before it crosses). So these counts compare one for one
with the JAX package's.

Backend, from the topology (``pick_backend``): NCCL when every rank has
a card of its own, that is when no host runs more ranks than it has
cards; gloo otherwise. NCCL refuses two ranks on one card,
so ranks that share a card (or run on the CPU) talk through gloo, and
this wrapper stages a CUDA tensor through host memory explicitly: copy
to pinned host memory, run the collective there, copy the result back.
That is the wire of this topology, not a fallback: the compute and every
kernel stay on the card. On gloo the all-gather and the reduce-scatter go
through gloo's all-to-all (``all_to_all_single``), which moves the same
(n-1)/n of the payload as a ring: gloo's own all-gather is a slower
algorithm over host memory, and its reduce-scatter all-reduces the whole
input. The reduce-scatter then sums the n blocks that arrived in group
rank order, in their dtype, so every rank and device adds alike.

``NoWire`` is the same accounting with no wire at all: one rank of a
mesh that needs no process group, whose every op goes through ``_count``
and hands back a tensor of the shape the real op gives (the dry run,
``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def pick_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when each of the ``local_world`` ranks on this host can
    own a card of it (``launch.mesh.device_for_rank`` gives local rank i
    card i), else ``gloo``. The ranks of other hosts do not count: a job
    over two 8-card hosts, one rank per card, has 8 local ranks."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _as_axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Collectives:
    """Collectives of one rank over a ``launch.mesh.RankMesh``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.gloo = mesh.backend == "gloo"
        self.counts = defaultdict(float)

    # -- accounting --------------------------------------------------------
    def _count(self, op: str, axes: Tuple[str, ...], payload: float) -> None:
        size = self.mesh.mesh_shape.size
        ici = [a for a in axes if a != "pod"]
        ici_n = math.prod(size(a) for a in ici) or 1
        for a in axes:
            n = size(a)
            if n <= 1:
                continue
            factor = {"psum": 2 * (n - 1) / n,
                      "ppermute": 1.0}.get(op, (n - 1) / n)
            self.counts[f"{op}/{a}"] += factor * payload / (
                ici_n if a == "pod" else 1)

    def snapshot(self) -> dict:
        return dict(self.counts)

    def size(self, axis: str) -> int:
        return self.mesh.mesh_shape.size(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.coords[axis]

    def _live(self, axes: Tuple[str, ...]) -> bool:
        return math.prod(self.mesh.mesh_shape.size(a) for a in axes) > 1

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        if not self.gloo or t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    # -- operations ----------------------------------------------------------
    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        return self.all_gather_async(x, axis, dim).wait()

    def all_gather_async(self, x: torch.Tensor, axis: str,
                         dim: int) -> "Pending":
        """``all_gather`` issued as async work: returns at once, counted
        at issue. On gloo the work runs on the group's threads over host
        buffers that the handle keeps alive until ``wait()``; on NCCL it
        runs on the group's own stream, and ``wait()`` makes the
        consumer's stream wait on its end event."""
        axes = _as_axes(axis)
        if not self._live(axes):
            return Pending(None, (x, x), x.device, None)
        n = math.prod(self.mesh.mesh_shape.size(a) for a in axes)
        src = self._wire(x.movedim(dim, 0).contiguous())
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device,
                          pin_memory=src.is_pinned())
        group = self.mesh.group(axes)
        if self.gloo:           # every rank is sent a copy of this block
            src = src.repeat((n,) + (1,) * (src.dim() - 1))
            work = dist.all_to_all_single(out, src, group=group,
                                          async_op=True)
        else:
            work = dist.all_gather_into_tensor(out, src, group=group,
                                               async_op=True)
        self._count("all_gather", axes, out.numel() * out.element_size())
        return Pending(work, (src, out), x.device, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        return self.reduce_scatter_async(x, axis, dim).wait()

    def reduce_scatter_async(self, x: torch.Tensor, axis: str,
                             dim: int) -> "Pending":
        """``reduce_scatter`` issued as async work, as
        ``all_gather_async``: counted at issue, the input's wire copy
        kept alive by the handle."""
        axes = _as_axes(axis)
        if not self._live(axes):
            return Pending(None, (x, x), x.device, None)
        n = math.prod(self.mesh.mesh_shape.size(a) for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        src = self._wire(x.movedim(dim, 0).contiguous())
        group = self.mesh.group(axes)
        self._count("psum_scatter", axes, src.numel() * src.element_size())
        if self.gloo:           # block j to rank j; wait() sums what came
            out = torch.empty_like(src, pin_memory=src.is_pinned())
            work = dist.all_to_all_single(out, src, group=group,
                                          async_op=True)
            return Pending(work, (src, out), x.device, dim, blocks=n)
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        work = dist.reduce_scatter_tensor(out, src, group=group,
                                          async_op=True)
        return Pending(work, (src, out), x.device, dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self.all_to_all_async(x, axis).wait()

    def all_to_all_async(self, x: torch.Tensor, axis: str) -> "Pending":
        """``all_to_all`` issued as async work, as ``all_gather_async``."""
        axes = _as_axes(axis)
        if not self._live(axes):
            return Pending(None, (x, x), x.device, None)
        src = self._wire(x.contiguous())
        out = torch.empty_like(src, pin_memory=src.is_pinned())
        work = dist.all_to_all_single(out, src, group=self.mesh.group(axes),
                                      async_op=True)
        self._count("all_to_all", axes, src.numel() * src.element_size())
        return Pending(work, (src, out), x.device, 0)

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = _as_axes(axes)
        if not self._live(axes):
            return x
        buf = self._wire(x.contiguous())
        buf = buf.clone() if buf is x else buf
        dist.all_reduce(buf, group=self.mesh.group(axes))
        self._count("psum", axes, buf.numel() * buf.element_size())
        return buf.to(x.device)

    def all_reduce_max(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise max over ranks. Not counted: the JAX package's
        ``collect_collectives`` has no pmax, and its one use (the cross
        entropy's stability shift) is a [B, S] vector."""
        axes = _as_axes(axes)
        if not self._live(axes):
            return x
        buf = self._wire(x.contiguous())
        buf = buf.clone() if buf is x else buf
        dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                        group=self.mesh.group(axes))
        return buf.to(x.device)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> "Hop":
        """One hop over ``axis``: for each (src, dst) of ``perm`` (axis
        indices of a permutation with no fixed point, such as a ring),
        src's ``x`` goes to dst. Returns at once; ``wait()`` on the handle
        gives the tensor this rank received."""
        me = self.index(axis)
        group = self.mesh.group((axis,))
        src = self._wire(x.contiguous())
        buf = torch.empty_like(src, pin_memory=src.is_pinned())
        ops = []
        for a, b in perm:
            if a == me:
                ops.append(dist.P2POp(dist.isend, src,
                                      dist.get_global_rank(group, b), group))
            if b == me:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(group, a), group))
        works = dist.batch_isend_irecv(ops)
        self._count("ppermute", (axis,), src.numel() * src.element_size())
        return Hop(works, (src, buf), x.device)


class NoWireMesh:
    """The mesh of rank 0 with no process group: ``mesh_shape``, rank
    0's ``coords``, no backend (every rank's step moves the same bytes)."""

    def __init__(self, mesh_shape):
        self.mesh_shape, self.rank = mesh_shape, 0
        self.coords = mesh_shape.coords(0)
        self.backend = "none"

    def group(self, axes):
        raise RuntimeError("a no-wire mesh has no process groups")


class NoWire(Collectives):
    """The collectives of one rank with no wire: each op counts its bytes
    through ``_count`` as ``Collectives`` does and returns at once a
    tensor of the real op's shape and dtype on the input's device (an
    all-gather: the input repeated; a reduce-scatter: this rank's block
    of the input; the others: a copy), so a step runs, and is counted,
    without its peers. Besides ``counts`` it keeps ``calls``, the calls
    per (op, axis), and ``hbm_bytes``, the operand and result bytes of
    every counted call (the reference's HBM model counts collectives)."""

    def __init__(self, mesh_shape):
        super().__init__(NoWireMesh(mesh_shape))
        self.calls = defaultdict(int)
        self.hbm_bytes = 0.0

    def _count(self, op, axes, payload):
        super()._count(op, axes, payload)
        for a in axes:
            if self.size(a) > 1:
                self.calls[f"{op}/{a}"] += 1

    def _issue(self, op, axes, x, out, payload=None):
        """Count one call (``payload``: its payload bytes, x's by
        default) and hand back ``out``."""
        nbytes = x.numel() * x.element_size()
        self._count(op, axes, nbytes if payload is None else payload)
        self.hbm_bytes += float(nbytes + out.numel() * out.element_size())
        return out

    def all_gather_async(self, x, axis, dim):
        axes = _as_axes(axis)
        if not self._live(axes):
            return _done(x)
        out = torch.cat([x] * math.prod(self.size(a) for a in axes), dim)
        return _done(self._issue("all_gather", axes, x, out,
                                 out.numel() * out.element_size()))

    def reduce_scatter_async(self, x, axis, dim):
        axes = _as_axes(axis)
        if not self._live(axes):
            return _done(x)
        n = math.prod(self.size(a) for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        out = x.narrow(dim, 0, x.shape[dim] // n).clone()
        return _done(self._issue("psum_scatter", axes, x, out))

    def all_to_all_async(self, x, axis):
        axes = _as_axes(axis)
        if not self._live(axes):
            return _done(x)
        return _done(self._issue("all_to_all", axes, x, x.clone()))

    def all_reduce(self, x, axes):
        axes = _as_axes(axes)
        if not self._live(axes):
            return x
        return self._issue("psum", axes, x, x.clone())

    def all_reduce_max(self, x, axes):
        return x.clone() if self._live(_as_axes(axes)) else x

    def ppermute(self, x, axis, perm):
        out = self._issue("ppermute", (axis,), x, x.clone())
        return Hop([], (out, out), out.device)


def _done(t: torch.Tensor) -> "Pending":
    """A collective that finished when it was issued, with result t."""
    return Pending(None, (t, t), t.device, None)


class Hop:
    """A ppermute in flight: ``wait()`` blocks until this rank's send
    and receive are done and returns the received tensor on the
    caller's device."""

    def __init__(self, works, bufs, device):
        self.works, self.bufs, self.device = works, bufs, device

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        self.works = []
        return self.bufs[1].to(self.device)


class Pending:
    """A collective in flight (an all-gather, reduce-scatter or
    all-to-all): ``wait()`` blocks until it is done and returns the
    result on the caller's device (``dim``: where the blocks go; None
    for a collective over no live axis, which hands its input back;
    ``blocks``: the number of blocks that arrived to be summed, for a
    reduce-scatter sent as an all-to-all)."""

    def __init__(self, work, bufs, device, dim, blocks=None):
        self.work, self.bufs, self.device, self.dim = work, bufs, device, dim
        self.blocks = blocks

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        out = self.bufs[1]
        if self.blocks is not None:
            parts = out.unflatten(0, (self.blocks, -1))
            acc = torch.empty_like(parts[0], pin_memory=out.is_pinned())
            acc.copy_(parts[0])
            for part in parts[1:]:
                acc += part
            self.bufs, self.blocks = (self.bufs[0], acc), None
            out = acc
        if self.dim is None:
            return out
        return out.to(self.device).movedim(0, self.dim)
