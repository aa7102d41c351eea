"""Roofline terms of one rank's train step, from the dry run's trace
(``launch/dryrun.py``), with the JAX package's functions and report keys
(its ``launch/roofline.py``):

  compute    = FLOPs per chip / PEAK_FLOPS
  memory     = HBM bytes per chip / HBM_BW
  collective = intra-node bytes per chip / ICI_BW
               + inter-node ('pod') bytes per chip / DCN_BW

The reference walks a jaxpr; the port takes its numbers from a step run
on fake tensors. The collective bytes per (op, axis) are
``core/collectives.Collectives.counts``, kept under the reference's
convention (``collect_collectives``: (n-1)/n of the payload, 2(n-1)/n
for psum, a whole ppermute hop; a 'pod' stage moves the payload over
the intra axes' product), so ``CollectiveStats`` is built from that
snapshot. FLOPs come from ``torch.utils.flop_counter``'s formulas, the
ones ``FlopCounterMode`` applies (matmuls and convolutions, as
``flops_bytes_from_jaxpr`` counts dot_general and conv). HBM bytes are ``major_bytes`` of each op: the
operand and result bytes of the ops of the reference's
``MAJOR_BYTES_PRIMS`` list (matmuls, convolutions, gathers, scatters,
index ops, sort, cumsum), plus the collectives' (``NoWire.hbm_bytes``);
elementwise chains count as fused into their producers, as there.

Constants: one NVIDIA H100 SXM5 (80 GB), its data-sheet figures at the
700 W limit, not measured: bf16 dense tensor-core peak 989e12 FLOP/s,
fp32 (CUDA cores) 67e12, HBM3 3.35e12 B/s, NVLink 4 450e9 B/s in one
direction. The inter-node rate, 25e9 B/s a GPU (about one 200 Gb/s NIC
each), is the reference's own assumption, kept fixed across systems so
that comparisons are fair: the ``dcn_s`` terms of the two packages
compare.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch
from torch.utils._pytree import tree_flatten

# one H100 SXM5, data-sheet figures (see the module note)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12      # fp32, CUDA cores
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s, NVLink 4, one direction
DCN_BW = 25e9                # bytes/s per GPU across nodes (the reference's
                             # assumption, fixed across systems)

# the aten ops whose operands stream from HBM: the reference's
# MAJOR_BYTES_PRIMS (dot_general, conv_general_dilated, gather, scatter,
# scatter_add, dynamic_update_slice, dynamic_slice, sort, take, cumsum,
# cumlogsumexp) as eager PyTorch spells them
MAJOR_BYTES_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "convolution", "convolution_backward",
    "gather", "index_select", "index", "take", "embedding",
    "embedding_dense_backward",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_add",
    "index_copy", "slice_scatter", "select_scatter",
    "sort", "topk", "cumsum", "logcumsumexp",
})


@dataclass
class CollectiveStats:
    """Per-device byte totals by axis kind and op."""
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    by_axis: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    by_op_axis: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    count: int = 0

    def add(self, op: str, axis: str, nbytes: float, is_dcn: bool,
            calls: int = 1):
        if is_dcn:
            self.dcn_bytes += nbytes
        else:
            self.ici_bytes += nbytes
        self.by_op[op] += nbytes
        self.by_axis[axis] += nbytes
        self.by_op_axis[f"{op}/{axis}"] += nbytes
        self.count += calls

    @classmethod
    def from_counts(cls, counts: Mapping[str, float],
                    calls: Optional[Mapping[str, int]] = None
                    ) -> "CollectiveStats":
        """The stats of a ``Collectives.counts`` snapshot (bytes keyed
        ``"<op>/<axis>"``), the calls per key from ``calls`` (one a key
        without it); 'pod' is the inter-node axis."""
        stats = cls()
        for key, nbytes in sorted(counts.items()):
            op, axis = key.split("/")
            stats.add(op, axis, nbytes, is_dcn=(axis == "pod"),
                      calls=(calls or {}).get(key, 1))
        return stats


def major_bytes(func, args, kwargs, out) -> float:
    """The operand and result bytes of one dispatched op when it is one
    of ``MAJOR_BYTES_OPS``, else 0."""
    if func.overloadpacket.__name__ not in MAJOR_BYTES_OPS:
        return 0.0
    leaves = tree_flatten((args, kwargs, out))[0]
    return float(sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor)))


def model_flops(cfg, cell, n_chips: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) tokens rule; decode counts one
    token per sequence."""
    from repro_torch.models.registry import count_params
    n_active = count_params(cfg, active_only=True)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    tokens = cell.global_batch  # one new token per sequence
    return 2.0 * n_active * tokens


def fused_overlap_credit(def_leaves, plan_leaves, mesh_sizes: Dict[str, int],
                         cell, tp: int = 1,
                         dtype_bytes: float = 2.0) -> Dict[str, Any]:
    """Per-layer overlap credit of the gather-fused collective matmul,
    from the ring's own chunk schedule
    (``kernels/collective_matmul.chunk_schedule``): per ring pass the sum
    over its transfer steps of min(chunk bytes / ICI_BW, chunk FLOPs /
    PEAK_FLOPS), times the leaf's layers; 'ag_matmul' runs one ring a
    layer, 'both' three (forward, dx and dw)."""
    from repro_torch.kernels.collective_matmul import chunk_schedule
    tokens = (cell.global_batch * cell.seq_len if cell.kind != "decode"
              else cell.global_batch)
    dp = math.prod(s for a, s in mesh_sizes.items() if a != "model") or 1
    m_tokens = tokens / dp
    credit = 0.0
    n_leaves = 0
    modes = set()
    for d, p in zip(def_leaves, plan_leaves):
        if getattr(p, "fused", "none") == "none":
            continue
        n = mesh_sizes.get(p.intra_axes[0], 1)
        if n <= 1:
            continue
        body = [(dim, s) for dim, s in zip(d.dims, d.shape) if dim != "stack"]
        stack = (d.shape[d.dims.index("stack")]
                 if "stack" in d.dims else 1)
        k_local = body[0][1] // (tp if body[0][0] == "tp" else 1)
        n_cols_chunk = body[1][1] // n
        passes = 3 if p.fused == "both" else 1
        sched = chunk_schedule(m_tokens, k_local, n_cols_chunk, n,
                               dtype_bytes)
        per_ring = sum(min(b / ICI_BW, f / PEAK_FLOPS)
                       for b, f in sched if b > 0.0)
        credit += passes * stack * per_ring
        n_leaves += 1
        modes.add(p.fused)
    return {"enabled": n_leaves > 0,
            "mode": (sorted(modes)[0] if len(modes) == 1
                     else ",".join(sorted(modes)) if modes else "none"),
            "n_fused_leaves": n_leaves,
            "credit_s": credit}


def roofline_report(flops_per_chip: float, bytes_per_chip: float,
                    stats: CollectiveStats, cfg, cell,
                    n_chips: int, prefetch: Any = False,
                    inflight_bytes: float = 0.0,
                    group_bytes: Optional[Dict[str, Any]] = None,
                    cross_step: bool = False,
                    cross_step_bytes: float = 0.0,
                    fused: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The three roofline terms and the reference's echoes, under its
    bandwidth model: with the prefetch ring live (``prefetch``, the
    resolved depth) the stage-1 ('pod') all-gathers hide under compute
    up to the compute term, whatever the depth (``inflight_bytes``, the
    ring's device bytes, is the price shown beside the credit); the
    fused matmul's credit (``fused``, ``fused_overlap_credit``'s dict)
    is taken off the exposed collective time, up to the intra-node
    term; ``collective_exposed_s`` is what is left. ``group_bytes`` (the
    per-group split of ``core.cache.cache_bytes_per_chip``) is echoed as
    ``groups``, the cross-step carry's bytes under ``cross_step``: the
    carried epilogue moves the same bytes a step."""
    depth = int(prefetch)
    compute_t = flops_per_chip / PEAK_FLOPS
    memory_t = bytes_per_chip / HBM_BW
    ici_t = stats.ici_bytes / ICI_BW
    dcn_t = stats.dcn_bytes / DCN_BW
    coll_t = ici_t + dcn_t
    # stage-1 parameter gathers: the overlappable inter-node term
    stage1_ag_bytes = stats.by_op_axis.get("all_gather/pod", 0.0)
    overlapped_bytes = stage1_ag_bytes if depth > 0 else 0.0
    overlapped_t = min(overlapped_bytes / DCN_BW, compute_t)
    fused = dict(fused or {})
    fused_credit_t = min(float(fused.get("credit_s", 0.0)), ici_t)
    fused["credit_applied_s"] = fused_credit_t
    coll_exposed_t = max(coll_t - overlapped_t - fused_credit_t, 0.0)
    terms = {"compute": compute_t, "memory": memory_t,
             "collective": coll_exposed_t}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, cell, n_chips)
    flops_total = flops_per_chip * n_chips
    return {
        "groups": dict(group_bytes or {}),
        "cross_step": {
            "enabled": bool(cross_step),
            "carry_buffer_bytes_per_chip": float(cross_step_bytes),
        },
        "fused": fused,
        "prefetch": {
            "enabled": depth > 0,
            "depth": depth,
            "inflight_stage1_bytes_per_chip": float(inflight_bytes),
            "stage1_ag_dcn_bytes_per_chip": stage1_ag_bytes,
            "overlapped_dcn_bytes_per_chip": overlapped_bytes,
            "overlapped_s": overlapped_t,
            "collective_exposed_s": coll_exposed_t,
        },
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "ici_s": ici_t,
        "dcn_s": dcn_t,
        "dominant": dominant,
        "step_time_lb_s": max(terms.values()),
        "model_flops": mf,
        "hlo_flops_total": flops_total,
        "useful_flops_ratio": (mf / flops_total) if flops_total else 0.0,
        "roofline_fraction": (mf / n_chips / PEAK_FLOPS) / max(
            max(terms.values()), 1e-30),
        "ici_bytes_per_chip": stats.ici_bytes,
        "dcn_bytes_per_chip": stats.dcn_bytes,
        "coll_by_op": dict(stats.by_op),
        "coll_by_axis": dict(stats.by_axis),
        "n_collectives": stats.count,
    }
