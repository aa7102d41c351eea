"""Elastic scaling, as the JAX package's ``runtime/elastic.py`` does it:
the mesh of the surviving ranks, and a carry-aware restore of the
training state under it.

The flow on a rank loss:
  1. the launcher detects missing ranks (heartbeat / init timeout),
  2. ``remesh`` gives the largest valid mesh over what is left
     (2x16x16 -> 16x16: drop the 'pod' axis; fewer ranks -> shrink
     'data'), laid over the first ``world`` survivors,
  3. a new StepBundle is built on the new mesh, and the last checkpoint
     is restored under its blocks (the global batch is kept).

Checkpoints store global arrays (see checkpoint/), so a restore under
another mesh cuts other blocks out of the same arrays -- for everything
EXCEPT the cross-step carry (the scheduler's stream 3): its leaves carry
a leading partial dim over mesh axes, pre-reduction partials, not global
state. ``reshard_state`` therefore restores the carry only when the
saved mesh signature and the new bundle's carry layout both match; on
any mesh change the carry is dropped (a section-filtered restore) and
the caller resumes one step earlier, so that the restart driver
re-primes the pipeline: re-running the last step rebuilds the carry, and
no update is lost.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.launch.mesh import MeshShape


def surviving_mesh_shape(n_devices: int, tp: int = 16
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) / (data, model) mesh covering
    <= n_devices with the given TP degree."""
    tp = min(tp, n_devices)
    per_pod = 256
    if n_devices >= 2 * per_pod:
        pods = n_devices // per_pod
        return (pods, per_pod // tp, tp), ("pod", "data", "model")
    data = max(n_devices // tp, 1)
    return (data, tp), ("data", "model")


def remesh(n_ranks: int, tp: int = 16) -> MeshShape:
    """The best mesh over ``n_ranks`` surviving ranks. It covers exactly
    the first ``world`` of them (ranks 0 .. world - 1), not every
    survivor: when the surviving shape needs fewer ranks than remain
    (300 survivors at tp 16 -> an 18 x 16 mesh of 288), the rest stay
    out of the mesh."""
    shape, axes = surviving_mesh_shape(n_ranks, tp)
    return MeshShape(axes, shape)


def _mesh_signature(mesh) -> dict:
    ms = getattr(mesh, "mesh_shape", mesh)
    return {"shape": [int(n) for n in ms.axis_sizes],
            "axes": list(ms.axis_names)}


def mesh_meta(mesh) -> dict:
    """Manifest ``meta`` entry recording the mesh (a ``MeshShape``, a
    ``RankMesh`` or a train bundle) a checkpoint was taken on -- what
    ``reshard_state`` compares to detect a mesh change (a cross-step
    carry never survives one)."""
    return {"mesh": _mesh_signature(mesh)}


def _carry_compatible(ckpt_manifest: dict, bundle) -> bool:
    """Whether the saved carry section can be restored bit-exactly under
    ``bundle``: the cross-step pipeline must be live, the saved mesh
    signature (when recorded) must equal the new bundle's, and the saved
    carry shapes/dtypes must match the new carry layout exactly."""
    if not bundle.cross_step:
        return False
    saved_mesh = ckpt_manifest.get("meta", {}).get("mesh")
    if saved_mesh is not None and saved_mesh != _mesh_signature(bundle):
        return False
    from repro_torch.core.engine.train import cross_step_carry_signature
    saved = [(tuple(l["shape"]), l["dtype"])
             for l in ckpt_manifest.get("leaves", [])
             if l.get("section") == "carry"]
    return saved == cross_step_carry_signature(bundle)


def carry_example(bundle):
    """Meta tensors of this rank's carry (shapes and dtypes only): the
    example tree a carry section restores into."""
    return {k: [torch.empty(shape, dtype=dtype, device="meta")
                for shape, dtype in v]
            for k, v in bundle.cross_step_carry_layout().items()}


def reshard_state(ckpt, step: int, bundle, example_tree: Any
                  ) -> Tuple[Any, bool]:
    """Restore a checkpoint under a (possibly different) bundle's mesh,
    carry-aware.

    bundle: the new train StepBundle on this rank's live mesh;
    example_tree: ``{"params": [...], "opt": {...}}`` matching the saved
    params/opt sections (this rank's tensors, or meta tensors: only the
    structure is read; the carry example, when one is restorable, comes
    from the bundle).

    Returns ``(state, carry_invalidated)``: this rank's blocks on the
    bundle's device. ``state["carry"]`` is present exactly when the
    checkpoint held a carry AND it is restorable under this bundle (same
    mesh signature, same carry layout). ``carry_invalidated`` is True
    when a saved carry had to be dropped (mesh change, or
    ``cross_step_pipeline`` off at restore) -- the caller must then
    resume at ``saved_step - 1`` so that the driver re-primes the
    pipeline by re-running the last step, instead of losing its
    update.
    """
    manifest = ckpt.manifest(step)
    has_carry = any(l.get("section") == "carry"
                    for l in manifest.get("leaves", []))
    if not has_carry:
        return ckpt.restore(step, example_tree, shardings=bundle), False
    if _carry_compatible(manifest, bundle):
        example = dict(example_tree)
        example["carry"] = carry_example(bundle)
        return ckpt.restore(step, example, shardings=bundle), False
    # a mesh-shaped carry under another mesh (or the pipeline off at
    # restore): drop it -- stale partials would feed the next finalize
    # sums from a mesh that no longer exists
    sections = tuple(sorted(example_tree))
    state = ckpt.restore(step, example_tree, shardings=bundle,
                         sections=sections)
    return state, True
