"""Sharded checkpointing with elastic restore and a versioned manifest,
in the JAX package's on-disk format (``checkpoint/checkpointer.py``
there), so a checkpoint written by either package restores in the other.

A checkpoint is a directory ``step_{step:08d}``, published by renaming
``.tmp_step_{step:08d}`` once complete, that holds one
``leaf_{i:05d}.npy`` per leaf with the GLOBAL array (bf16 and fp8 stored
as their raw bits, ``_BITCAST``) and a ``manifest.json`` (schema v2:
step, treedef, per-leaf key paths / top-level sections / global shapes
and dtypes, and a caller-supplied ``meta`` dict). Leaves are flattened
as ``jax.tree_util`` flattens dicts (keys sorted), lists and tuples, and
their paths and the treedef are printed as JAX prints them.

Each rank holds only its blocks of the state. ``save`` and ``restore``
take one ``Block`` per leaf (a global shape, this rank's index into it
and whether this rank writes it: one replica of each block does); a
train ``StepBundle`` gives them for the persisted state
(``StepBundle.state_blocks``). Without blocks a leaf is a whole array
written by rank 0. Rank 0 creates every file with its header; each rank
writes its own blocks through a memory map and leaves a completion file
in the temporary directory, and rank 0 publishes once every rank's file
is there. The only collective is ``barrier`` (given by the caller when
there are several ranks), called on the caller's thread at the start of
a save, never on the writer thread. A restore slices a read-only memory
map, so no rank ever holds more than its blocks.

Restore is validating, never silently wrong: the saved treedef, leaf
count, per-leaf paths and global shapes are checked against the example
tree, and a :class:`CheckpointError` with a readable diff is raised on
any mismatch. Callers that intend a partial restore select top-level
``sections`` explicitly -- how ``runtime/elastic.py`` drops a
mesh-shaped carry.

Async mode snapshots this rank's blocks to host memory, then writes on a
background thread so the training loop is not blocked.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# numpy cannot store bf16 / fp8: the raw bits go to disk and the manifest
# records the logical dtype
_BITCAST = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e5m2": np.uint8}
_TORCH_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}

MANIFEST_VERSION = 2
# how long a rank waits for the other ranks' part of a save
TIMEOUT_S = 900.0


class CheckpointError(ValueError):
    """A checkpoint/restore structure mismatch (never silently truncate,
    reorder, or mis-assign leaves)."""


# ---------------------------------------------------------------------------
# Trees: flatten as jax.tree_util does, print as it prints
# ---------------------------------------------------------------------------

def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], str]:
    """((key path, leaf) pairs, treedef string) of a tree of dicts (keys
    sorted), lists, tuples and None; a key path is a tuple of dict keys
    and sequence indices."""
    leaves: List[Tuple[tuple, Any]] = []

    def walk(x, path) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            body = ", ".join(f"{k!r}: {walk(x[k], path + (k,))}"
                             for k in sorted(x))
            return "{" + body + "}"
        if isinstance(x, (list, tuple)):
            parts = [walk(v, path + (i,)) for i, v in enumerate(x)]
            if isinstance(x, list):
                return "[" + ", ".join(parts) + "]"
            return "(" + ", ".join(parts) + ("," if len(parts) == 1
                                             else "") + ")"
        leaves.append((path, x))
        return "*"

    return leaves, f"PyTreeDef({walk(tree, ())})"


def unflatten_like(tree, leaves: Sequence[Any]):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)
    return build(tree)


def _keystr(kp) -> str:
    return "".join(f"[{k!r}]" for k in kp)


def _section_of(kp) -> str:
    """Top-level key of one leaf's key path ('params', 'opt', 'carry',
    ...) -- what section-filtered restores select on."""
    return str(kp[0]) if kp else ""


def _path_diff(expected: Sequence[str], saved: Sequence[str]) -> str:
    """Readable diff between the example tree's leaf paths and the
    checkpoint's: what the error message shows instead of a silent
    truncation or mis-assignment."""
    exp_set, sav_set = set(expected), set(saved)
    lines: List[str] = []
    missing = [p for p in expected if p not in sav_set]
    unexpected = [p for p in saved if p not in exp_set]
    if missing:
        lines.append("  leaves expected by the example tree but absent "
                     "from the checkpoint:")
        lines += [f"    {p}" for p in missing[:8]]
        if len(missing) > 8:
            lines.append(f"    ... and {len(missing) - 8} more")
    if unexpected:
        lines.append("  leaves present in the checkpoint but not in the "
                     "example tree:")
        lines += [f"    {p}" for p in unexpected[:8]]
        if len(unexpected) > 8:
            lines.append(f"    ... and {len(unexpected) - 8} more")
    if not lines:  # same set, different order
        for i, (e, s) in enumerate(zip(expected, saved)):
            if e != s:
                lines.append(f"  first order mismatch at leaf {i}: "
                             f"example {e} vs checkpoint {s}")
                break
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Leaves and blocks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Block:
    """One rank's part of a leaf: the leaf's global ``shape``, the
    ``index`` (one slice per dimension) of this rank's block in it, and
    whether this rank ``write``s the block (one replica of a block
    does)."""
    shape: Tuple[int, ...]
    index: Tuple[slice, ...]
    write: bool = True

    @classmethod
    def whole(cls, shape, write: bool = True) -> "Block":
        shape = tuple(int(n) for n in shape)
        return cls(shape, tuple(slice(0, n) for n in shape), write)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index)

    @property
    def is_whole(self) -> bool:
        return self.local_shape == self.shape


def _dtype_name(leaf) -> str:
    """The logical dtype the manifest records: a Python int is saved as
    JAX saves an optimizer step, int32; a float as float32."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, bool):
        return "bool"
    if isinstance(leaf, int):
        return "int32"
    if isinstance(leaf, float):
        return "float32"
    return np.asarray(leaf).dtype.name


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in getattr(leaf, "shape", ()))


def _host_bits(leaf) -> np.ndarray:
    """A host copy of ``leaf`` in its storage type (bf16 / fp8 as raw
    bits): the snapshot the writer reads while the live leaf moves on."""
    name = _dtype_name(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if name in _BITCAST:
            bits = _BITCAST[name]
            return t.view(_TORCH_BITS[bits]).numpy().view(bits)
        return t.numpy()
    if isinstance(leaf, (bool, int, float)):
        arr = np.asarray(leaf, dtype=name)
    else:
        arr = np.array(leaf)
    return arr.view(_BITCAST[name]) if name in _BITCAST else arr


def _from_bits(arr: np.ndarray, name: str) -> torch.Tensor:
    """The tensor of a stored array whose logical dtype is ``name``."""
    arr = np.ascontiguousarray(arr)
    if name in _BITCAST:
        bits = _BITCAST[name]
        return torch.from_numpy(arr.view(bits).view(
            np.int16 if bits is np.uint16 else bits).copy()).view(
            getattr(torch, name))
    return torch.from_numpy(arr.copy())


class Checkpointer:
    """Checkpoints under ``directory``, keeping the ``keep`` newest.
    ``rank`` of ``world`` ranks (each saving its blocks of the same
    state); ``barrier`` (required when ``world`` > 1) synchronizes the
    ranks once per save, on the caller's thread. A rank waits at most
    ``TIMEOUT_S`` for the others' writes."""

    def __init__(self, directory: str, keep: int = 3, rank: int = 0,
                 world: int = 1, barrier: Optional[Callable[[], None]] = None):
        if world > 1 and barrier is None:
            raise ValueError("several ranks need a barrier")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.rank, self.world = rank, world
        self.barrier = barrier
        self._async_thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None
        self._stale: Optional[Tuple[int, int]] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             meta: Optional[Dict[str, Any]] = None,
             blocks: Optional[Any] = None) -> Path:
        """tree: a tree of tensors / arrays / scalars, each this rank's
        block of a leaf (``blocks``: one ``Block`` per leaf, tree-aligned
        or flat; default: every leaf whole). ``meta`` is a
        JSON-serializable dict recorded in the manifest (the restart
        driver stores the mesh signature). Every rank calls it with the
        same step and structure."""
        path_leaves, treedef = flatten_with_path(tree)
        blks = self._blocks(blocks, [leaf for _, leaf in path_leaves])
        # snapshot this rank's blocks first: the next step updates the
        # live tensors in place while an async write proceeds
        host = [_host_bits(leaf).reshape(b.local_shape) if b.write else None
                for (_, leaf), b in zip(path_leaves, blks)]
        leaf_meta = [{"path": _keystr(kp), "section": _section_of(kp),
                      "shape": list(b.shape), "dtype": _dtype_name(leaf)}
                     for (kp, leaf), b in zip(path_leaves, blks)]
        manifest = {"version": MANIFEST_VERSION, "step": step,
                    "treedef": treedef, "n_leaves": len(host),
                    "meta": dict(meta or {}), "leaves": leaf_meta}
        path = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        self.wait()
        # a published checkpoint of the same step is replaced: wait() must
        # not take the old manifest for the new one
        self._stale = _stamp(path)
        if self.rank == 0:
            # the files the other ranks write their blocks into
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (arr, b, lm) in enumerate(zip(host, blks, leaf_meta)):
                if not (b.is_whole and b.write):
                    np.lib.format.open_memmap(
                        tmp / f"leaf_{i:05d}.npy", mode="w+",
                        dtype=_storage_dtype(lm["dtype"], arr),
                        shape=b.shape).flush()
        if self.world > 1:
            self.barrier()

        def write():
            for i, (arr, b) in enumerate(zip(host, blks)):
                if arr is None:
                    continue
                f = tmp / f"leaf_{i:05d}.npy"
                if b.is_whole and self.rank == 0:
                    np.save(f, arr)
                else:
                    mm = np.load(f, mmap_mode="r+")
                    mm[b.index] = arr
                    mm.flush()
                    del mm
            done = tmp / f".done_{self.rank:05d}"
            done.with_suffix(".part").touch()
            done.with_suffix(".part").rename(done)
            if self.rank != 0:
                return
            marks = [tmp / f".done_{r:05d}" for r in range(self.world)]
            self._poll(lambda: all(m.exists() for m in marks),
                       f"the ranks' writes of step {step}")
            for m in marks:
                m.unlink()
            with open(tmp / "manifest.json", "w") as fh:
                json.dump(manifest, fh)
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)          # atomic publish
            self._gc()

        def guarded():
            try:
                write()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._pending = step
        if blocking:
            write()
            self.wait()
        else:
            self._async_thread = threading.Thread(target=guarded,
                                                  daemon=True)
            self._async_thread.start()
        return path

    def _poll(self, ready: Callable[[], bool], what: str) -> None:
        deadline = time.monotonic() + TIMEOUT_S
        while not ready():
            if time.monotonic() > deadline:
                raise CheckpointError(f"timed out after {TIMEOUT_S} s "
                                      f"waiting for {what}")
            time.sleep(0.01)

    def wait(self):
        """Drain the last save: this rank's writer thread, then (on every
        rank) the publication of its step, so every rank sees the same
        checkpoints afterwards."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._pending is not None:
            path = self.dir / f"step_{self._pending:08d}"
            # published, and the older steps rank 0 collects after the
            # publish gone: every rank then sees the same checkpoints
            self._poll(lambda: _stamp(path) not in (None, self._stale)
                       and len(self.all_steps()) <= self.keep,
                       f"step {self._pending} to be published")
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        """The saved manifest dict (v1 checkpoints lack 'version',
        'meta', and per-leaf 'path'/'section' entries)."""
        with open(self.dir / f"step_{step:08d}" / "manifest.json") as f:
            return json.load(f)

    def _blocks(self, blocks, leaves) -> List[Block]:
        if blocks is None:      # whole leaves, written by rank 0
            return [Block.whole(_shape_of(leaf), self.rank == 0)
                    for leaf in leaves]
        if not isinstance(blocks, (list, tuple)) or any(
                not isinstance(b, Block) for b in blocks):
            blocks = [b for _, b in flatten_with_path(blocks)[0]]
        if len(blocks) != len(leaves):
            raise CheckpointError(
                f"shardings tree has {len(blocks)} leaves for "
                f"{len(leaves)} data leaves -- a short shardings tree "
                "would silently leave trailing leaves unplaced; pass one "
                "Block per leaf (tree-aligned with the example tree)")
        return list(blocks)

    def _validate(self, manifest: Dict[str, Any], example_tree: Any,
                  sections: Optional[Tuple[str, ...]],
                  shapes: Optional[Sequence[Tuple[int, ...]]] = None
                  ) -> List[int]:
        """Check the manifest against the example tree (its global leaf
        ``shapes``, default the leaves' own); return the manifest leaf
        indices to load, in example-tree order."""
        version = manifest.get("version", 1)
        saved_leaves = manifest.get("leaves", [])
        n_saved = manifest.get("n_leaves", len(saved_leaves))
        if sections is not None:
            if version < 2:
                raise CheckpointError(
                    "section-filtered restore needs a manifest v2 "
                    f"checkpoint (saved version: {version})")
            idxs = [i for i, l in enumerate(saved_leaves)
                    if l.get("section") in sections]
        else:
            idxs = list(range(n_saved))
        ex_path_leaves, ex_treedef = flatten_with_path(example_tree)
        ex_paths = [_keystr(kp) for kp, _ in ex_path_leaves]
        if shapes is None:
            shapes = [getattr(leaf, "shape", None)
                      for _, leaf in ex_path_leaves]
        if version >= 2:
            saved_paths = [saved_leaves[i]["path"] for i in idxs]
            if saved_paths != ex_paths:
                scope = (f"sections {sections}" if sections is not None
                         else "the full tree")
                raise CheckpointError(
                    f"checkpoint structure does not match the example "
                    f"tree for {scope} ({len(saved_paths)} saved vs "
                    f"{len(ex_paths)} expected leaves):\n"
                    + _path_diff(ex_paths, saved_paths))
            if sections is None and manifest.get("treedef") not in (
                    None, ex_treedef):
                raise CheckpointError(
                    "checkpoint treedef does not match the example tree "
                    "(same leaf paths, different container structure):\n"
                    f"  saved:    {manifest['treedef']}\n"
                    f"  expected: {ex_treedef}")
            # global shapes are mesh-invariant, so this holds across
            # elastic restores; a mismatch means the leaf is mesh-shaped
            # (a cross-step carry partial)
            for p, want in zip(idxs, shapes):
                got = tuple(saved_leaves[p]["shape"])
                if want is not None and tuple(want) != got:
                    raise CheckpointError(
                        f"leaf {saved_leaves[p]['path']} shape mismatch: "
                        f"checkpoint {got} vs example {tuple(want)} "
                        "(mesh-shaped leaf restored under a different "
                        "mesh?)")
        else:
            if len(idxs) != len(ex_paths):
                raise CheckpointError(
                    f"checkpoint has {len(idxs)} leaves but the example "
                    f"tree has {len(ex_paths)} -- refusing to truncate "
                    "or pad a v1 restore")
            for i, want in zip(idxs, shapes):
                got = tuple(saved_leaves[i].get("shape", ())) \
                    if i < len(saved_leaves) else None
                if want is not None and got is not None \
                        and tuple(want) != got:
                    raise CheckpointError(
                        f"v1 checkpoint leaf {i} shape mismatch: "
                        f"checkpoint {got} vs example {tuple(want)}")
        return idxs

    def restore(self, step: int, example_tree: Any,
                shardings: Optional[Any] = None,
                sections: Optional[Tuple[str, ...]] = None,
                device=None) -> Any:
        """Restore into the structure of ``example_tree`` (its leaves are
        read for their shapes only: tensors, meta tensors or scalars).

        ``shardings`` is a train ``StepBundle`` (this rank's blocks of the
        persisted state, ``StepBundle.state_blocks``, on the bundle's
        device) or one ``Block`` per leaf (tree-aligned or flat); without
        it every leaf is read whole. ``sections`` selects top-level keys
        (e.g. ``("params", "opt")`` to drop a mesh-shaped carry); the
        example tree must then contain exactly those sections. Leaves
        come back as tensors of the saved dtype on ``device`` (None: the
        bundle's, else ``cuda``), shaped as the example's leaves; a
        Python int leaf of the example comes back as an int. Raises
        :class:`CheckpointError` on any structural mismatch."""
        from repro_torch import resolve_device
        path = self.dir / f"step_{step:08d}"
        manifest = self.manifest(step)
        ex_path_leaves, _ = flatten_with_path(example_tree)
        ex_leaves = [leaf for _, leaf in ex_path_leaves]
        if hasattr(shardings, "state_blocks"):
            device = shardings.device if device is None else device
            try:
                blocks = shardings.state_blocks(example_tree)
            except (KeyError, TypeError, ValueError) as e:
                raise CheckpointError(f"the bundle has no layout for this "
                                      f"example tree: {e}") from None
            blocks = self._blocks(blocks, ex_leaves)
        elif shardings is not None:
            blocks = self._blocks(shardings, ex_leaves)
        else:
            blocks = None
        device = resolve_device(device)
        shapes = None if blocks is None else [b.shape for b in blocks]
        idxs = self._validate(manifest, example_tree, sections, shapes)
        saved_leaves = manifest.get("leaves", [])
        out = []
        for k, (i, ex) in enumerate(zip(idxs, ex_leaves)):
            f = path / f"leaf_{i:05d}.npy"
            arr = np.load(f, mmap_mode="r") if saved_leaves[i].get(
                "shape") else np.load(f)
            if blocks is not None:
                arr = arr[blocks[k].index]
            name = saved_leaves[i]["dtype"]
            if isinstance(ex, int) and not isinstance(ex, bool):
                out.append(int(np.asarray(arr)))
                continue
            t = _from_bits(arr, name)
            want = getattr(ex, "shape", None)
            if want is not None and t.numel() == int(np.prod(want)):
                t = t.reshape(tuple(want))
            out.append(t.to(device))
            del arr
        return unflatten_like(example_tree, out)


def _storage_dtype(name: str, arr: Optional[np.ndarray]):
    """The numpy dtype a leaf of logical dtype ``name`` is stored as."""
    if name in _BITCAST:
        return _BITCAST[name]
    return arr.dtype if arr is not None else np.dtype(name)


def _stamp(path: Path) -> Optional[Tuple[int, int]]:
    """(inode, mtime) of a published checkpoint's manifest, or None."""
    try:
        st = (path / "manifest.json").stat()
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_mtime_ns
