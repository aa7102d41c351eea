"""Build the hand-written CUDA kernels at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, which the wrappers load with
``ctypes``. Libraries land in ``kernels/build/`` (listed in
``.gitignore``), named by a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. ``build``
starts one ``nvcc`` per missing library, all together, and prints each
build's time to stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "build"
SOURCES = {"flash_attention": KERNEL_DIR / "csrc" / "flash_attention.cu",
           "quant": KERNEL_DIR / "csrc" / "quant.cu",
           "collective_matmul": KERNEL_DIR / "csrc" / "collective_matmul.cu",
           "wkv6": KERNEL_DIR / "csrc" / "wkv6.cu",
           "mamba_scan": KERNEL_DIR / "csrc" / "mamba_scan.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a digest of its source,
    of every header beside it (``*.cuh``, which a source may include) and
    of the flags: an edit to any of them names a new library."""
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named (default: every) kernel library that is not
    built yet, one nvcc process each, all started together. Returns the
    wall seconds per library built; raises with nvcc's output on a
    failed build. nvcc's own report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    times, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        print(f"# built {out.name} in {times[n]:.2f}s", file=sys.stderr)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return times


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it on first use)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def launch(device, fn, *args) -> int:
    """``fn(*args, stream)``: a kernel's C entry point called with
    ``device``'s current stream (switching the current device only when
    it is another). Returns the entry point's CUDA error code."""
    import torch
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
