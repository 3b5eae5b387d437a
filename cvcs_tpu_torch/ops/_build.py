"""Build the package's CUDA sources (``cvcs_tpu_torch/csrc/*.cu``) into
shared libraries with a plain C interface, and load them with ctypes.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root, at first
use; the hash covers the source, every header under ``csrc/``
(``*.cuh``, which a source may include) and the flags, so an edited
source or header builds anew and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together. ptxas's register and shared-memory report for each build
is kept beside the library as ``.log``.

Nothing here runs when the package is imported: the CPU tests import
every module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names) -> dict[str, float]:
    """Compile every named source that has no current library, one nvcc
    each, all started together. Returns {name: seconds} for the builds
    that ran; raises with nvcc's output if any fails."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    seconds, errors = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)   # atomic: a concurrent loader never sees half
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
