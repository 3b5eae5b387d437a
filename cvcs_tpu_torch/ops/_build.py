"""Build the package's CUDA sources (``cvcs_tpu_torch/csrc/*.cu``) and its
host C++ sources (``cvcs_tpu_torch/native/*.cpp``) into shared libraries
with a plain C interface, and load them with ctypes.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root, at first
use; the hash covers the source, every header under ``csrc/``
(``*.cuh``, which a source may include) and the flags, so an edited
source or header builds anew and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together. ptxas's register and shared-memory report for each build
is kept beside the library as ``.log``.

A host source compiles with ``g++`` (``HOST_FLAGS``, linked against the
system's ``libz.so.1``) into ``build/native/lib<name>-<hash>.so``, the hash
over the source, every ``*.h`` beside it and the flags.

Every build holds an exclusive ``flock`` on ``<library>.lock`` while it
compiles and renames its output into place, and looks again for the
library once it holds the lock: processes that start together (the test
workers) compile each library once, and a loader never sees half a file.
A failed build raises with the compiler's output.

Nothing here runs when the package is imported: the CPU tests import
every module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]
HOST_LIBS = ["-l:libz.so.1"]    # the runtime library: no libz.so symlink

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


@contextlib.contextmanager
def _locked(lib: Path):
    """Hold the exclusive lock of ``lib``'s build (released on exit, or by
    the kernel when the process dies)."""
    with open(lib.with_suffix(".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield


def build(names) -> dict[str, float]:
    """Compile every named source that has no current library, one nvcc
    each, all started together. Returns {name: seconds} for the builds
    that ran; raises with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = sorted({n for n in names if not library_path(n).exists()})
    procs = {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as locks:
        for name in todo:               # in sorted order: no lock cycle
            lib = library_path(name)
            locks.enter_context(_locked(lib))
            if lib.exists():            # built while this waited
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


def cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand:
            return cand
    raise RuntimeError("g++ not found: set CXX or put g++ on PATH")


def host_library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.h")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(HOST_FLAGS + HOST_LIBS).encode())
    return HOST_BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build_host(source: Path) -> float:
    """Compile a host C++ source unless its library is current. Returns
    the seconds this call spent building or waiting for another
    process's build (0.0 when the library was there); raises with g++'s
    output if the build fails."""
    lib = host_library_path(source)
    if lib.exists():
        return 0.0
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with _locked(lib):
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            out = subprocess.run(
                [cxx(), *HOST_FLAGS, "-o", str(tmp), str(source), *HOST_LIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed for {source.name}:\n{out.stdout}")
            os.replace(tmp, lib)
    return time.perf_counter() - t0


def load_host(source: Path) -> ctypes.CDLL:
    """The loaded library of a host C++ source, built first if needed."""
    key = str(source)
    if key not in _loaded:
        build_host(source)
        _loaded[key] = ctypes.CDLL(str(host_library_path(source)))
    return _loaded[key]
