"""Host decode and encode tier (port of ``cvcs_tpu/native/__init__.py``):
ctypes bindings of the port's C++ library (``native/tile_reader.cpp``),
a PNG and TIFF decoder with one background decode worker and a
path-keyed cache, and a PNG encoder with one background writer thread.

The library builds with ``g++`` from the port's own source at first use
(never at import) into ``build/native/`` at the repository root, the
name hashing the source, its header and the flags (``ops/_build.py``
``build_host``; a file lock makes processes that start together build it
once). It needs zlib's runtime library (``libz.so.1``) and no libpng,
libtiff or zlib headers. A build or load that fails raises with the
compiler's output: there is no quiet fallback.

* :func:`prefetch` queues a decode on the C++ worker unless the path is
  cached or pending; :func:`take` removes and returns the path's entry,
  waiting while it is pending, and decodes inline on the calling thread
  when the path was never queued (or another ``take`` removed it first);
* a decode that failed on the worker fails at :func:`take` as an inline
  decode fails; the entry is removed, so the next ``take`` decodes
  inline;
* :func:`write_png_async` hands the array to the writer thread, which
  copies it before the call returns; :func:`flush_writes` waits until
  every queued write has landed and returns how many failed since the
  last flush.

What holds the interpreter lock: nothing in the library. ctypes releases
the lock around every call into it, and the worker and writer are C++
threads that never take it, so a decode or an encode runs beside the
caller's Python at full speed, and an inline :func:`decode` or a cold
:func:`take` lets the caller's other threads run meanwhile. (The plain
version, :mod:`cvcs_tpu_torch.native.plain`, decodes with PIL, which
takes the lock back after every block it decodes.)

Formats: PNG and TIFF, told apart by their first bytes. The library
decodes what it decodes byte for byte as ``np.asarray(Image.open(p))``
does: 8-bit samples with 1-4 channels (PIL modes ``L``, ``LA``, ``RGB``,
``RGBA``); TIFFs in either byte order, in strips or tiles, uncompressed
or LZW, Deflate or PackBits with the horizontal predictor; PNGs with any
row filters, not interlaced. :func:`decode` and :func:`take` return None
for every other sub-format (palette, 16-bit, tRNS, interlaced PNGs,
JPEG-compressed TIFFs, ...; the library rejects them from the header),
and the caller decodes those with PIL. They raise :class:`OSError` naming
the path for a file they cannot read (missing, truncated, a bad CRC or a
corrupt stream). The writer encodes (H, W[, C]) uint8 with C in 1, 3, 4.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).with_name("tile_reader.cpp")
NATIVE_SUFFIXES = {".png", ".tif", ".tiff"}   # what decode and take carry
# the library's status codes; the others are TR_UNREADABLE (-1) and
# TR_SMALL (-2, a caller's buffer too short), both raised as OSError
OK, UNSUPPORTED = 0, -3

_lib: ctypes.CDLL | None = None
_load_lock = threading.Lock()


def build() -> float:
    """Build the library unless it is current; the seconds it took."""
    from cvcs_tpu_torch.ops import _build

    return _build.build_host(SOURCE)


def load() -> ctypes.CDLL:
    """The library (built first if needed), its calls declared."""
    global _lib
    with _load_lock:
        if _lib is None:
            from cvcs_tpu_torch.ops import _build

            _lib = _declare(_build.load_host(SOURCE))
    return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    path = ctypes.c_char_p
    info = [path, u32p, u32p, u32p]
    into = [path, ctypes.c_void_p, ctypes.c_int64, u32p, u32p, u32p]
    owned = [path, ctypes.POINTER(ctypes.c_void_p), u32p, u32p, u32p]
    encode = [path, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
              ctypes.c_uint32]
    for name, args, res in (
            ("tr_info", info, ctypes.c_int),
            ("tr_png_info", info, ctypes.c_int),
            ("tr_tiff_info", info, ctypes.c_int),
            ("tr_decode", into, ctypes.c_int),
            ("tr_decode_png", into, ctypes.c_int),
            ("tr_decode_tiff", into, ctypes.c_int),
            ("tr_take", into, ctypes.c_int),
            ("tr_decode_owned", owned, ctypes.c_int),
            ("tr_take_owned", owned, ctypes.c_int),
            ("tr_free", [ctypes.c_void_p], None),
            ("tr_prefetch", [path], None),
            ("tr_cache_size", [], ctypes.c_int64),
            ("tr_decode_count", [ctypes.c_int], ctypes.c_int64),
            ("tr_last_error", [], ctypes.c_char_p),
            ("tr_last_errno", [], ctypes.c_int),
            ("tr_encode_png", encode, ctypes.c_int),
            ("tr_write_async", encode, None),
            ("tr_flush_writes", [], ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _failure(lib: ctypes.CDLL, path) -> OSError:
    """The OSError of the library's last failure on this thread."""
    err = lib.tr_last_errno()
    if err:
        return OSError(err, os.strerror(err), str(path))
    return OSError(f"cannot decode {path}: {lib.tr_last_error().decode()}")


class _Owned:
    """A buffer the library handed over, freed with the last array that
    views it."""

    def __init__(self, lib: ctypes.CDLL, ptr: int, shape: tuple):
        self._free, self._ptr = lib.tr_free, ptr
        self.__array_interface__ = dict(shape=shape, typestr="|u1",
                                        data=(ptr, False), version=3)

    def __del__(self):
        self._free(self._ptr)


def _owned(name: str, path) -> np.ndarray | None:
    lib = load()
    data, w, h, c = (ctypes.c_void_p(), ctypes.c_uint32(), ctypes.c_uint32(),
                     ctypes.c_uint32())
    rc = getattr(lib, name)(os.fsencode(path), ctypes.byref(data),
                            ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc == UNSUPPORTED:
        return None
    if rc != OK:
        raise _failure(lib, path)
    arr = np.asarray(_Owned(lib, data.value, (h.value, w.value, c.value)))
    return arr[..., 0] if c.value == 1 else arr


def _into(info: str, decode: str, path) -> np.ndarray | None:
    """The JAX module's two calls: the header's size, then a decode into
    an array of that size."""
    lib = load()
    p = os.fsencode(path)
    w, h, c = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    refs = ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)
    rc = getattr(lib, info)(p, *refs)
    if rc == OK:
        buf = np.empty((h.value, w.value, c.value), np.uint8)
        rc = getattr(lib, decode)(p, buf.ctypes.data, buf.nbytes, *refs)
    if rc == UNSUPPORTED:
        return None
    if rc != OK:        # TR_SMALL too: the file changed between the calls
        raise _failure(lib, path)
    return buf[..., 0] if c.value == 1 else buf


def decode(path) -> np.ndarray | None:
    """A PNG or TIFF as (H, W, C) or (H, W) uint8, decoded on the calling
    thread (the interpreter lock released); None for a sub-format the
    tier does not carry. Raises OSError for a file it cannot read."""
    return _owned("tr_decode_owned", path)


def decode_png(path) -> np.ndarray | None:
    """A PNG as :func:`decode` gives it; a TIFF is unreadable here."""
    return _into("tr_png_info", "tr_decode_png", path)


def decode_tiff(path) -> np.ndarray | None:
    """A TIFF as :func:`decode` gives it; a PNG is unreadable here."""
    return _into("tr_tiff_info", "tr_decode_tiff", path)


def prefetch(path) -> None:
    """Queue a background decode of ``path`` on the C++ worker."""
    load().tr_prefetch(os.fsencode(path))


def take(path) -> np.ndarray | None:
    """The decoded raster of ``path``: its prefetched entry (removed from
    the cache; waits while its decode runs), or an inline decode when it
    was never queued. None for a sub-format the tier does not carry;
    raises OSError for a file it cannot read, whichever thread decoded
    it."""
    return _owned("tr_take_owned", path)


def _as_hwc(arr: np.ndarray) -> np.ndarray:
    """(H, W[, C]) as a contiguous uint8 (H, W, C) array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim not in (2, 3):
        raise ValueError(f"a PNG is (H, W[, C]), not {arr.shape}")
    return arr[..., None] if arr.ndim == 2 else arr


def write_png(path, arr: np.ndarray) -> bool:
    """Encode (H, W[, C]) uint8, C in 1, 3, 4, as a PNG at ``path`` now;
    False when it cannot be written."""
    h, w, c = (arr := _as_hwc(arr)).shape
    return load().tr_encode_png(os.fsencode(path), arr.ctypes.data,
                                w, h, c) == OK


def write_png_async(path, arr: np.ndarray) -> bool:
    """Queue a PNG write of ``arr`` (copied before this returns, so the
    caller may reuse its buffer at once); call :func:`flush_writes`
    before relying on the file. Returns True; a write that cannot be
    made (C not in 1, 3, 4, an unwritable path) counts as a failure at
    the flush."""
    h, w, c = (arr := _as_hwc(arr)).shape
    load().tr_write_async(os.fsencode(path), arr.ctypes.data, w, h, c)
    return True


def flush_writes() -> int:
    """Block until every queued write has landed; the number of writes
    that failed since the last flush."""
    return int(load().tr_flush_writes())
