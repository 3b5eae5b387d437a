"""The host tier's plain version: the calls of :mod:`cvcs_tpu_torch.native`
(``prefetch``, ``take``, ``decode``, ``write_png``, ``write_png_async``,
``flush_writes``, ``load``, ``NATIVE_SUFFIXES``) on PIL, a Python decode
worker and a Python writer thread. The main path runs the C++ tier
(``native/tile_reader.cpp``); this module is what the tests,
``chip_smoke.py`` (parity, and a chunk leg run through each tier) and
``tools/pil_gil.py`` hold it against. It keeps the C++ tier's design
(``tile_reader.cpp`` ``Prefetcher`` and the writer):

* one decode worker thread and a cache keyed by path: :func:`prefetch`
  queues a decode unless the path is cached or pending; :func:`take`
  removes and returns the path's entry, waiting while it is pending, and
  decodes inline when the path was never queued;
* a decode that failed in the worker raises at :func:`take`, the
  exception an inline decode raises; it is neither swallowed nor
  retried;
* one writer thread: :func:`write_png_async` copies the array before it
  returns and queues its encode; :func:`flush_writes` waits until every
  queued write has landed and returns how many failed since the last
  flush.

What holds the interpreter lock: PIL releases it around each block it
decodes and takes it back after each, so a decode beside a busy Python
thread queues for the lock once a block, up to the switch interval each
time (a GIL convoy; ``PERF.md`` §6), and the worker and writer
run their own Python between blocks under it. The threads overlap the
caller's waits that release the lock (CUDA synchronisations, file
reads), not its Python work. The C++ tier holds the lock at no point.

Formats: PNG and TIFF, 8-bit with 1-4 channels (PIL modes ``L``, ``LA``,
``RGB``, ``RGBA``). As the C++ tier rejects other sub-formats up front,
:func:`decode` and :func:`take` return None for any other mode (palette,
16-bit, CMYK, ...), and the caller decodes with PIL itself.
"""

from __future__ import annotations

import collections
import threading
from pathlib import Path

import numpy as np
from PIL import Image

MODES = {"L", "LA", "RGB", "RGBA"}     # the C++ tier's 8-bit, 1-4 channels
CHANNELS = (1, 3, 4)                   # what the writer encodes
NATIVE_SUFFIXES = {".png", ".tif", ".tiff"}   # what decode and take carry


def decode(path) -> np.ndarray | None:
    """A PNG or TIFF as (H, W, C) or (H, W) uint8, decoded on the calling
    thread; None for a mode the tier does not carry. Raises what PIL
    raises for a file it cannot read."""
    Image.MAX_IMAGE_PIXELS = None       # GID15 scenes are 49 Mpx
    with Image.open(path) as im:
        if im.mode not in MODES:
            return None
        return np.asarray(im)


def _encode(path: str, arr: np.ndarray) -> bool:
    """(H, W, C) uint8 with C in 1, 3, 4 as a PNG at ``path``."""
    if arr.ndim != 3 or arr.shape[2] not in CHANNELS:
        return False
    try:
        Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr).save(
            path, format="PNG")
    except (OSError, ValueError):
        return False
    return True


class _Prefetcher:
    """One decode worker and the path-keyed cache of its results: path ->
    (array or None, the exception its decode raised or None)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._pending: set = set()
        self._cache: dict = {}
        self._worker: threading.Thread | None = None

    def prefetch(self, path) -> None:
        key = str(path)
        with self._cv:
            if key in self._cache or key in self._pending:
                return
            self._pending.add(key)
            self._queue.append(key)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="native-decode", daemon=True)
                self._worker.start()
            self._cv.notify_all()

    def take(self, path) -> np.ndarray | None:
        key = str(path)
        with self._cv:
            # wait for "cached or no longer pending": another take of the
            # same path may have removed the entry first
            self._cv.wait_for(lambda: key in self._cache
                              or key not in self._pending)
            hit = self._cache.pop(key, None)
        if hit is None:
            return decode(key)           # never queued: decode inline
        arr, err = hit
        if err is not None:
            raise err
        return arr

    def size(self) -> int:
        with self._cv:
            return len(self._cache)

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queue)
                key = self._queue.popleft()
            try:
                hit = (decode(key), None)
            except BaseException as err:  # raised again at take()
                hit = (None, err)
            with self._cv:
                self._cache[key] = hit
                self._pending.discard(key)
                self._cv.notify_all()


class _Writer:
    """One PNG writer thread; counts the writes that failed."""

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._busy = 0
        self._failures = 0
        self._worker: threading.Thread | None = None

    def write(self, path, arr: np.ndarray) -> None:
        with self._cv:
            self._queue.append((str(path), arr))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="native-write", daemon=True)
                self._worker.start()
            self._cv.notify_all()

    def flush(self) -> int:
        with self._cv:
            self._cv.wait_for(lambda: not self._queue and not self._busy)
            failures, self._failures = self._failures, 0
            return failures

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queue)
                path, arr = self._queue.popleft()
                self._busy += 1
            try:
                ok = _encode(path, arr)
            except BaseException:       # a failure; the thread lives on
                ok = False
            with self._cv:
                self._busy -= 1
                self._failures += not ok
                self._cv.notify_all()


_prefetcher = _Prefetcher()
_writer = _Writer()


def load():
    """The tier's decoder (always available: PIL is a dependency); the C++
    tier returns its library here."""
    return _prefetcher


def prefetch(path) -> None:
    """Queue a background decode of ``path``."""
    _prefetcher.prefetch(Path(path))


def take(path) -> np.ndarray | None:
    """The decoded raster of ``path``: its prefetched entry (removed from
    the cache; waits while its decode runs), or an inline decode when it
    was never queued. Raises the decode's exception; None for a mode the
    tier does not carry."""
    return _prefetcher.take(Path(path))


def _as_hwc(arr: np.ndarray) -> np.ndarray:
    """A contiguous uint8 copy of (H, W[, C]) as (H, W, C)."""
    arr = np.array(arr, dtype=np.uint8, order="C", copy=True)
    return arr[..., None] if arr.ndim == 2 else arr


def write_png(path, arr: np.ndarray) -> bool:
    """Encode (H, W[, C]) uint8, C in 1, 3, 4, as a PNG at ``path`` now;
    False when it cannot be written."""
    return _encode(str(path), _as_hwc(arr))


def write_png_async(path, arr: np.ndarray) -> bool:
    """Queue a PNG write of a copy of ``arr`` (the caller may reuse its
    buffer at once); call :func:`flush_writes` before relying on the
    file. Returns True."""
    _writer.write(Path(path), _as_hwc(arr))
    return True


def flush_writes() -> int:
    """Block until every queued write has landed; the number of writes
    that failed since the last flush."""
    return _writer.flush()
