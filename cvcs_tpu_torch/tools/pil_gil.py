"""Does a decode hold the interpreter lock? The host tier
(``cvcs_tpu_torch.native``) decodes on a worker thread beside the main
thread, so its overlap depends on the answer. Measured for both tiers:
the C++ library (``native.decode``: ctypes releases the lock around the
call, and nothing in the library takes it) and the plain version
(``native.plain.decode``: PIL, which releases the lock around each block
it decodes and takes it back after each).

    python -m cvcs_tpu_torch.tools.pil_gil [--side N]

Writes an N x N x 3 uint8 raster (default 3400, a quarter of a GID15
scene; its top half smooth, its bottom half noise) as an uncompressed
TIFF and as a PNG into a temporary directory, then for each tier and
file: the decode alone (best of two), a pure-Python counting loop alone
(its rate, over at least 0.2 s), and both at once, the decode on a
thread and the loop on the main thread until the decode ends: the
decode's ms beside the loop, and the loop's rate then as a share of its
rate alone (repeated while the runs beside the loop add up to less than
half a second, at most five times; the medians). A decode that released
the lock throughout would keep its time and leave the loop near 100%;
one that held it throughout would keep its time and stop the loop; one
that releases it around each block it decodes and waits to take it back
after each (a convoy) slows by those waits while the loop runs at part
of its rate. Host clock. The last line printed is a JSON object of the
numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
from PIL import Image

from cvcs_tpu_torch import native
from cvcs_tpu_torch.native import plain

TIERS = {"cpp": native.decode, "plain": plain.decode}


def _count(stop: threading.Event) -> int:
    n = 0
    while not stop.is_set():
        n += 1
    return n


def _loop_rate(seconds: float) -> float:
    """Counts a second of the loop alone, over ``seconds``."""
    stop, counted = threading.Event(), []
    loop = threading.Thread(target=lambda: counted.append(_count(stop)))
    t0 = time.perf_counter()
    loop.start()
    time.sleep(seconds)
    stop.set()
    loop.join()
    return counted[0] / (time.perf_counter() - t0)


def _beside(decode, path: Path) -> tuple[float, float]:
    """(the decode's seconds, the loop's counts a second) with both at
    once."""
    stop, got = threading.Event(), {}

    def run():
        t0 = time.perf_counter()
        decode(path)
        got["s"] = time.perf_counter() - t0
        stop.set()

    t0 = time.perf_counter()
    worker = threading.Thread(target=run)
    worker.start()
    n = _count(stop)
    both = time.perf_counter() - t0
    worker.join()
    return got["s"], n / both


def probe(decode, path: Path) -> dict:
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        decode(path)
        times.append(time.perf_counter() - t0)
    alone = min(times)
    rate = _loop_rate(max(alone, 0.2))
    runs = [_beside(decode, path)]
    while sum(s for s, _ in runs) < 0.5 and len(runs) < 5:
        runs.append(_beside(decode, path))
    return dict(decode_alone_ms=alone * 1e3,
                decode_beside_ms=statistics.median(s for s, _ in runs) * 1e3,
                loop_share=statistics.median(r for _, r in runs) / rate,
                runs=len(runs))


def raster(side: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (side, side, 3), np.uint8)
    blocks = img[:side // 32 + 1, :side // 16 + 1]
    img[:side // 2] = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[
        :side // 2, :side]
    return img


def measure(side: int = 3400, log=print) -> dict:
    """{tier: {"tif" | "png": probe}} for the raster of ``side``."""
    img = raster(side)
    out = {tier: {} for tier in TIERS}
    with tempfile.TemporaryDirectory() as tmp:
        for ext in ("tif", "png"):
            path = Path(tmp) / f"raster.{ext}"
            Image.fromarray(img).save(path)
            for tier, decode in TIERS.items():
                out[tier][ext] = r = probe(decode, path)
                log(f"{tier} {ext} {side}x{side}: decode alone "
                    f"{r['decode_alone_ms']:.1f} ms, beside a busy Python "
                    f"thread {r['decode_beside_ms']:.1f} ms; the thread ran "
                    f"at {r['loop_share'] * 100:.1f}% of its rate alone "
                    f"meanwhile (median of {r['runs']})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=3400)
    out = measure(ap.parse_args(argv).side,
                  log=lambda s: print(s, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
