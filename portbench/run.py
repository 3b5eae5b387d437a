"""One run of one cell of the port's benchmark on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs and weights from
the seed, sets up and warms the cell's shapes, measures for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, from spans, counters and a profiled sub-window), then
checks what the window produced against the plain reference. The
compared numbers and their limits are the last lines on standard error;
the last line on standard output is the result, one JSON object.

It exits with another code than 0, and prints no result, when there is no
CUDA card or fewer than the cell asks for, or when JAX or the JAX package
is loaded once the window has closed. Every build and kernel cache lives
under ``build/`` of the checkout.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (0 where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# caches at fixed paths inside the checkout, so that only a checkout's
# first run builds and compiles
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    chips = {w["name"]: int(w["chips"]) for w in manifest["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does not "
              "run elsewhere", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    from portbench import harness

    b = harness.bench_for(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda")
    result, checks = harness.run(b, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
