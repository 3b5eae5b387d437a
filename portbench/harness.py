"""One run of one cell of ``BENCHMARK.json``, found by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by the names in
``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the configuration's sizes;
- ``portbench/reference/<config>.py``: its plain float32 reference
  (``param_specs`` and ``forward``);
- ``portbench/traffic/<traffic>.json``: the mix's parameters, among them
  the name of the general driver that reads them,
  ``portbench/drivers/<driver>.py``;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader, whose
  ``read(record)`` returns the number or None when the run holds nothing
  to read;
- ``portbench/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares.

A driver has ``setup(b)``, ``window(b, state)``, ``release(b, state)``,
``check(b, state, rec)`` and ``flops_per_unit(b)``; :class:`Bench` is
what it is handed.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from portbench import tracing, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "cvcs_tpu")   # whole top-level names
PROGRAM = "cvcs_tpu_torch"


@dataclasses.dataclass
class Bench:
    root: Path
    cell: dict
    cfg: dict
    traffic: dict
    ref: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: tracing.Spans
    # the control of the correctness check: the reference, in this
    # precision, in the program's place (portbench/controls.py only)
    control: str | None = None

    def weights(self) -> dict:
        """The configuration's weights, made from the seed on the device
        (the same numbers every time they are asked for)."""
        return weights.make_weights(self.ref.param_specs(self.cfg),
                                    self.seed, self.device)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark from its file (names may hold dots)."""
    name = "portbench_" + "".join(ch if ch.isalnum() else "_"
                                  for ch in str(path.relative_to(
                                      path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: an
    entry with ``workloads`` where it lists the cell; an end-to-end one
    without, everywhere; a per-layer one without, wherever its ``moves``
    target is reported."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def find(manifest: dict, cell_name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def reference_imports(root: Path) -> list[str]:
    """Modules under ``portbench/reference/`` that import the program or
    JAX: (file, module) for each such import."""
    bad = []
    for path in sorted((root / "portbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in (PROGRAM,) + FORBIDDEN:
                    bad.append(f"{path.name}: {n}")
    return bad


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (so the port's own name passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bench_for(root: Path, cell_name: str, seed: int, seconds: float,
              trace: bool, device, traffic: dict | None = None) -> Bench:
    """The :class:`Bench` of a cell. ``traffic`` replaces the mix's file
    (the CPU tests run the same code at a small size)."""
    manifest = load_json(root / "BENCHMARK.json")
    cell, cfg_entry = find(manifest, cell_name)
    cfg = load_json(root / cfg_entry["file"])
    if traffic is None:
        traffic = load_json(root / "portbench" / "traffic"
                            / f"{cell['traffic']}.json")
    ref = load_module(root / "portbench" / "reference"
                      / f"{cell['config']}.py")
    dev = torch.device(device)
    return Bench(root, cell, cfg, traffic, ref, seed, seconds, trace, dev,
                 tracing.Spans(trace, dev))


def run(b: Bench, t_start: float) -> tuple[dict, list]:
    """Set up, measure, check. Returns the result line's object and the
    compared numbers [(name, value, limit)]."""
    manifest = load_json(b.root / "BENCHMARK.json")
    name = b.cell["name"]
    bad = reference_imports(b.root)
    if bad:
        raise SystemExit("the reference imports the program or JAX: "
                         + "; ".join(bad))
    driver = load_module(b.root / "portbench" / "drivers"
                         / f"{b.traffic['driver']}.py")
    e2e, layer = cell_metrics(manifest, name)
    cuda = b.device.type == "cuda"

    state = driver.setup(b)
    rec = driver.window(b, state)
    setup_s = rec["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(b.device) if cuda else 0
    metrics, extra = {}, {}
    if not b.trace:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else rec["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        r = dict(rec["record"], window_s=rec["t1"] - rec["t0"],
                 units=rec["units"], cfg=b.cfg, traffic=b.traffic,
                 device_ms=b.spans.device_ms(), host=dict(b.spans.host),
                 flops_per_unit=driver.flops_per_unit(b))
        for m in layer:
            reader = load_module(b.root / "portbench" / "metrics"
                                 / f"{m['name']}.py")
            v = reader.read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        summary = r.get("trace")
        if summary is not None:
            extra = {"busy_s": summary["busy_s"],
                     "window_s": summary["window_s"]}
    driver.release(b, state)
    numbers = driver.check(b, state, rec)
    limits = load_json(b.root / "portbench" / "limits" / f"{name}.json")
    checks = [(k, float(numbers[k]) if k in numbers else float("nan"),
               float(lim)) for k, lim in limits.items()]
    checks += [(k, float(v), float("nan")) for k, v in numbers.items()
               if k not in limits]
    correct = (rec["failed"] == 0
               and all(v <= lim for _, v, lim in checks))
    device = {"platform": "gpu" if cuda else b.device.type,
              "kind": (torch.cuda.get_device_name(b.device) if cuda
                       else "cpu"),
              "count": int(b.cell["chips"]),
              "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit_w"] = power_limit_w()
    device.update(extra)
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": device}
    if b.trace and rec["record"].get("trace") is not None:
        result["breakdown"] = tracing.breakdown(rec["record"]["trace"])
    result["checks"] = {k: {"value": _finite(v), "limit": _finite(lim)}
                        for k, v, lim in checks}
    return result, checks


def _finite(v: float) -> float | None:
    """A number for the result line; None where there is none (a number
    with no limit, or a limit with no number, fails the check)."""
    return None if v != v else v
