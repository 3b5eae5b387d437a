"""Readings that the correctness limits are set from, taken on the card at
each cell's own size (not part of a benchmark run):

    python3 portbench/controls.py --workload <cell> --mode <mode> --seeds 1,2,3

- ``program``: the program as the benchmark runs it, with a window of one
  scene (scene cells) or none (training cells: the check follows the
  set-up steps, which the window does not change): the lower readings;
- ``control``: the reference in float8 (``portbench/reference/ops.py``)
  in the program's place: the upper readings;
- ``half_batch`` (training cells): each step given half its batch, the
  loss the mean over that half: a fault the check must catch.

One JSON line a seed, with the numbers the cell's check compares. Every
seed runs in this one process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def reading(b, mode: str, detail: dict | None = None) -> dict:
    """The numbers of one seed under ``mode``; a training cell's per-leaf
    gaps and norms go into ``detail`` when it is given."""
    import torch

    from portbench import harness

    driver = harness.load_module(b.root / "portbench" / "drivers"
                                 / f"{b.traffic['driver']}.py")
    if b.traffic["driver"] == "train" and mode == "control":
        return train_control(b, driver, detail)
    if mode == "control":
        b.control = "fp8"
    restore = None
    if mode == "half_batch":
        from cvcs_tpu_torch.train import step as step_lib

        train_step = step_lib.train_step

        def half(state, loss_fn, image, mask, **kw):
            n = image.shape[0] // 2
            return train_step(state, loss_fn, image[:n], mask[:n], **kw)

        step_lib.train_step, restore = half, train_step
    try:
        b.seconds = 1e-3
        state = driver.setup(b)
        rec = (driver.window(b, state) if b.traffic["driver"] == "scene"
               else None)
        driver.release(b, state)
        if b.traffic["driver"] == "train":
            return driver.check(b, state, rec, detail)
        return driver.check(b, state, rec)
    finally:
        if restore is not None:
            step_lib.train_step = restore
        if b.device.type == "cuda":
            torch.cuda.empty_cache()


def train_control(b, driver, detail: dict | None = None) -> dict:
    """The training check with the float8 reference's steps in the
    program's place: its losses, first gradients and updates, on its own
    patches."""
    import shutil
    import tempfile

    import torch

    root = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        state = {"root": root}
        state["images"], state["masks"] = driver.make_scenes(b, root)
        images, masks, losses, grads, after = driver.reference_run(
            b, state, prec="fp8")
        w0 = b.weights()
        bs = b.traffic["batch_size"]
        state.update(
            first_losses=losses,
            grad_norms={k: float(torch.linalg.vector_norm(g))
                        for k, g in grads.items()},
            update_norms={k: float(torch.linalg.vector_norm(after[k] - w0[k]))
                          for k in after},
            seen=[(images[i:i + bs].cpu(), masks[i:i + bs].cpu())
                  for i in range(0, len(images), bs)])
        with torch.enable_grad():
            return driver.compare(b, state, driver.reference_run(b, state),
                                  detail)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "control", "half_batch"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default=None,
                    help="run the program at this precision policy instead "
                    "of the configuration's (f32: a second witness)")
    ap.add_argument("--detail", type=int, default=0,
                    help="training cells: print the N worst leaves and the "
                    "median leaf's gap of grad_gap and update_gap")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        b = harness.bench_for(ROOT, args.workload, seed, 0.0, False,
                              args.device)
        if args.precision:
            b.cfg["precision"] = args.precision
        detail = {} if args.detail else None
        numbers = reading(b, args.mode, detail)
        line = {"workload": args.workload, "mode": args.mode, "seed": seed,
                "seconds": time.perf_counter() - t0, **numbers}
        if detail:
            line["losses"] = detail["losses"]
            for key, norms in (("grad", "g"), ("update", "u")):
                gaps = detail[key]
                worst = sorted(gaps, key=gaps.get)[::-1][:args.detail]
                line[f"{key}_median_leaf"] = float(np.median(list(
                    gaps.values())))
                line[f"{key}_worst"] = [
                    [k, gaps[k], detail[f"{norms}_prog"][k],
                     detail[f"{norms}_ref"][k]] for k in worst]
                line[f"{key}_median_norm"] = float(np.median(list(
                    detail[f"{norms}_ref"].values())))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
