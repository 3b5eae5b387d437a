"""The whole-scene driver: scenes served by batch prediction, one client
in a closed loop.

Parameters (the mix's file): ``scene`` [H, W, C] of each raster,
``pool`` (distinct rasters made from the seed and held in host memory,
served in turn), ``patch_size``, ``border_correction``, ``batch_tiles``
(windows a forward), ``path`` (the predict keys that choose the engine's
path: ``{}`` the window path, or ``stream_rows`` / ``fullconv_bands``),
``check_tiles`` (tiles sampled from the seed for the correctness check),
``check_block`` (windows a reference forward), ``traced_scenes`` (the
scenes of the traced sub-window, after the window's first).

Each scene goes through ``cvcs_tpu_torch.cli.predict.scene_labels`` on a
``SceneSegmenter`` built as ``cli/predict.py`` builds it, and its labels
are brought to the host with ``labels_to_host``. The window starts
before the first scene is uploaded; no scene starts after ``--seconds``;
the window ends when the last scene's labels are on the host.

The check: the reference forwards the sampled tiles' border-correction
windows, cut from the same rasters, and judges the program's labels by
the reference's logits: ``label_gap`` is the widest gap by which the
logit of the program's label lies below the reference's best, over every
pixel of the sampled tiles, in units of the standard deviation of the
reference's logits. (The share of labels that differ is not compared:
with random weights it counts near-ties, whose number moves a
hundredfold from seed to seed.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops, tracing
from portbench.reference import ops
from portbench.weights import generator, load_into, stream_seed


def make_rasters(n: int, shape, seed: int, device) -> list[np.ndarray]:
    """``n`` uint8 rasters of ``shape`` (H, W, C), made on the device from
    the seed: 16-pixel blocks of random colour, halved, plus texture."""
    h, w, c = shape
    gen = generator(seed, "rasters", device)
    out = []
    for _ in range(n):
        base = torch.randint(0, 256, (h // 16 + 1, w // 16 + 1, c),
                             generator=gen, device=device, dtype=torch.uint8)
        img = base.repeat_interleave(16, 0).repeat_interleave(16, 1)[:h, :w]
        img = img // 2 + torch.randint(0, 64, (h, w, c), generator=gen,
                                       device=device, dtype=torch.uint8)
        out.append(img.cpu().numpy())
    return out


def _predict_config(b) -> dict:
    t = b.traffic
    config = {"net": b.cfg["net"], "patch_size": t["patch_size"],
              "border_correction": t["border_correction"],
              "batch_tiles": t["batch_tiles"],
              "num_classes": b.cfg["num_classes"] - 1,
              "precision": b.cfg["precision"], **t.get("path", {})}
    if b.device.type == "cpu":
        config["device"] = "cpu"
    return config


class Model:
    """The model callable the engine is handed: the program's model, or
    under a control the reference in its place; in a traced run each call
    is a ``forward`` span between two CUDA events, and its batch is
    kept."""

    def __init__(self, b, model):
        self.b, self.model, self.batches = b, model, []
        if b.control:
            w = b.weights()
            self.model = lambda x: b.ref.forward(w, x, b.cfg, prec=b.control)

    def __call__(self, x):
        self.batches.append(x.shape[0])
        with self.b.spans.timed("forward"):
            return self.model(x)


def setup(b):
    from cvcs_tpu_torch.cli import common
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

    t = b.traffic
    config = _predict_config(b)
    device = common.device_context(config)
    model, spec, num_classes = common.build_apply(config, device)
    load_into(model, b.weights())
    # as cli/predict.py builds it
    infer_cfg = InferenceConfig(
        patch_size=int(config["patch_size"]),
        border_correction=config.get("border_correction"),
        batch_tiles=int(config.get("batch_tiles", 128)),
        num_classes=num_classes,
        bug_parity=bool(config.get("bug_parity")),
        mask_only=bool(config.get("mask_only", False)),
        tta=bool(config.get("tta")))
    wrapped = Model(b, model)
    seg = SceneSegmenter(wrapped if (b.trace or b.control) else model,
                         infer_cfg, returns_logits=spec.returns_logits,
                         requires_context=spec.requires_context,
                         stride_product=spec.stride_product, device=device)
    pool = make_rasters(t["pool"], t["scene"], b.seed, device)
    state = {"seg": seg, "config": config, "pool": pool, "model": wrapped}
    for raw in pool if not b.control else ():   # warm the window's shapes
        _scene(b, state, raw)
    wrapped.batches.clear()
    return state


def _scene(b, state, raw) -> np.ndarray:
    from cvcs_tpu_torch.cli.predict import scene_labels
    from cvcs_tpu_torch.infer.engine import labels_to_host

    with b.spans.span("scene"):
        labels = scene_labels(state["seg"], raw, state["config"])
        with b.spans.span("fetch"):
            return labels_to_host(labels)


def window(b, state) -> dict:
    from cvcs_tpu_torch.ops import swin_attn

    seg, pool, model = state["seg"], state["pool"], state["model"]
    profile = tracing.Profile(b.device) if b.trace else None
    if b.trace:
        pad_scene = seg.pad_scene

        def upload(scene):
            with b.spans.span("upload"):
                return pad_scene(scene)

        seg.pad_scene = upload
    first, last = 1, 1 + b.traffic["traced_scenes"]   # traced scenes
    sub = {}
    done = []
    b.spans.reset()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < b.seconds:
        k = len(done)
        if profile is not None and k == first:
            sub["first_forward"] = len(model.batches)
            sub["k1_before"] = swin_attn.launches
            profile.start()
        done.append(_scene(b, state, pool[k % len(pool)]))
        if profile is not None and k + 1 == last:
            _close(profile, sub, model, k + 1 - first)
    t1 = time.perf_counter()
    if "first_forward" in sub and "scenes" not in sub:
        _close(profile, sub, model, len(done) - first)   # closed inside it
    tiles = sum(lab.shape[0] // b.traffic["patch_size"]
                * (lab.shape[1] // b.traffic["patch_size"]) for lab in done)
    state["done"] = done
    record = {"sub": sub, "trace": None, "profiler_s": 0.0}
    if "scenes" in sub:
        record["trace"] = profile.reduce()
        record["profiler_s"] = profile.own_s
    return {"t0": t0, "t1": t1, "units": tiles, "attempted": len(done),
            "failed": 0, "e2e": {"scene_tiles_per_s": tiles / (t1 - t0)},
            "record": record}


def _close(profile, sub, model, scenes: int) -> None:
    """End the traced sub-window (the last scene's labels are on the
    host, so its device work is done)."""
    from cvcs_tpu_torch.ops import swin_attn

    profile.stop()
    sub["scenes"] = scenes
    sub["forwards"] = model.batches[sub["first_forward"]:]
    sub["k1"] = swin_attn.launches - sub["k1_before"]


def release(b, state) -> None:
    for key in ("seg", "model"):
        state.pop(key, None)
    if b.device.type == "cuda":
        torch.cuda.empty_cache()


def flops_per_unit(b) -> float:
    bc = b.traffic["border_correction"] or b.traffic["patch_size"]
    return flops.count(b.ref, b.cfg, (1, bc, bc, b.cfg["in_channels"]),
                       train=False)


@torch.no_grad()
def check(b, state, rec) -> dict:
    t = b.traffic
    p = t["patch_size"]
    bc = t["border_correction"] or p
    off = (bc - p) // 2
    done, pool = state["done"], state["pool"]
    rows, cols = done[0].shape[0] // p, done[0].shape[1] // p
    tpi = rows * cols
    rng = np.random.default_rng(stream_seed(b.seed, "check"))
    n = min(t["check_tiles"], len(done) * tpi)
    picks = np.sort(rng.choice(len(done) * tpi, size=n, replace=False))
    w = b.weights()
    gap, total, total_sq, count = 0.0, 0.0, 0.0, 0
    block = t["check_block"]
    padded = [np.pad(r, ((bc, bc), (bc, bc), (0, 0))) for r in pool]
    with ops.exact():
        for s in range(0, n, block):
            wins, prog = [], []
            for i in picks[s:s + block]:
                k, tile = divmod(int(i), tpi)
                r, c = divmod(tile, cols)
                y, x = r * p - off + bc, c * p - off + bc
                wins.append(padded[k % len(pool)][y:y + bc, x:x + bc])
                prog.append(done[k][r * p:(r + 1) * p, c * p:(c + 1) * p])
            x = torch.from_numpy(np.stack(wins)).to(b.device).float()
            logits = b.ref.forward(w, x, b.cfg)[:, off:off + p, off:off + p]
            lab = torch.from_numpy(np.stack(prog)).to(b.device).long()
            best = logits.max(-1).values
            mine = logits.gather(-1, lab[..., None])[..., 0]
            gap = max(gap, float((best - mine).max()))
            d = logits.double()
            total += float(d.sum())
            total_sq += float((d * d).sum())
            count += d.numel()
    mean = total / count
    scale = max(total_sq / count - mean * mean, 1e-300) ** 0.5
    return {"label_gap": gap / scale}
