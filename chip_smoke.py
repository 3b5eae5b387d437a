#!/usr/bin/env python3
"""Drive the PyTorch port (``cvcs_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the main path, one ``nvcc`` each, in
   parallel, into ``build/kernels/``;
3. kernels vs their plain PyTorch versions on the card, at the shapes the
   main path gives them (bf16 and f32 instances), within stated
   tolerances;
4. the main path: full-width SwinUnet (random weights from a fixed
   seed) segments one full-size 6800 x 7200 GID15-like scene
   (``predict_scene``, p 224, border correction 256, 128 windows per
   forward, bf16) and the serve daemon drains three 1792 x 2240 rasters;
   the launch counters must show every kernel ran; the same scene under
   the f32 policy through the kernel and through the plain attention
   must give the same labels on >= 99.9% of pixels; one forward of 128
   windows is timed and traced (torch.profiler) for where its time goes;
5. times (CUDA events, after warm-up) of each kernel beside its bound,
   its plain version and a library yardstick.

The last two lines are a JSON object of per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # x max(1, |plain|max)
B = 128                            # windows per forward on the main path
# (name, Hp = Wp, C, heads, win, h0 = w0, shift): K1 at the main path's
# four stage shapes (bc 256 windows), unmasked and with the region mask,
# plus the T = 49 stage-4 shape of p 224 without border correction and
# a pad-masked map (56 -> 64)
K1_CASES = [
    ("s1", 64, 96, 3, 8, 64, 0), ("s1_shift", 64, 96, 3, 8, 64, 4),
    ("s2", 32, 192, 6, 8, 32, 0), ("s2_shift", 32, 192, 6, 8, 32, 4),
    ("s3", 16, 384, 12, 8, 16, 0), ("s3_shift", 16, 384, 12, 8, 16, 4),
    ("s4", 8, 768, 24, 8, 8, 0), ("s4_region", 8, 768, 24, 8, 8, 4),
    ("t49", 7, 768, 24, 7, 7, 0), ("pad56", 64, 96, 3, 8, 56, 0),
]
# K1 launches of one SwinUnet forward at bc 256: (case, launches)
K1_PER_FORWARD = [("s1", 1), ("s1_shift", 1), ("s2", 1), ("s2_shift", 1),
                  ("s3", 3), ("s3_shift", 3), ("s4", 2)]


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- K1: Swin fused window attention -----------------------------------------
def k1_inputs(case, dtype, seed=0):
    from cvcs_tpu_torch.models.swin import attn_bias

    _, hp, c, heads, win, h0, shift = case
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).cuda()

    x = rnd(B, hp, hp, c).to(dtype)
    args = [x, 1 + rnd(c, std=0.1), rnd(c, std=0.1),
            rnd(c, 3 * c, std=c ** -0.5), rnd(3 * c, std=0.02),
            rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, hp, h0, h0, win, shift, x.device)
    return args, bias, dict(win=win, heads=heads)


def k1_bound(case, dtype, masked: bool) -> tuple[float, float]:
    """(ms the bytes take at the memory rate, ms the operations take at
    the peak rate): each input read once, each output written once."""
    _, hp, c, _, win, _, _ = case
    s = torch.finfo(dtype).bits // 8
    n = B * hp * hp
    t = win * win
    nwin = (hp // win) ** 2
    nbytes = 2 * n * c * s + 4 * c * c * s + (nwin * t * t * 4 if masked else 0)
    flops = 8 * n * c * c + 4 * n * t * c
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def k1_library(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, *, win, heads):
    """Yardstick the port never calls: F.layer_norm + F.linear +
    F.scaled_dot_product_attention + F.linear (no single PyTorch call
    computes the op)."""
    from cvcs_tpu_torch.ops.swin_attn import window_merge, window_partition

    b, hp, wp, c = x.shape
    t, d = win * win, c // heads
    tok = window_partition(F.layer_norm(x, (c,), ln_s.to(x.dtype),
                                        ln_b.to(x.dtype), 1e-6), win)
    qkv = F.linear(tok, wqkv.t().to(x.dtype), bqkv.to(x.dtype))
    q, k, v = qkv.reshape(b, -1, t, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    mask = None if bias is None else bias[:, None].to(x.dtype)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = o.permute(0, 1, 3, 2, 4).reshape(-1, t, c)
    return window_merge(F.linear(o, wout.t().to(x.dtype), bout.to(x.dtype)),
                        win, hp, wp)


def check_k1() -> float:
    """K1 vs its plain version at every case, bf16 and f32; returns the
    largest bf16 error at the main path's stage shapes."""
    from cvcs_tpu_torch.ops import swin_attn

    worst = 0.0
    for case in K1_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            args, bias, kw = k1_inputs(case, dtype)
            got = swin_attn.swin_window_attention(*args, bias, **kw)
            torch.cuda.synchronize()
            want = swin_attn.swin_window_attention_plain(*args, bias, **kw)
            torch.cuda.synchronize()
            scale = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            mean = (got.float() - want.float()).abs().mean().item()
            ok = err <= TOL[dtype] * scale and bool(torch.isfinite(got).all())
            log(f"  K1 {case[0]:>9} {str(dtype)[6:]:>8} B={B} Hp={case[1]} "
                f"C={case[2]} heads={case[3]} win={case[4]} "
                f"mask={'none' if bias is None else 'yes'}: max_abs_err="
                f"{err:.3e} mean={mean:.2e} tol={TOL[dtype] * scale:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {case[0]} {dtype}: {err} > tol")
            if dtype == torch.bfloat16 and case[0].startswith("s"):
                worst = max(worst, err)
            del args, got, want
    return worst


def time_k1() -> dict:
    """Per-case times (bf16, the main path) and per-forward totals."""
    from cvcs_tpu_torch.ops import swin_attn

    cases = {c[0]: c for c in K1_CASES}
    rows = {}
    for name, _ in K1_PER_FORWARD:
        args, bias, kw = k1_inputs(cases[name], torch.bfloat16)
        before = swin_attn.launches
        rows[name] = dict(
            ms=cuda_ms(lambda: swin_attn.swin_window_attention(
                *args, bias, **kw)),
            plain_ms=cuda_ms(lambda: swin_attn.swin_window_attention_plain(
                *args, bias, **kw)),
            library_ms=cuda_ms(lambda: k1_library(*args, bias, **kw)))
        rows[name]["bytes_ms"], rows[name]["ops_ms"] = k1_bound(
            cases[name], torch.bfloat16, bias is not None)
        rows[name]["bound_ms"] = max(rows[name]["bytes_ms"],
                                     rows[name]["ops_ms"])
        swin_attn.launches = before     # timing launches are not the path's
        r = rows[name]
        log(f"  K1 {name:>9} bf16: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, composite library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"(bytes {r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; "
            f"kernel at {r['bound_ms'] / r['ms'] * 100:.2f}% of bound)")
        del args
    total = {k: sum(rows[n][k] * cnt for n, cnt in K1_PER_FORWARD)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                       "ops_ms")}
    log(f"  K1 per forward (12 launches, bf16): kernel {total['ms']:.3f} ms,"
        f" plain {total['plain_ms']:.3f} ms, composite library "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms")
    return dict(total=total, per_case=rows)


# -- the main path -------------------------------------------------------------
def synthetic_scene(h, w, seed):
    """Blocky uint8 scene with texture: labels vary across it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w] // 2
    return img + rng.integers(0, 64, (h, w, 3), np.uint8)


def forward_breakdown(model) -> dict:
    """Where one forward's time goes: a SwinUnet forward of B bc-256
    windows timed with CUDA events, then traced once with torch.profiler
    for the device time of each kernel and the device's idle share (the
    gaps between kernels over the span from the first kernel's start to
    the last one's end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (B, 256, 256, 3), generator=g,
                      dtype=torch.uint8).cuda().float()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.elapsed_us() / 1e3
        tot[1] += 1
    if not spans:
        raise RuntimeError("torch.profiler recorded no device time")
    spans.sort()
    busy_us, end = 0.0, spans[0][0]
    for s, e in spans:               # union of the kernels' intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    span_ms = (end - spans[0][0]) / 1e3
    kernel_ms = sum(t for t, _ in by_name.values())
    k1 = [(t, n) for name, (t, n) in by_name.items() if "swin_attn" in name]
    k1_ms = sum(t for t, _ in k1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"  forward bf16, {B} windows of 256x256: {ms:.3f} ms (CUDA events); "
        f"traced: kernels {kernel_ms:.3f} ms over a {span_ms:.3f} ms span, "
        f"device idle {(1 - busy_us / 1e3 / span_ms) * 100:.1f}%; K1 "
        f"{k1_ms:.3f} ms in {sum(n for _, n in k1)} launches = "
        f"{k1_ms / kernel_ms * 100:.1f}% of kernel time")
    for name, (t, n) in top:
        log(f"    {t:9.3f} ms {n:4d}x {name[:90]}")
    return dict(ms=ms, kernel_ms=kernel_ms, span_ms=span_ms,
                idle_share=1 - busy_us / 1e3 / span_ms, k1_ms=k1_ms,
                k1_launches=sum(n for _, n in k1),
                top=[dict(name=k[:90], ms=t, count=n) for k, (t, n) in top])


def main_path(result: dict) -> None:
    from PIL import Image

    from cvcs_tpu_torch.cli import serve as serve_cli
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.models import swin as swin_mod
    from cvcs_tpu_torch.ops import swin_attn

    cfg = InferenceConfig(patch_size=224, border_correction=256,
                          batch_tiles=128, num_classes=16)
    model, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.bfloat16)
    seg = SceneSegmenter(model, cfg)
    scene = synthetic_scene(6800, 7200, seed=1)
    seg.predict_scene(scene[:1792, :2240])          # warm-up, not counted
    torch.cuda.synchronize()

    swin_attn.launches = 0
    t0 = time.perf_counter()
    labels = seg.predict_scene(scene)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = swin_attn.launches
    forwards = math.ceil(960 / 128)
    lab = labels.cpu().numpy()
    classes = np.unique(lab)
    log(f"  predict_scene 6800x7200x3 bf16: labels {lab.shape} {lab.dtype},"
        f" {len(classes)} classes, 960 tiles in {secs:.2f} s = "
        f"{960 / secs:.1f} tiles/s; K1 launches {launches} "
        f"(expected 12 x {forwards} forwards)")
    assert lab.shape == (6720, 7168) and lab.dtype == np.uint8
    assert classes.max() < 16 and len(classes) > 1
    assert launches == 12 * forwards, launches
    result["launches"] = launches
    result["scene_tiles_per_s"] = 960 / secs

    with tempfile.TemporaryDirectory() as tmp:
        watch = Path(tmp) / "in"
        watch.mkdir()
        rasters = [synthetic_scene(1792, 2240, seed=10 + i) for i in range(3)]
        for i, r in enumerate(rasters):
            Image.fromarray(r).save(watch / f"r{i}.png")
        swin_attn.launches = 0
        t0 = time.perf_counter()
        n = serve_cli.serve(dict(
            watch_dir=str(watch), net="SwinUnet", patch_size=224,
            border_correction=256, batch_tiles=128, num_classes=15,
            precision="bf16", max_polls=1, poll_s=0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        serve_launches = swin_attn.launches
        out = watch / "output"
        entries = [json.loads(x) for x in
                   (out / "manifest.jsonl").read_text().splitlines()]
        batch_s = entries[0]["batch_seconds"]
        log(f"  serve: {n} rasters 1792x2240 in {secs:.2f} s (model build "
            f"included); batch of {entries[0]['batch']} segmented + written "
            f"in {batch_s:.2f} s = {n / batch_s:.2f} rasters/s; K1 launches "
            f"{serve_launches} (expected 12 x 2 forwards)")
        assert n == 3 and len(entries) == 3
        assert all("error" not in e for e in entries)
        assert serve_launches == 12 * math.ceil(3 * 80 / 128)
        # the served mask is the palette of this model's labels (same seed)
        from cvcs_tpu_torch.data.palette import PALETTE

        mask = np.asarray(Image.open(out / "r0_mask.png"))
        want = PALETTE[seg.predict_scene(rasters[0]).cpu().numpy()]
        agree = float((mask == want).all(-1).mean())
        log(f"  serve mask r0 vs predict_scene: {agree * 100:.4f}% pixels "
            "agree")
        assert mask.shape == (1792, 2240, 3) and agree >= 0.99
        result["serve_launches"] = serve_launches
        result["serve_rasters_per_s"] = n / batch_s
    result["forward"] = forward_breakdown(model)
    del model, seg, labels
    torch.cuda.empty_cache()

    # f32: the kernel vs the plain attention through the whole model
    model32, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.float32)
    seg32 = SceneSegmenter(model32, cfg)
    swin_attn.launches = 0
    lab_kernel = seg32.predict_scene(scene).cpu().numpy()
    assert swin_attn.launches == 12 * forwards
    swin_mod.swin_window_attention = swin_attn.swin_window_attention_plain
    try:
        lab_plain = seg32.predict_scene(scene).cpu().numpy()
    finally:
        swin_mod.swin_window_attention = swin_attn.swin_window_attention
    agree = float((lab_kernel == lab_plain).mean())
    log(f"  f32 scene, kernel vs plain attention: {agree * 100:.4f}% of "
        f"{lab_kernel.size} pixels agree "
        f"({int((lab_kernel != lab_plain).sum())} differ)")
    assert agree >= 0.999
    result["f32_agreement"] = agree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from cvcs_tpu_torch.ops import _build, swin_attn

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = gpu_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    kernels = {"swin_attn": swin_attn}
    secs = _build.build(list(kernels))
    for name in kernels:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2] built {name}.cu for sm_90a in {secs.get(name, 0):.1f} s: "
            + " | ".join(ptxas))

    log("[3] kernels vs plain versions on the card")
    k1_err = check_k1()

    log("[4] main path")
    result: dict = {}
    main_path(result)

    log("[5] times (CUDA events, mean of 10 after 2 warm-up)")
    k1_times = time_k1()

    meta = swin_attn.KERNEL
    line = {"kernels": [dict(
        name=meta["name"], route=meta["route"], source=meta["source"],
        replaces=meta["replaces"], launches=result["launches"],
        max_abs_err=k1_err,
        ms=k1_times["total"]["ms"], plain_ms=k1_times["total"]["plain_ms"],
        bound_ms=k1_times["total"]["bound_ms"],
        bound_by=("bytes" if k1_times["total"]["bytes_ms"]
                  > k1_times["total"]["ops_ms"] else "operations"),
        library_ms=k1_times["total"]["library_ms"],
        library="composite: F.layer_norm + F.linear + "
                "F.scaled_dot_product_attention + F.linear",
        per="one SwinUnet forward at bc 256, 128 windows (12 launches)",
        per_case=k1_times["per_case"])],
        "scene_tiles_per_s": result["scene_tiles_per_s"],
        "serve_rasters_per_s": result["serve_rasters_per_s"],
        "serve_launches": result["serve_launches"],
        "forward": result["forward"],
        "f32_label_agreement": result["f32_agreement"],
        "seconds": time.perf_counter() - t_start}
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
