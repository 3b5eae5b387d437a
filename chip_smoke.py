#!/usr/bin/env python3
"""Drive the PyTorch port (``cvcs_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the main paths, one ``nvcc`` each, in
   parallel, into ``build/kernels/``;
3. kernels vs their plain PyTorch versions on the card, at the shapes the
   main paths give them (bf16 and f32 instances), within stated
   tolerances: K1 (window-attention forward) at the serving shapes, K2
   (its backward) at the p-224 training stage shapes, K5 (fused
   augmentation) on a training chunk, K3 and K4 (fused weighted
   cross-entropy forward sums and backward) at the Unetv2 recipe step's
   logits and at a ragged size, with K3's repeats bit-equal;
4. the serving path: full-width SwinUnet (random weights from a fixed
   seed) segments one full-size 6800 x 7200 GID15-like scene
   (``predict_scene``, p 224, border correction 256, 128 windows per
   forward, bf16) and the serve daemon drains three 1792 x 2240 rasters;
   the launch counters must show every kernel ran; the same scene under
   the f32 policy through the kernel and through the plain attention
   must give the same labels on >= 99.9% of pixels; one forward of 128
   windows is timed and traced (torch.profiler) for where its time goes.
   Then full-width Unetv2, the serve recipe's model, segments the same
   scene (the recipe's two-by-four mesh cut to one card);
5. the training path: ``python -m cvcs_tpu_torch.cli.train``'s ``main``
   trains full-width SwinUnet with the recipe's geometry (p 224, batch
   10, wCEL with ignore_background, SGD2, bf16, random_shift,
   ``augmentation: fused``) for 2 epochs on a synthetic dataset (2 train
   scenes of 1792 x 2240, 160 patches per chunk, 1 validation scene),
   then resumes from the epoch-1 checkpoint; the counters must show K1
   and K2 12 times per step and K5 once per chunk; a few steps are timed
   (CUDA events) and traced for the share of each kernel. Then the
   canonical Unetv2 recipe (``configs/train_unetv2.yaml``: the same
   geometry with ``augmentation: True``) the same way, and one epoch of a
   ``Trainer`` built the same way with ``build_fused_ce`` as its loss: K3
   once per train step and per validation batch, K4 once per train step;
6. training correctness: one f32 SwinUnet train step through the kernels
   and one through the plain versions (called directly by this script)
   from the same weights and batch agree; a 30-step bf16 fixed-batch
   overfit lowers the loss; one f32 Unetv2 step through K3/K4 and one
   through the eager wCEL agree, parameter updates included (a loss that
   passes half its gradient must not); a Unetv2 step with ``remat`` equals one
   without, BN statistics updated once, and both peak memories print;
7. times (CUDA events, after warm-up; K3 and K4 also their traced device
   time) of each kernel beside its bound, its plain version and a library
   yardstick.

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
B = 128                            # windows per forward on the serving path
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


# -- K2: Swin window attention backward ----------------------------------------
B_TRAIN = 10                       # patches per training step (the recipe)
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # x max(1, |plain|max)
# (name, Hp = Wp, C, heads, win, h0 = w0, shift): K2 at the four stage
# shapes of a p-224 training step (56 unpadded, 28 -> 32, 14 -> 16, one
# 7 x 7 window), shifted and unshifted, plus a pad-masked 56 -> 64 map
K2_CASES = [
    ("s1", 56, 96, 3, 8, 56, 0), ("s1_shift", 56, 96, 3, 8, 56, 4),
    ("s2", 32, 192, 6, 8, 28, 0), ("s2_shift", 32, 192, 6, 8, 28, 4),
    ("s3", 16, 384, 12, 8, 14, 0), ("s3_shift", 16, 384, 12, 8, 14, 4),
    ("s4", 7, 768, 24, 7, 7, 0), ("pad56", 64, 96, 3, 8, 56, 0),
]
# K2 (and K1) launches of one SwinUnet train step at p 224: (case, launches)
K2_PER_STEP = [("s1", 1), ("s1_shift", 1), ("s2", 1), ("s2_shift", 1),
               ("s3", 3), ("s3_shift", 3), ("s4", 2)]
GRADS = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwout", "dbout")


def k2_inputs(case, dtype, seed=0):
    from cvcs_tpu_torch.models.swin import attn_bias

    _, hp, c, heads, win, h0, shift = case
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).cuda()

    args = [rnd(B_TRAIN, hp, hp, c).to(dtype), 1 + rnd(c, std=0.1),
            rnd(c, std=0.1), rnd(c, 3 * c, std=c ** -0.5),
            rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, hp, h0, h0, win, shift, args[0].device)
    cot = rnd(B_TRAIN, hp, hp, c).to(dtype)
    return args, bias, cot, dict(win=win, heads=heads)


def k2_bound(case, dtype, masked: bool) -> tuple[float, float]:
    """(ms of the bytes at the memory rate, ms of the operations at the
    peak rate): x and g read, dx written, the weights read, the six f32
    gradients written, the mask read; 22 N C^2 + 12 N T C operations."""
    _, hp, c, _, win, _, _ = case
    s = torch.finfo(dtype).bits // 8
    n = B_TRAIN * hp * hp
    t = win * win
    nwin = (hp // win) ** 2
    nbytes = (3 * n * c * s + (4 * c * c + 4 * c) * s + 2 * c * 4
              + (4 * c * c + 6 * c) * 4 + (nwin * t * t * 4 if masked else 0))
    flops = 22 * n * c * c + 12 * n * t * c
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def check_k2() -> tuple[float, float]:
    """K2 vs its plain version at every case, bf16 and f32, all seven
    outputs; returns the largest bf16 abs error and the largest bf16
    error over its scale at the training stage shapes."""
    from cvcs_tpu_torch.ops import swin_attn

    worst, worst_scaled = 0.0, 0.0
    for case in K2_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            args, bias, cot, kw = k2_inputs(case, dtype)
            got = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
            torch.cuda.synchronize()
            want = swin_attn.swin_window_attention_bwd_plain(*args, bias, cot,
                                                             **kw)
            torch.cuda.synchronize()
            errs = []
            for name, a, w in zip(GRADS, got, want):
                scale = max(1.0, w.float().abs().max().item())
                err = (a.float() - w.float()).abs().max().item()
                ok = (err <= TOL_BWD[dtype] * scale
                      and bool(torch.isfinite(a).all()) and a.dtype == w.dtype)
                if not ok:
                    raise AssertionError(f"K2 {case[0]} {dtype} {name}: "
                                         f"{err} > {TOL_BWD[dtype]} * {scale}")
                errs.append((err, err / scale))
            e, es = max(x for x, _ in errs), max(y for _, y in errs)
            log(f"  K2 {case[0]:>9} {str(dtype)[6:]:>8} B={B_TRAIN} "
                f"Hp={case[1]} C={case[2]} heads={case[3]} win={case[4]} "
                f"mask={'none' if bias is None else 'yes'}: 7 outputs, max "
                f"abs err {e:.3e}, max err/scale {es:.2e} (tol "
                f"{TOL_BWD[dtype]:.0e}) ok")
            if dtype == torch.bfloat16 and case[0].startswith("s"):
                worst, worst_scaled = max(worst, e), max(worst_scaled, es)
            del args, got, want
    return worst, worst_scaled


def k2_library(args, bias, cot, kw):
    """Yardstick the port never calls: autograd backward through the
    composite F.layer_norm + F.linear + F.scaled_dot_product_attention +
    F.linear forward (the graph is built once, then replayed)."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = k1_library(*leaves, bias, **kw)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def time_k2() -> dict:
    """Per-case times (bf16, the training path) and per-step totals."""
    from cvcs_tpu_torch.ops import swin_attn

    cases = {c[0]: c for c in K2_CASES}
    rows = {}
    for name, _ in K2_PER_STEP:
        args, bias, cot, kw = k2_inputs(cases[name], torch.bfloat16)
        before = swin_attn.bwd_launches
        r = rows[name] = dict(
            ms=cuda_ms(lambda: swin_attn._bwd_kernel_launch(
                *args, bias, cot, **kw)),
            plain_ms=cuda_ms(lambda: swin_attn.swin_window_attention_bwd_plain(
                *args, bias, cot, **kw)),
            library_ms=cuda_ms(k2_library(args, bias, cot, kw)))
        r["bytes_ms"], r["ops_ms"] = k2_bound(cases[name], torch.bfloat16,
                                              bias is not None)
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        swin_attn.bwd_launches = before  # timing launches are not the path's
        log(f"  K2 {name:>9} bf16: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, composite library backward "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"(bytes {r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; "
            f"kernel at {r['bound_ms'] / r['ms'] * 100:.2f}% of bound)")
        del args
    total = {k: sum(rows[n][k] * cnt for n, cnt in K2_PER_STEP)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                       "ops_ms")}
    log(f"  K2 per train step (12 launches, bf16, B={B_TRAIN}): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, composite "
        f"library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.4f} ms")
    return dict(total=total, per_case=rows)


# -- K5: fused augmentation ------------------------------------------------------
B_CHUNK = 160                      # patches of one training chunk


def k5_inputs(c, seed=0):
    from cvcs_tpu_torch.ops import augment

    g = torch.Generator(device="cuda").manual_seed(seed + c)
    img = torch.randint(0, 256, (B_CHUNK, 224, 224, c), generator=g,
                        device="cuda", dtype=torch.uint8)
    flips, rots, factors = augment.draw_dihedral(B_CHUNK, 0.6, g)
    mean = torch.linspace(60.0, 120.0, c, device="cuda")
    std = torch.linspace(30.0, 70.0, c, device="cuda")
    return img, flips, rots, factors, mean, std


def k5_library(img, flips, rots, factors, mean, std):
    """Yardstick the port never calls: the same function from library
    calls, torch.flip / torch.rot90 on each group of patches that share
    a (flip, rot90) draw, then the contrast and normalisation ops."""
    x = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    key = flips.long() * 4 + rots.long()
    for k in range(16):
        idx = (key == k).nonzero().flatten()
        part = img.index_select(0, idx).float()
        if k // 4 & 1:
            part = torch.flip(part, (2,))
        if k // 4 & 2:
            part = torch.flip(part, (1,))
        x.index_copy_(0, idx, torch.rot90(part, k % 4, (1, 2)))
    gray = 0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    m = torch.floor(gray).mean((1, 2)).view(-1, 1, 1, 1)
    f = factors.view(-1, 1, 1, 1)
    x = torch.floor(torch.clamp(f * x + (1 - f) * m, 0, 255))
    return (x - mean) / std


def check_k5() -> float:
    """K5 vs its plain version on a training chunk, C 3 and 4, with a
    non-identity band mean/std: equal elements except near floor
    boundaries (>= 99.9% equal, the rest within 1/std)."""
    from cvcs_tpu_torch.ops import augment

    worst = 0.0
    for c in (3, 4):
        args = k5_inputs(c)
        got = augment.fused_augment(*args)
        torch.cuda.synchronize()
        want = augment.fused_augment_plain(*args)
        lib = k5_library(*args)
        err = (got - want).abs().max().item()
        equal = (got == want).float().mean().item()
        ok = (equal >= 0.999 and bool(((got - want).abs()
                                       <= 1 / args[5] + 1e-6).all())
              and torch.equal(lib, want))
        log(f"  K5 B={B_CHUNK} P=224 C={c}: {equal * 100:.4f}% elements equal"
            f" to plain, max abs err {err:.3e}; library composite equal to "
            f"plain: {torch.equal(lib, want)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 C={c}: {equal} equal, err {err}")
        worst = max(worst, err)
    return worst


def time_k5() -> dict:
    from cvcs_tpu_torch.ops import augment

    args = k5_inputs(3)
    before = augment.launches
    r = dict(ms=cuda_ms(lambda: augment.fused_augment(*args)),
             plain_ms=cuda_ms(lambda: augment.fused_augment_plain(*args)),
             library_ms=cuda_ms(lambda: k5_library(*args)))
    augment.launches = before
    nbytes = B_CHUNK * 224 * 224 * 3 * (1 + 4)
    r["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    r["ops_ms"] = B_CHUNK * 224 * 224 * 3 * 12 / PEAK_FLOPS[torch.float32] * 1e3
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    log(f"  K5 B={B_CHUNK} P=224 C=3: kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, library composite {r['library_ms']:.3f} ms,"
        f" bound {r['bound_ms']:.4f} ms (bytes; kernel at "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of bound)")
    return r


# -- K3 / K4: fused weighted cross-entropy --------------------------------
NC = 16                            # GID15's 15 classes + background
# (batch, H, W): the Unetv2 recipe step's logits, and a ragged N
# (3 x 97 x 113 = 32,883 pixels) that is not a multiple of the block size
CE_SHAPES = {"step": (B_TRAIN, 224, 224), "ragged": (3, 97, 113)}
TOL_CE = 1e-5                      # relative; x max(1, |plain|max) for dlogits
TOL_UPDATE = 5e-2                  # a parameter update vs the eager step's


def ce_inputs(shape, seed=0):
    """f32 logits (N, 16), int32 labels with ~30% class 0 (ignored), 1%
    void 255 and the rest uniform, and the recipe's class weights
    (``class_weights`` of the labels' counts, background ignored)."""
    from cvcs_tpu_torch.data.reader import class_weights
    from cvcs_tpu_torch.ops import fused_ce

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(*shape, NC, generator=g) * 3
    labels = torch.randint(1, NC, shape, generator=g, dtype=torch.int32)
    u = torch.rand(shape, generator=g)
    labels[u < 0.3] = 0
    labels[u > 0.99] = 255
    valid = labels[labels < NC].numpy()
    w = fused_ce.effective_weights(
        class_weights(np.bincount(valid.ravel(), minlength=NC), True), NC,
        0, "cuda")
    return logits.reshape(-1, NC).cuda(), labels.reshape(-1).cuda(), w


def check_k3k4() -> dict:
    """K3 and K4 vs their plain versions at both shapes (f32): loss_sum,
    wsum and the loss within 1e-5 relative; dlogits within
    1e-5 * max(1, |plain|max) and, because dlogits of a mean over 5e5
    pixels are ~1e-6, within 1e-5 * |plain|max too; K3's repeats
    bit-equal."""
    from cvcs_tpu_torch.ops import fused_ce

    out = dict(k3_err=0.0, k4_err=0.0, k4_rel=0.0)
    for name, shape in CE_SHAPES.items():
        x, lab, w = ce_inputs(shape)
        loss_sum, wsum, loss = fused_ce._fwd_launch(x, lab, w)
        g = torch.ones((), device="cuda")
        dx = fused_ce._bwd_launch(x, lab, w, g, wsum)
        torch.cuda.synchronize()
        want_sum, want_w = fused_ce.ce_sums_plain(x, lab, w)
        want_dx = fused_ce.ce_grad_plain(x, lab, w,
                                         g / want_w.clamp(min=1e-12))
        rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in
               ((loss_sum, want_sum), (wsum, want_w),
                (loss, want_sum / want_w))]
        err = float((dx - want_dx).abs().max())
        big = float(want_dx.abs().max())
        repeats = [fused_ce._fwd_launch(x, lab, w) for _ in range(2)]
        bit_equal = all(torch.equal(a, b) for r in repeats
                        for a, b in zip(r, (loss_sum, wsum, loss)))
        ok = (max(rel) <= TOL_CE and err <= TOL_CE * max(1.0, big)
              and err <= TOL_CE * big and bit_equal
              and bool(torch.isfinite(dx).all()))
        n = x.shape[0]
        log(f"  K3 {name:>6} N={n} C={NC}: loss {float(loss):.6f} vs plain "
            f"{float(want_sum / want_w):.6f}; relative errors loss_sum "
            f"{rel[0]:.2e}, wsum {rel[1]:.2e}, loss {rel[2]:.2e} (tol "
            f"{TOL_CE:.0e}); 3 runs bit-equal: {bit_equal}")
        log(f"  K4 {name:>6} N={n} C={NC}: dlogits max abs err {err:.3e}, "
            f"|plain|max {big:.3e}, err/|plain|max {err / big:.2e} (tol "
            f"{TOL_CE:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3/K4 {name}: {rel}, {err}, {bit_equal}")
        out["k3_err"] = max(out["k3_err"], abs(float(loss) - float(
            want_sum / want_w)))
        out["k4_err"] = max(out["k4_err"], err)
        out["k4_rel"] = max(out["k4_rel"], err / big)
        del x, lab, dx, want_dx
    return out


def ce_library(x, lab, w):
    """Yardstick the port never calls: ``F.cross_entropy`` on NCHW logits
    with ``weight`` and ``ignore_index=0`` (void labels mapped to the
    ignored 0, which it needs in range); returns (forward, backward)
    callables, the backward an autograd replay of the forward's graph."""
    b, h, wd = CE_SHAPES["step"]
    valid = (lab >= 0) & (lab < NC)
    lib_lab = torch.where(valid, lab, 0).long().view(b, h, wd)

    def fwd(t):
        return F.cross_entropy(t.view(b, h, wd, NC).permute(0, 3, 1, 2),
                               lib_lab, weight=w, ignore_index=0)

    leaf = x.detach().clone().requires_grad_()
    loss = fwd(leaf)
    return (lambda: fwd(x),
            lambda: torch.autograd.grad(loss, leaf, retain_graph=True))


def time_k3k4() -> tuple[dict, dict]:
    """K3 and K4 at the recipe step's shape: kernel (CUDA events, and the
    device time of a traced loop), plain and library times; bound from
    the bytes the function needs (each input it uses read once, each
    output written once) and its f32 operations (about 5 per logit read
    for K3, 8 for K4). A pixel of weight 0 (the ignored class,
    void) adds nothing to the loss and has a zero dlogits row: its logits
    are not needed, so the bound counts the logits of this run's
    nonzero-weight pixels only, and every label."""
    from cvcs_tpu_torch.ops import fused_ce

    before = fused_ce.launches, fused_ce.bwd_launches
    x, lab, w = ce_inputs(CE_SHAPES["step"], seed=1)
    g = torch.ones((), device="cuda")
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    scale = g / wsum.clamp(min=1e-12)
    lib_fwd, lib_bwd = ce_library(x, lab, w)
    k3 = dict(ms=cuda_ms(lambda: fused_ce._fwd_launch(x, lab, w)),
              plain_ms=cuda_ms(lambda: fused_ce.ce_sums_plain(x, lab, w)),
              library_ms=cuda_ms(lib_fwd))
    k4 = dict(ms=cuda_ms(lambda: fused_ce._bwd_launch(x, lab, w, g, wsum)),
              plain_ms=cuda_ms(lambda: fused_ce.ce_grad_plain(x, lab, w,
                                                              scale)),
              library_ms=cuda_ms(lib_bwd))
    for r, key, fn in (
            (k3, "K3", lambda: fused_ce._fwd_launch(x, lab, w)),
            (k4, "K4", lambda: fused_ce._bwd_launch(x, lab, w, g, wsum))):
        # the events time of a back-to-back loop includes the wrapper's
        # host cost; the trace gives the kernels' own device time
        r["device_ms"] = device_profile(
            lambda: [fn() for _ in range(10)])[key] / 10
    lib_loss = float(lib_fwd())
    k3_loss = float(fused_ce._fwd_launch(x, lab, w)[2])
    fused_ce.launches, fused_ce.bwd_launches = before  # not the path's
    log(f"  F.cross_entropy's loss {lib_loss:.6f}, K3's {k3_loss:.6f}")
    assert abs(lib_loss - k3_loss) <= TOL_CE * abs(lib_loss)
    n = x.shape[0]
    valid = (lab >= 0) & (lab < NC)
    n_w = int((torch.where(valid, w[lab.clamp(0, NC - 1).long()], 0.0)
               != 0).sum())
    read_bytes = n_w * NC * 4 + n * 4 + NC * 4      # logits, labels, w
    for r, nbytes, ops in ((k3, read_bytes, 5 * n_w * NC),
                           (k4, read_bytes + n * NC * 4, 8 * n_w * NC)):
        r["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        r["ops_ms"] = ops / PEAK_FLOPS[torch.float32] * 1e3
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        r["bound_bytes"] = nbytes
    log(f"  pixels of nonzero weight: {n_w} of {n} ({n_w / n * 100:.2f}%); "
        f"bytes needed: K3 {k3['bound_bytes']}, K4 {k4['bound_bytes']}")
    for name, r in (("K3", k3), ("K4", k4)):
        log(f"  {name} N={n} C={NC} f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, F.cross_entropy "
            f"{'forward' if name == 'K3' else 'backward'} "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes "
            f"{r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; kernel at "
            f"{r['bound_ms'] / r['ms'] * 100:.1f}% of bound); device time "
            f"per launch {r['device_ms']:.4f} ms (traced, "
            f"{r['bound_ms'] / r['device_ms'] * 100:.1f}% of bound)")
    return k3, k4


# -- the serving path ----------------------------------------------------------
def synthetic_scene(h, w, seed):
    """Blocky uint8 scene with texture: labels vary across it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w] // 2
    return img + rng.integers(0, 64, (h, w, 3), np.uint8)


# cuDNN / cuBLAS kernel names: the convolutions (and GEMMs) of a trace
CONV_NAMES = ("xmma", "cudnn", "conv", "gemm", "cutlass")


def device_profile(fn) -> dict:
    """Run ``fn`` under torch.profiler: device time by kernel name, the
    span from the first kernel's start to the last one's end, and the
    device's idle share of that span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        # user annotations (e.g. the optimizer step's range) span kernels
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
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

    def ms_of(key):
        return sum(t for name, (t, _) in by_name.items() if key in name)

    conv_ms = sum(t for name, (t, _) in by_name.items()
                  if any(k in name for k in CONV_NAMES) and "swin" not in name)
    return dict(by_name=by_name, span_ms=span_ms, conv_ms=conv_ms,
                kernel_ms=sum(t for t, _ in by_name.values()),
                idle_share=1 - busy_us / 1e3 / span_ms,
                K1=ms_of("swin_attn_fwd"), K2=ms_of("swin_bwd_"),
                K3=ms_of("::ce_fwd_"), K4=ms_of("::ce_bwd"),
                K5=ms_of("augment_kernel"))


def forward_breakdown(model, name: str = "SwinUnet") -> dict:
    """Where one forward's time goes: a forward of B bc-256 windows timed
    with CUDA events, then traced once with torch.profiler for the device
    time of each kernel and the device's idle share."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (B, 256, 256, 3), generator=g,
                      dtype=torch.uint8).cuda().float()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        prof = device_profile(lambda: model(x))
    by_name = prof["by_name"]
    k1_launches = sum(n for k, (_, n) in by_name.items()
                      if "swin_attn_fwd" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    k1 = (f"; K1 {prof['K1']:.3f} ms in {k1_launches} launches = "
          f"{prof['K1'] / prof['kernel_ms'] * 100:.1f}% of kernel time"
          if k1_launches else "")
    log(f"  {name} forward bf16, {B} windows of 256x256: {ms:.3f} ms (CUDA "
        f"events); traced: kernels {prof['kernel_ms']:.3f} ms over a "
        f"{prof['span_ms']:.3f} ms span, device idle "
        f"{prof['idle_share'] * 100:.1f}%{k1}; convolutions and GEMMs "
        f"{prof['conv_ms']:.3f} ms = "
        f"{prof['conv_ms'] / prof['kernel_ms'] * 100:.1f}%")
    for k, (t, n) in top:
        log(f"    {t:9.3f} ms {n:4d}x {k[:90]}")
    return dict(ms=ms, kernel_ms=prof["kernel_ms"], span_ms=prof["span_ms"],
                idle_share=prof["idle_share"], conv_ms=prof["conv_ms"],
                k1_ms=prof["K1"],
                k1_launches=k1_launches,
                top=[dict(name=k[:90], ms=t, count=n) for k, (t, n) in top])


def main_path(result: dict):
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
    return scene


def unet_scene(result: dict, scene) -> None:
    """Full-width Unetv2, the serve recipe's model (``configs/serve.yaml``:
    p 224, border correction 256, bf16; its two-by-four mesh cut to one
    card), segments the full-size scene; one forward is traced."""
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model

    cfg = InferenceConfig(patch_size=224, border_correction=256,
                          batch_tiles=128, num_classes=16)
    model, _ = build_model("Unetv2", 16, seed=0, dtype=torch.bfloat16)
    seg = SceneSegmenter(model, cfg)
    seg.predict_scene(scene[:1792, :2240])          # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    labels = seg.predict_scene(scene)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lab = labels.cpu().numpy()
    classes = np.unique(lab)
    log(f"  Unetv2 predict_scene 6800x7200x3 bf16: labels {lab.shape} "
        f"{lab.dtype}, {len(classes)} classes, 960 tiles in {secs:.2f} s = "
        f"{960 / secs:.1f} tiles/s; hand-written kernel launches "
        f"{kernel_counts()} (none on this path)")
    assert lab.shape == (6720, 7168) and lab.dtype == np.uint8
    assert classes.max() < 16 and len(classes) > 1
    assert not any(kernel_counts().values())
    result["unet_scene_tiles_per_s"] = 960 / secs
    result["unet_forward"] = forward_breakdown(model, "Unetv2")
    del model, seg, labels
    torch.cuda.empty_cache()


# -- the training path -----------------------------------------------------------
TRAIN_EPOCHS = 2
STEPS_PER_EPOCH = 16               # 2 scenes x 80 tiles / batch 10
VAL_BATCHES, EVAL_BATCHES = 8, 10  # 80 validation patches / 10, / 8


def synthetic_dataset(root: Path, n: int, seed: int) -> str:
    """GID15-layout dataset of n 1792 x 2240 scenes with blocky labels."""
    from PIL import Image

    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(synthetic_scene(1792, 2240, seed + i)).save(
            root / "Image__8bit_NirRGB" / f"s{i}.png")
        labels = np.kron(rng.integers(0, 16, (56, 70), dtype=np.uint8),
                         np.ones((32, 32), np.uint8))
        Image.fromarray(labels).save(
            root / "Annotation__index" / f"s{i}_15label.png")
    return str(root)


def kernel_counts() -> dict:
    from cvcs_tpu_torch.ops import augment, fused_ce, swin_attn

    return dict(K1=swin_attn.launches, K2=swin_attn.bwd_launches,
                K3=fused_ce.launches, K4=fused_ce.bwd_launches,
                K5=augment.launches)


def reset_counts() -> None:
    from cvcs_tpu_torch.ops import augment, fused_ce, swin_attn

    swin_attn.launches = swin_attn.bwd_launches = augment.launches = 0
    fused_ce.launches = fused_ce.bwd_launches = 0


def train_breakdown(trainer, name: str = "SwinUnet") -> dict:
    """Where a train step's time goes: the mean step timed with CUDA
    events; four steps on a ready chunk traced (kernel shares, device idle
    share); one chunk's load and augmentation traced; and K5's share of a
    whole chunk cycle (its load plus its 16 steps)."""
    from cvcs_tpu_torch.train.step import train_step

    state, loss_fn, loader = trainer.state, trainer.loss_fn, trainer.train_loader
    chunk = loader.get_chunk(0)
    batches = list(chunk.batches(B_TRAIN))
    step_ms = cuda_ms(lambda: train_step(state, loss_fn, batches[0].image,
                                         batches[0].mask), iters=5, warmup=1)
    steps = device_profile(lambda: [train_step(state, loss_fn, b.image, b.mask)
                                    for b in batches[1:5]])
    load = device_profile(lambda: loader.get_chunk(0))
    kernels = ("K1", "K2", "K3", "K4")
    per_step = {k: steps[k] / 4 for k in ("kernel_ms", "conv_ms") + kernels}
    cycle_ms = load["kernel_ms"] + STEPS_PER_EPOCH * per_step["kernel_ms"]
    shares = {k: per_step[k] / per_step["kernel_ms"] for k in kernels}
    shares["K5_of_chunk_cycle"] = load["K5"] / cycle_ms
    shares["conv"] = per_step["conv_ms"] / per_step["kernel_ms"]
    mine = "".join(f", {k} {per_step[k]:.3f} ms = {shares[k] * 100:.2f}%"
                   for k in kernels if per_step[k])
    log(f"  {name} train step bf16 B={B_TRAIN} p 224: {step_ms:.3f} ms (CUDA "
        f"events, mean of 5); 4 steps traced: kernels "
        f"{per_step['kernel_ms']:.3f} ms per step over a "
        f"{steps['span_ms'] / 4:.3f} ms span, device idle "
        f"{steps['idle_share'] * 100:.1f}%; of kernel time: convolutions and "
        f"GEMMs {per_step['conv_ms']:.3f} ms = {shares['conv'] * 100:.1f}%"
        f"{mine}")
    log(f"  chunk load + augmentation traced: kernels {load['kernel_ms']:.3f}"
        f" ms (K5 {load['K5']:.3f} ms) over a {load['span_ms']:.3f} ms span,"
        f" device idle {load['idle_share'] * 100:.1f}%; K5 = "
        f"{shares['K5_of_chunk_cycle'] * 100:.2f}% of a chunk cycle's kernel"
        f" time")
    top = sorted(steps["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    for k, (t, n) in top:
        log(f"    {t / 4:9.3f} ms {n // 4:4d}x per step  {k[:80]}")
    return dict(step_ms=step_ms, step_kernel_ms=per_step["kernel_ms"],
                step_conv_ms=per_step["conv_ms"],
                step_span_ms=steps["span_ms"] / 4,
                step_idle_share=steps["idle_share"],
                **{f"{k}_ms_per_step": per_step[k] for k in kernels},
                chunk_load_kernel_ms=load["kernel_ms"],
                chunk_load_span_ms=load["span_ms"], K5_ms=load["K5"],
                shares=shares,
                top=[dict(name=k[:90], ms_per_step=t / 4, count=n // 4)
                     for k, (t, n) in top])


def train_path(result: dict) -> None:
    """Train through the CLI's entry point, check the counts, resume."""
    import yaml

    from cvcs_tpu_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = dict(
            train=synthetic_dataset(tmp / "train", 2, seed=20),
            validation=synthetic_dataset(tmp / "val", 1, seed=30),
            checkpoint_directory=str(tmp / "ckpt"), device="gpu",
            net="SwinUnet", epochs=TRAIN_EPOCHS, chunk_size=2,
            validation_chunk_size=1, patch_size=224, batch_size=B_TRAIN,
            loss="wCEL", opt="SGD2", ignore_background=True,
            random_shift=True, augmentation="fused", freq=1,
            precision_evaluation_freq=1, num_classes=15, verbose=True,
            precision="bf16", seed=0, metrics_log=str(tmp / "metrics.jsonl"))
        path = tmp / "train.yaml"
        path.write_text(yaml.safe_dump(cfg))
        reset_counts()
        t0 = time.perf_counter()
        rc = train_cli.main(["train", str(path)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        k1, k2, k5 = counts["K1"], counts["K2"], counts["K5"]
        assert rc == 0, rc
        assert counts["K3"] == counts["K4"] == 0       # the eager wCEL
        steps = TRAIN_EPOCHS * STEPS_PER_EPOCH
        want_k1 = 12 * (steps + TRAIN_EPOCHS * (VAL_BATCHES + EVAL_BATCHES))
        metrics = [json.loads(x) for x in
                   (tmp / "metrics.jsonl").read_text().splitlines()]
        meta = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}"
                           / "meta.json").read_text())
        losses = meta["training_loss_values"]
        log(f"  cli.train SwinUnet bf16, {TRAIN_EPOCHS} epochs x "
            f"{STEPS_PER_EPOCH} steps in {secs:.2f} s (model build, class "
            f"weights, validation and evaluation included); epoch 2: "
            f"{metrics[1]['patches_per_s']:.1f} patches/s over "
            f"{metrics[1]['epoch_s']:.2f} s; losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite: "
            f"{bool(np.isfinite(losses).all())}; validation losses "
            f"{[round(v, 4) for v in meta['validation_loss_values'][::8]]}")
        log(f"  launches: K1 {k1} (expected 12 x ({steps} steps + "
            f"{TRAIN_EPOCHS} x ({VAL_BATCHES} validation + {EVAL_BATCHES} "
            f"evaluation batches)) = {want_k1}), K2 {k2} (expected "
            f"{12 * steps}), K5 {k5} (expected {TRAIN_EPOCHS}, one per "
            f"chunk); per epoch: K1 {k1 // TRAIN_EPOCHS}, K2 "
            f"{k2 // TRAIN_EPOCHS}, K5 {k5 // TRAIN_EPOCHS}")
        assert (k1, k2, k5) == (want_k1, 12 * steps, TRAIN_EPOCHS)
        assert len(losses) == steps and np.isfinite(losses).all()
        assert np.isfinite(meta["validation_loss_values"]).all()
        assert len(meta["conf_flat"]) == TRAIN_EPOCHS
        result["train"] = dict(
            launches=dict(K1=k1, K2=k2, K5=k5), seconds=secs,
            patches_per_s_epoch2=metrics[1]["patches_per_s"],
            epoch2_s=metrics[1]["epoch_s"], first_loss=losses[0],
            last_loss=losses[-1])

        # resume from the epoch-1 checkpoint: epoch 2 again, histories go on
        cfg.update(load_checkpoint=str(tmp / "ckpt" / "checkpoint1"),
                   metrics_log=str(tmp / "resume.jsonl"))
        path.write_text(yaml.safe_dump(cfg))
        assert train_cli.main(["train", str(path)]) == 0
        again = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}"
                            / "meta.json").read_text())
        hist = again["training_loss_values"]
        log(f"  resumed from checkpoint1: {len(hist)} training losses, the "
            f"first {STEPS_PER_EPOCH} equal to the first run's: "
            f"{hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]}; epoch 2 "
            f"again {hist[STEPS_PER_EPOCH]:.4f} -> {hist[-1]:.4f}")
        assert len(hist) == steps and np.isfinite(hist).all()
        assert hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]

        trainer = train_cli.build_trainer(dict(cfg, load_checkpoint=None))
        result["train"]["breakdown"] = train_breakdown(trainer)
        del trainer
    torch.cuda.empty_cache()


def unet_train_path(result: dict) -> None:
    """The canonical Unetv2 recipe through the CLI's entry point (eager
    wCEL: no hand-written kernel runs), resumed; then one epoch of a
    ``Trainer`` built the same way with ``build_fused_ce`` as its loss,
    which must launch K3 once per train step and per validation batch and
    K4 once per train step."""
    import yaml

    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.ops import fused_ce
    from cvcs_tpu_torch.train.loop import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # configs/train_unetv2.yaml, on the synthetic set and 2 epochs
        cfg = dict(
            train=synthetic_dataset(tmp / "train", 2, seed=20),
            validation=synthetic_dataset(tmp / "val", 1, seed=30),
            checkpoint_directory=str(tmp / "ckpt"), device="gpu",
            net="Unetv2", epochs=TRAIN_EPOCHS, chunk_size=2,
            validation_chunk_size=1, patch_size=224, batch_size=B_TRAIN,
            loss="wCEL", opt="SGD2", ignore_background=True,
            random_shift=True, augmentation=True, freq=1,
            precision_evaluation_freq=1, num_classes=15, verbose=True,
            precision="bf16", seed=0, metrics_log=str(tmp / "metrics.jsonl"))
        path = tmp / "train.yaml"
        path.write_text(yaml.safe_dump(cfg))
        reset_counts()
        t0 = time.perf_counter()
        rc = train_cli.main(["train", str(path)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        assert rc == 0, rc
        steps = TRAIN_EPOCHS * STEPS_PER_EPOCH
        metrics = [json.loads(x) for x in
                   (tmp / "metrics.jsonl").read_text().splitlines()]
        meta = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}"
                           / "meta.json").read_text())
        losses = meta["training_loss_values"]
        log(f"  cli.train Unetv2 bf16, {TRAIN_EPOCHS} epochs x "
            f"{STEPS_PER_EPOCH} steps in {secs:.2f} s (model build, class "
            f"weights, validation and evaluation included); epoch 2: "
            f"{metrics[1]['patches_per_s']:.1f} patches/s over "
            f"{metrics[1]['epoch_s']:.2f} s; losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, all finite: "
            f"{bool(np.isfinite(losses).all())}; validation losses "
            f"{[round(v, 4) for v in meta['validation_loss_values'][::8]]}; "
            f"hand-written kernel launches {counts} (none: eager wCEL, "
            "reference augmentation)")
        assert not any(counts.values())
        assert len(losses) == steps and np.isfinite(losses).all()
        assert np.isfinite(meta["validation_loss_values"]).all()
        assert len(meta["conf_flat"]) == TRAIN_EPOCHS
        result["unet_train"] = dict(
            seconds=secs, patches_per_s_epoch2=metrics[1]["patches_per_s"],
            epoch2_s=metrics[1]["epoch_s"], first_loss=losses[0],
            last_loss=losses[-1])

        cfg.update(load_checkpoint=str(tmp / "ckpt" / "checkpoint1"),
                   metrics_log=str(tmp / "resume.jsonl"))
        path.write_text(yaml.safe_dump(cfg))
        assert train_cli.main(["train", str(path)]) == 0
        again = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}"
                            / "meta.json").read_text())
        hist = again["training_loss_values"]
        log(f"  resumed from checkpoint1: {len(hist)} training losses, the "
            f"first {STEPS_PER_EPOCH} equal to the first run's: "
            f"{hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]}; epoch 2 "
            f"again {hist[STEPS_PER_EPOCH]:.4f} -> {hist[-1]:.4f}")
        assert len(hist) == steps and np.isfinite(hist).all()
        assert hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]

        # one epoch with the fused loss: K3 / K4 on the path
        base = train_cli.build_trainer(dict(
            cfg, load_checkpoint=None, epochs=1,
            checkpoint_directory=str(tmp / "fused"),
            metrics_log=str(tmp / "fused.jsonl")))
        weights = base.train_loader.class_weights(NC, True)
        trainer = Trainer(base.spec, base.state,
                          fused_ce.build_fused_ce(weights,
                                                  ignore_background=True),
                          base.train_loader, base.val_loader, base.config)
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        fused_losses = trainer.training_loss_values
        want = (STEPS_PER_EPOCH + VAL_BATCHES, STEPS_PER_EPOCH)
        log(f"  Trainer(loss_fn=build_fused_ce) Unetv2 bf16, 1 epoch in "
            f"{secs:.2f} s: losses {fused_losses[0]:.4f} -> "
            f"{fused_losses[-1]:.4f}, validation "
            f"{[round(v, 4) for v in trainer.validation_loss_values]}; "
            f"launches K3 {counts['K3']}, K4 {counts['K4']} (expected "
            f"{want[0]} = {STEPS_PER_EPOCH} steps + {VAL_BATCHES} validation "
            f"batches, and {want[1]})")
        assert (counts["K3"], counts["K4"]) == want
        assert counts["K1"] == counts["K2"] == counts["K5"] == 0
        assert len(fused_losses) == STEPS_PER_EPOCH
        assert np.isfinite(fused_losses).all()
        assert np.isfinite(trainer.validation_loss_values).all()
        result["unet_train"].update(
            launches=dict(K3=counts["K3"], K4=counts["K4"]),
            fused_epoch_s=secs, fused_losses=[fused_losses[0],
                                              fused_losses[-1]])
        result["unet_train"]["breakdown"] = train_breakdown(
            trainer, "Unetv2 (fused loss)")
        eager = Trainer(base.spec, base.state, base.loss_fn,
                        base.train_loader, base.val_loader, base.config)
        result["unet_train"]["breakdown_eager"] = train_breakdown(
            eager, "Unetv2 (eager wCEL)")
        del trainer, eager, base
    torch.cuda.empty_cache()


class PlainAttention(torch.autograd.Function):
    """The window-attention op through the plain versions, forward and
    backward, called by this script directly (no wrapper falls back)."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win, heads):
        from cvcs_tpu_torch.ops import swin_attn

        ctx.win, ctx.heads = win, heads
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias)
        return swin_attn.swin_window_attention_plain(
            x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win=win, heads=heads)

    @staticmethod
    def backward(ctx, g):
        from cvcs_tpu_torch.ops import swin_attn

        x, *params, bias = ctx.saved_tensors
        dx, *grads = swin_attn.swin_window_attention_bwd_plain(
            x, *params, bias, g, win=ctx.win, heads=ctx.heads)
        return (dx, *[gr.to(p.dtype) for gr, p in zip(grads, params)],
                None, None, None)


def plain_attention(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias=None, *,
                    win, heads):
    return PlainAttention.apply(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias,
                                win, heads)


def train_correctness(result: dict) -> None:
    """One f32 train step through the kernels vs one through the plain
    versions, from the same weights and batch: loss within 1e-4 relative,
    every updated parameter within 1e-4 * max(1, |plain|max). Then 30
    bf16 steps on one fixed batch must lower the loss."""
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.models import swin as swin_mod
    from cvcs_tpu_torch.ops import losses, swin_attn
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    g = torch.Generator().manual_seed(5)
    image = torch.randint(0, 256, (B_TRAIN, 224, 224, 3), generator=g,
                          dtype=torch.uint8).cuda()
    blocks = torch.randint(0, 16, (B_TRAIN, 7, 7), generator=g)
    mask = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2).cuda()
    weights = torch.rand(16, generator=g) + 0.5
    weights[0] = 0.0
    loss_fn = losses.build_loss("wCEL", weights=weights,
                                ignore_background=True, device="cuda")

    def one_step(dtype):
        model, _ = build_model("SwinUnet", 16, seed=0, dtype=dtype)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        state = TrainState(model, opt)
        return state, float(train_step(state, loss_fn, image, mask))

    f1, b1 = swin_attn.launches, swin_attn.bwd_launches
    kstate, kloss = one_step(torch.float32)
    assert (swin_attn.launches - f1, swin_attn.bwd_launches - b1) == (12, 12)
    swin_mod.swin_window_attention = plain_attention
    try:
        pstate, ploss = one_step(torch.float32)
    finally:
        swin_mod.swin_window_attention = swin_attn.swin_window_attention
    assert (swin_attn.launches - f1, swin_attn.bwd_launches - b1) == (12, 12)
    worst, worst_grad = 0.0, 0.0
    kparams = dict(kstate.model.named_parameters())
    for name, p in pstate.model.named_parameters():
        scale = max(1.0, p.abs().max().item())
        err = (kparams[name] - p).abs().max().item() / scale
        gscale = max(1.0, p.grad.abs().max().item())
        worst_grad = max(worst_grad, (kparams[name].grad - p.grad).abs()
                         .max().item() / gscale)
        if err > 1e-4:
            raise AssertionError(f"{name}: kernel step vs plain step {err}")
        worst = max(worst, err)
    rel = abs(kloss - ploss) / abs(ploss)
    log(f"  f32 train step, kernels vs plain versions: loss {kloss:.6f} vs "
        f"{ploss:.6f} (relative {rel:.2e}); updated parameters max err/scale "
        f"{worst:.2e}; gradients max err/scale {worst_grad:.2e}")
    assert rel <= 1e-4
    del kstate, pstate

    model, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.bfloat16)
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    curve = [float(train_step(state, loss_fn, image, mask)) for _ in range(30)]
    log(f"  bf16 overfit, 30 steps on one batch: loss {curve[0]:.4f} -> "
        f"{curve[-1]:.4f} (min {min(curve):.4f})")
    assert np.isfinite(curve).all() and curve[-1] < curve[0]
    result["correctness"] = dict(f32_loss_rel=rel, f32_param_err=worst,
                                 f32_grad_err=worst_grad,
                                 overfit=[curve[0], curve[-1]])
    del state, model
    torch.cuda.empty_cache()


def update_err(after: dict, want: dict, start: dict, names) -> tuple:
    """Largest difference of two steps' parameter updates (after - start),
    each relative to the reference update's largest element, floored at
    1e-3 of the largest update of any parameter (the conv biases ahead of
    a train-mode BN get gradients of rounding size only); and that largest
    update."""
    upd = {k: want[k] - start[k] for k in names}
    top = max(float(u.abs().max()) for u in upd.values())
    return max(float((after[k] - start[k] - u).abs().max())
               / max(float(u.abs().max()), 1e-3 * top)
               for k, u in upd.items()), top


def unet_correctness(result: dict) -> None:
    """One f32 Unetv2 train step through K3/K4 (``build_fused_ce``) vs one
    through the eager wCEL from the same weights and batch: loss within
    1e-5 relative, every updated parameter and BN running statistic within
    1e-4 * max(1, |p|max) (only summation orders differ), and each
    parameter's update within 5e-2 of the eager update (``update_err``).
    One SGD2 step moves a parameter by about 1e-5, below the first
    tolerance, so the second is what sees the gradient: a step whose loss
    passes half the gradient must fail it. Then a bf16
    recipe step with ``remat`` vs one without (cuDNN's deterministic
    algorithms on both, so that only the rematerialisation differs): equal
    losses, parameters and BN statistics (updated once), and each step's
    peak memory."""
    from cvcs_tpu_torch.data.reader import class_weights
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.ops import fused_ce, losses
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    g = torch.Generator().manual_seed(7)
    image = torch.randint(0, 256, (B_TRAIN, 224, 224, 3), generator=g,
                          dtype=torch.uint8).cuda()
    blocks = torch.randint(0, NC, (B_TRAIN, 7, 7), generator=g)
    blocks[0, 0, :3] = 255                       # void
    mask = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    counts = np.bincount(mask[mask < NC].numpy(), minlength=NC)
    weights = class_weights(counts, True)
    mask = mask.to(torch.int32).cuda()
    fused = fused_ce.build_fused_ce(weights, ignore_background=True)
    eager = losses.build_loss("wCEL", weights=weights, ignore_background=True,
                              device="cuda")

    def one_step(loss_fn, dtype, remat=False):
        model, _ = build_model("Unetv2", NC, seed=0, dtype=dtype, remat=remat)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(train_step(TrainState(model, opt), loss_fn, image, mask))
        peak = torch.cuda.max_memory_allocated()
        return loss, model.state_dict(), peak

    def worst(a, b):
        return max(float((a[k] - v).abs().max()) / max(1.0, float(
            v.abs().max())) for k, v in b.items() if v.is_floating_point())

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    start = build_model("Unetv2", NC, seed=0, dtype=torch.float32)[0]
    names = [k for k, _ in start.named_parameters()]
    start = start.state_dict()
    before = kernel_counts()
    f_loss, f_sd, _ = one_step(fused, torch.float32)
    after = kernel_counts()
    assert (after["K3"] - before["K3"], after["K4"] - before["K4"]) == (1, 1)
    e_loss, e_sd, _ = one_step(eager, torch.float32)
    h_loss, h_sd, _ = one_step(half_fused, torch.float32)
    rel = abs(f_loss - e_loss) / abs(e_loss)
    err = worst(f_sd, e_sd)
    upd, upd_max = update_err(f_sd, e_sd, start, names)
    upd_half, _ = update_err(h_sd, e_sd, start, names)
    log(f"  f32 Unetv2 step, fused K3/K4 vs eager wCEL: loss {f_loss:.6f} vs "
        f"{e_loss:.6f} (relative {rel:.2e}, tol 1e-5); updated parameters and"
        f" BN statistics max err/scale {err:.2e} (tol 1e-4); largest "
        f"parameter update {upd_max:.3e}; update error {upd:.2e} (tol "
        f"{TOL_UPDATE:.0e}); with half the gradient {upd_half:.2e} (must "
        f"fail), its params err/scale {worst(h_sd, e_sd):.2e}")
    assert rel <= 1e-5 and err <= 1e-4 and upd <= TOL_UPDATE
    assert h_loss == f_loss and upd_half > TOL_UPDATE
    del f_sd, e_sd, h_sd, start

    torch.backends.cudnn.deterministic = True
    try:
        p_loss, p_sd, p_peak = one_step(eager, torch.bfloat16)
        r_loss, r_sd, r_peak = one_step(eager, torch.bfloat16, remat=True)
    finally:
        torch.backends.cudnn.deterministic = False
    r_err = worst(r_sd, p_sd)
    stat = "encode1.0.layer.1.running_mean"
    log(f"  bf16 Unetv2 step, remat vs plain: loss {r_loss:.6f} vs "
        f"{p_loss:.6f}; parameters and BN statistics max err/scale "
        f"{r_err:.2e}; {stat}[:3] {r_sd[stat][:3].tolist()} vs "
        f"{p_sd[stat][:3].tolist()}; peak memory remat "
        f"{r_peak / 2**30:.3f} GiB, plain {p_peak / 2**30:.3f} GiB")
    assert r_loss == p_loss and r_err <= 1e-6
    result["unet_correctness"] = dict(
        f32_fused_vs_eager_loss_rel=rel, f32_fused_vs_eager_param_err=err,
        f32_fused_vs_eager_update_err=upd, largest_update=upd_max,
        half_gradient_update_err=upd_half,
        remat_param_err=r_err, remat_peak_bytes=r_peak,
        plain_peak_bytes=p_peak)
    del p_sd, r_sd
    torch.cuda.empty_cache()


def kernel_entry(meta, launches, err, times, library, per, **extra) -> dict:
    t = times["total"] if "total" in times else times
    return dict(
        name=meta["name"], route=meta["route"], source=meta["source"],
        replaces=meta["replaces"], launches=launches, max_abs_err=err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes" if t["bytes_ms"] > t["ops_ms"] else "operations",
        library_ms=t["library_ms"], library=library, per=per,
        **({"per_case": times["per_case"]} if "per_case" in times else {}),
        **extra)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from cvcs_tpu_torch.ops import _build, augment, fused_ce, swin_attn

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = gpu_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    sources = ("swin_attn", "swin_attn_bwd", "augment", "fused_ce")
    secs = _build.build(list(sources))
    for name in sources:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2] built {name}.cu for sm_90a in {secs.get(name, 0):.1f} s: "
            + " | ".join(ptxas[:6]) + (" | ..." if len(ptxas) > 6 else ""))

    log("[3] kernels vs plain versions on the card")
    k1_err = check_k1()
    k2_err, k2_scaled = check_k2()
    k5_err = check_k5()
    ce_err = check_k3k4()

    log("[4] serving path")
    result: dict = {}
    scene = main_path(result)
    unet_scene(result, scene)
    del scene

    log("[5] training path")
    train_path(result)
    unet_train_path(result)

    log("[6] training correctness")
    train_correctness(result)
    unet_correctness(result)

    log("[7] times (CUDA events, mean of 10 after 2 warm-up)")
    k1_times = time_k1()
    k2_times = time_k2()
    k5_times = time_k5()
    k3_times, k4_times = time_k3k4()

    tl = result["train"]["launches"]
    ul = result["unet_train"]["launches"]
    line = {"kernels": [
        kernel_entry(swin_attn.KERNEL, result["launches"], k1_err, k1_times,
                     "composite: F.layer_norm + F.linear + "
                     "F.scaled_dot_product_attention + F.linear",
                     "one SwinUnet forward at bc 256, 128 windows "
                     "(12 launches)", launches_train=tl["K1"]),
        kernel_entry(swin_attn.BWD_KERNEL, tl["K2"], k2_err, k2_times,
                     "composite: autograd backward of F.layer_norm + "
                     "F.linear + F.scaled_dot_product_attention + F.linear",
                     f"one SwinUnet train step at p 224, batch {B_TRAIN} "
                     "(12 launches)", max_scaled_err=k2_scaled),
        kernel_entry(augment.KERNEL, tl["K5"], k5_err, k5_times,
                     "composite: torch.flip / torch.rot90 per draw group, "
                     "then the contrast and normalisation ops",
                     f"one training chunk of {B_CHUNK} patches 224x224x3 "
                     "(1 launch)"),
        kernel_entry(fused_ce.KERNEL, ul["K3"], ce_err["k3_err"], k3_times,
                     "F.cross_entropy(NCHW logits, weight, ignore_index=0) "
                     "forward",
                     f"one Unetv2 train step at p 224, batch {B_TRAIN} (1 "
                     "launch), and one per validation batch",
                     device_ms=k3_times["device_ms"]),
        kernel_entry(fused_ce.BWD_KERNEL, ul["K4"], ce_err["k4_err"],
                     k4_times, "autograd backward of F.cross_entropy(NCHW "
                     "logits, weight, ignore_index=0)",
                     f"one Unetv2 train step at p 224, batch {B_TRAIN} (1 "
                     "launch)", max_scaled_err=ce_err["k4_rel"],
                     device_ms=k4_times["device_ms"])],
        "scene_tiles_per_s": result["scene_tiles_per_s"],
        "serve_rasters_per_s": result["serve_rasters_per_s"],
        "serve_launches": result["serve_launches"],
        "forward": result["forward"],
        "f32_label_agreement": result["f32_agreement"],
        "train": result["train"],
        "train_correctness": result["correctness"],
        "unet_scene_tiles_per_s": result["unet_scene_tiles_per_s"],
        "unet_forward": result["unet_forward"],
        "unet_train": result["unet_train"],
        "unet_correctness": result["unet_correctness"],
        "seconds": time.perf_counter() - t_start}
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
