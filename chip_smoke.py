#!/usr/bin/env python3
"""Drive the PyTorch port (``cvcs_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the main paths, and the first designs of
   K4 and K5 that phase 7 times beside the redesigns, one ``nvcc`` each,
   in parallel, into ``build/kernels/``; beside them the host tier's C++
   library (``cvcs_tpu_torch/native/tile_reader.cpp``) with ``g++`` into
   ``build/native/``;
3. kernels vs their plain PyTorch versions on the card, at the shapes the
   main paths give them (bf16 and f32 instances), within stated
   tolerances: K1 (window-attention forward) at the serving shapes, K2
   (its backward) at the p-224 training stage shapes, K5 (fused
   augmentation) on a training chunk, every element equal, and its launch
   plan equal to ``band_plan``'s; K3 and K4 (fused weighted
   cross-entropy forward sums and backward) at the Unetv2 recipe step's
   logits and at a ragged size; K1's, K2's (bf16 and f32), K3's and K4's
   repeats on the same inputs bit-equal; K1 also at the four stage maps
   of a fullconv band (1824 x 7200 at batch 1: non-square, 12,825 windows
   at stage 1, pad and region masks) and at a chunked batch of 16 blocks
   sharing one mask;
4. the serving path: full-width SwinUnet (random weights from a fixed
   seed) segments one full-size 6800 x 7200 GID15-like scene
   (``predict_scene``, p 224, border correction 256, 128 windows per
   forward, bf16) and the serve daemon drains three 1792 x 2240 rasters;
   the launch counters must show every kernel ran; the same scene under
   the f32 policy through the kernel and through the plain attention
   must give the same labels on >= 99.9% of pixels; one forward of 128
   windows is timed and traced (torch.profiler) for where its time goes;
   one bf16 forward of 128 windows through the kernels and one through
   the plain attention, each against the f32 plain forward: the kernels'
   mean and max logit errors within 1.5x the plain bf16 forward's (the
   f32 checks cannot see a wrong bf16 mma fragment; this one can).
   Then full-width Unetv2, the serve recipe's model, segments the same
   scene (the recipe's two-by-four mesh cut to one card), and so does
   full-width SegformerMod (MiT-B3, 47,257,600 parameters, checked), and
   the DeepLab members of ``configs/ensemble_test.yaml``, Resnet101 and
   MobileNet (58,629,712 and 11,024,192 parameters, checked), each with
   one forward timed and traced. Then the band paths on the same scene
   (seed 0, bf16, bands of 8 tile rows, each run once to warm and once
   counted, with tiles/s and peak memory beside the window path's):
   SwinUnet streamed (K1 12 times a forward), fullconv bands (48), the
   device-resident variant (equal bit for bit) and its 4 x 8-tile block
   grid, one band forward timed and traced; f32 streamed labels equal to
   the window path's, f32 fullconv labels through K1 and through the
   plain attention on >= 99.9%; the stage-1 mask's host cost;
   ``cli.esa`` at p 512 on a 2600 x 3100 raster (K1 on one forward);
   Unetv2 streamed (the f32 rule) and fullconv, Resnet101 fullconv and
   SegformerMod's 2 x 4-tile block grid. Then retrieval: ``cli.retrieve``
   over two 6720 x 7168 scenes (1,920 patches at p 224, images and masks
   on the card), mask-only (10 probes, top 10), whose card scores of
   three probes must equal a host reference within 1e-6 and whose
   rankings must agree with the reference's under the tie rule; then
   ``net: vitb8`` and ``vits16`` (DINO-named checkpoints of seeded random
   weights) and the zoo taps of MobileNet and Unetv2, each with its
   embedding rate and peak memory, and f32 embeddings of 16 patches on
   the card against the CPU's;
5. the training path: first, in a process of its own, one SwinUnet
   epoch through ``cli.train`` with ``profile_dir`` (the trace must name
   K1's, K2's and K5's CUDA kernels) and ``debug_plot`` (where matplotlib
   imports: one PNG a chunk). Then ``python -m
   cvcs_tpu_torch.cli.train``'s ``main`` trains full-width SwinUnet with
   the recipe's geometry (p 224, batch 10, wCEL with ignore_background,
   SGD2, bf16, random_shift, ``augmentation: fused``) for 2 epochs on a
   synthetic dataset (2 train scenes of 1792 x 2240, 160 patches per
   chunk, 1 validation scene), then resumes from the epoch-1 checkpoint;
   the counters must show K1 and K2 12 times per step and K5 once per
   chunk; ``cli.export`` writes the last checkpoint as a state dict that
   loads with ``strict=True`` into a fresh SwinUnet whose logits equal
   the restored trainer's bit for bit; a few steps are timed (CUDA
   events) and traced for the share of each kernel. Then the canonical
   Unetv2 recipe (``configs/train_unetv2.yaml``: the same
   geometry with ``augmentation: True``) the same way, and one epoch of a
   ``Trainer`` built the same way with ``build_fused_ce`` as its loss: K3
   once per train step and per validation batch, K4 once per train step.
   Then SegformerMod the same way with ``augmentation: fused`` (K5 once
   per chunk), resumed; ``cli.evaluate`` on the checkpoint the resumed
   run wrote (the restored weights equal to the trainer's, the metrics
   to the trainer's own evaluation, the tables printed); and one epoch
   through ``build_fused_ce`` (K3, K4 and K5). Then Resnet101 the same
   way (K5 once per chunk), resumed, and one epoch through
   ``build_fused_ce`` (K3, K4, K5), and MobileNet for one epoch (K5),
   each step timed and traced. Last, the four-member ensemble of
   ``configs/ensemble_test.yaml`` (Unetv2, Resnet101, MobileNet,
   SegformerMod) from the checkpoints this phase wrote: ``cli.evaluate``
   with ``net: Ensemble`` on the 80 validation patches, whose confusion
   matrix must equal that of the members' own predictions voted on the
   host, and one ``predict_scene`` of the ensemble on a 1792 x 2240
   raster;
6. training correctness: one f32 SwinUnet train step through the kernels
   and one through the plain versions (called directly by this script)
   from the same weights and batch agree; a 30-step bf16 fixed-batch
   overfit lowers the loss; one f32 Unetv2 step through K3/K4 and one
   through the eager wCEL agree, parameter updates included (a loss that
   passes half its gradient must not); a Unetv2 step with ``remat`` equals one
   without, BN statistics updated once, and both peak memories print;
   one f32 SegformerMod step through K3/K4 and one through the eager wCEL
   agree by the same rule, with the same dropout seed; two bf16 steps
   from one dropout seed give bit-equal losses and another seed another;
   a bf16 forward's logits are within the bf16 tolerance of an f32
   forward's and its labels agree on >= 97.5% of the pixels (the JAX
   package's own share is 98.50%); the five DeepLab names' f32 logits on
   the card against the same weights on the CPU (cuDNN's dilated,
   depthwise and grouped convolutions against the CPU's); the bf16
   Resnet101 labels against its f32 ones; one f32 Resnet101 step through
   K3/K4 against one through the eager wCEL by the U-Net rule; one SGD2
   step on MobileNetGoogle decays its unread ``aux_layer`` as optax does;
7. in a process of its own (a fresh profiler: see ``phase7``), times
   (CUDA events, after warm-up; K3 and K4 also their traced device
   time) of each kernel beside its bound, its plain version and a library
   yardstick; K1 at the serving shapes (per forward), at the p-224
   training shapes (per train step) and at a fullconv band's (per band
   forward); for K1 and K2 also three op calls
   traced, split by CUDA kernel (each kernel's time over the launches the
   trace recorded), with the GEMMs' achieved TFLOP/s; K4 and
   K5 beside their first designs, in turns (old, new, new, old) and
   traced by CUDA kernel, K5 on a 160-patch chunk and on a GID15-sized
   chunk of 1,920, and the whole fused augmentation preset per chunk
   split into K5, the uint8 rounding and the masks' gather;
8. contexts, ``random_tps`` crops and checkpoint interop: one chunk of two
   6800 x 7200 scenes at p 224 through ``get_chunk`` with
   ``load_context``, ``random_shift`` and ``random_tps`` [[448, 0.1],
   [300, 0.1]] (its ms by CUDA events and its peak memory), whose tiles,
   crops and contexts must equal the CPU port's from the same draws
   within one level (a worker thread computes those meanwhile; the share
   of values that differ is printed) and whose masks must be equal;
   full-width SwinUnet through ``cli.train`` with phase 5's geometry plus
   ``load_context``, those ``random_tps`` and ``async_checkpoints`` for 2
   epochs, then a third resumed with ``load_checkpoint: auto``: K1 and K2
   12 times a step, K5 once a chunk, each checkpoint equal bit for bit to
   a copy of the state taken when its save was issued, the seconds the
   saves cost the training thread and the epoch rate printed; Unetv2,
   Resnet101, MobileNet and SegformerMod of seeded random weights saved
   as native ``.pt`` files and as reference 12-key pickles (wrapper
   prefixes, numpy arrays, an unknown metric class), each evaluated by
   ``cli.evaluate`` on the 80 validation patches from both, with equal
   confusion matrices; whether ``tensorstore`` imports here (where it
   does not, the Orbax reader's ImportError names
   ``python -m cvcs_tpu.cli.export``);
9. the mesh on ``torch.distributed``, in processes of their own over a
   ``file://`` rendezvous (``--phase9`` runs this phase alone after the
   builds): two gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on
   one GPU; gloo's sends take no CUDA tensor, so the halo stages through
   pinned host buffers) run full-width SwinUnet's
   ``predict_scene_sharded`` at spatial 2 on the 6800 x 7200 scene (f32
   labels equal to the one-device window path's, bf16 on >= 99.9%, K1 on
   both ranks), ``predict_scene_fullconv_sharded`` (equal to 15-row
   bands on one device, f32), ``predict_scenes_sharded`` and the serve
   daemon at data 2 (labels, masks and journal equal to one device's),
   data-parallel f32 Unetv2, SwinUnet and fused-loss steps and an f64
   Unetv2 step against one process on the global batch of 10 (loss and
   running statistics within 1e-5, phase 6's update rule on the f64
   step), ``cli.train`` with ``mesh: {data: 2}`` for an epoch and a
   resume with ``load_checkpoint: auto`` (K1 and K2 12 a step, K5 once a
   chunk, on each rank) and ``cli.evaluate`` with the mesh (its confusion
   matrix equal to one device's); then one NCCL rank runs the scene path
   on a 1 x 1 mesh;
10. spatially partitioned training and tensor parallelism, in processes
   of their own (``--phase10`` runs this phase alone after the builds):
   two gloo ranks sharing ``cuda:0`` at mesh {data: 1, spatial: 2} take
   f32 steps of full-width Unetv2, SwinUnet and SegformerMod, an f64
   Unetv2 step and an f32 fused-loss Unetv2 step (K3 and K4 on each
   rank's rows) on row strips of the global batch of 10, each against
   one process (loss and running statistics within 1e-5, phase 9's
   update rules; K1 and K2 12 a Swin step on each rank); print each
   rank's peak memory of a bf16 Unetv2 and SwinUnet step beside one
   process's, the step's halo exchanges (count, bytes, host ms) and the
   ops that took the gather; run full-width Unetv2, Resnet101 and
   SegformerMod f32 forwards at p 224 under ``tensor_parallel`` (logits
   within 1e-4 of scale of one device's, every sharded kernel's bytes
   halved on each rank); and train Unetv2 (the recipe, ``augmentation:
   True``) and SwinUnet (``augmentation: fused``) through ``cli.train``
   at spatial 2 for an epoch and a resume with ``load_checkpoint: auto``
   on one 1792 x 2240 scene (K1/K2 12 a step or forward and K5 once a
   chunk on each rank, the ranks on one state at the end), their
   patches/s beside phase 5's. The DeepLab family the same way: f32
   steps of Resnet101, MobileNet, Resnet50, MobileNetGoogle and
   MobileNetResnet18, an f64 Resnet101 step and an f32 Resnet101 step
   through ``build_fused_ce`` (K3 and K4 once a rank) against one
   process (Resnet101's f32 running statistics within a fixed 4e-5,
   above the 1.77e-5 that f32 rounding moves one process's own), each
   step's halo exchanges and gathered ops printed, a bf16 Resnet101
   step's peak memory a rank, and MobileNet through ``cli.train`` with
   ``augmentation: fused`` (K5 once a chunk a rank) for an epoch and a
   resume. The phase must take less than 240 s;
11. the host decode and encode tier (``cvcs_tpu_torch.native``, the C++
   library; ``--phase11`` runs it alone after the builds): six 6800 x
   7200 TIFF scenes with their index masks, phase 4's three serve rasters
   and a PIL-written file of each TIFF codec and layout and each PNG type
   decode through the C++ tier and through its plain version
   (``native.plain``, PIL) to equal arrays, and a mask PNG written by the
   C++ writer reads back equal under PIL; a ``ChunkLoader`` over the six
   scenes, two a chunk, with ``load_context``, run through each tier with
   the same seeds (equal chunks): chunk 1 taken cold, chunks 2 and 3 each
   after 30 Unetv2 steps on the chunk before with their decodes
   prefetched (chunk 3's overlapping a whole ``get_chunk`` and its
   steps), each ``get_chunk``'s ms and decode share, the steps beside
   chunk 3's decode against those with nothing queued, chunks 2 and 3's
   arrays equal to an inline decode; the serve daemon through the C++
   tier on phase 4's three rasters, its ``batch_seconds`` beside their
   serial decode by each tier, its masks and journal equal to phase 4's;
   the convoy measure (``tools/pil_gil.py``) of both tiers. Under 90 s.

The last two lines are a JSON object of per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``; before them, the
seconds the run took and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# K1 at the four stage maps of one fullconv band (8 tile rows at p 224 +
# a halo of 16: 1824 x 7200 pixels, batch 1), where Hp and h0 are
# (rows, cols): 456 x 1800 unpadded (12,825 windows), 228 x 900 -> 232 x
# 904, 114 x 450 -> 120 x 456 and 57 x 225 -> 64 x 232, each unshifted
# and shifted; from stage 2 on the pad mask joins the region mask
K1_BAND_CASES = [
    ("b1", (456, 1800), 96, 3, 8, (456, 1800), 0),
    ("b1_shift", (456, 1800), 96, 3, 8, (456, 1800), 4),
    ("b2", (232, 904), 192, 6, 8, (228, 900), 0),
    ("b2_shift", (232, 904), 192, 6, 8, (228, 900), 4),
    ("b3", (120, 456), 384, 12, 8, (114, 450), 0),
    ("b3_shift", (120, 456), 384, 12, 8, (114, 450), 4),
    ("b4", (64, 232), 768, 24, 8, (57, 225), 0),
    ("b4_shift", (64, 232), 768, 24, 8, (57, 225), 4),
]
K1_PER_BAND = [("b1", 1), ("b1_shift", 1), ("b2", 1), ("b2_shift", 1),
               ("b3", 3), ("b3_shift", 3), ("b4", 1), ("b4_shift", 1)]
# a chunked fullconv forward: 16 blocks of 2 x 8 tiles (480 x 1824), one
# (nWin, T, T) mask shared by the batch; stage 2 (60 x 228 -> 64 x 232),
# shifted, pad and region masks
K1_CHUNK_CASE = ("c2_shift", (64, 232), 192, 6, 8, (60, 228), 4)
B_CHUNK_BLOCKS = 16


def hw(v) -> tuple[int, int]:
    """A case's map size: an int for a square map, else (rows, cols)."""
    return (v, v) if isinstance(v, int) else tuple(v)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def since(t0: float) -> str:
    return f"{time.perf_counter() - t0:.1f} s in"


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
def k1_inputs(case, dtype, seed=0, batch=B):
    from cvcs_tpu_torch.models.swin import attn_bias

    _, hp, c, heads, win, h0, shift = case
    (hp, wp), (h0, w0) = hw(hp), hw(h0)
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).cuda()

    x = rnd(batch, hp, wp, c).to(dtype)
    args = [x, 1 + rnd(c, std=0.1), rnd(c, std=0.1),
            rnd(c, 3 * c, std=c ** -0.5), rnd(3 * c, std=0.02),
            rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, wp, h0, w0, win, shift, x.device)
    return args, bias, dict(win=win, heads=heads)


def k1_bound(case, dtype, masked: bool, batch=B) -> tuple[float, float]:
    """(ms the bytes take at the memory rate, ms the operations take at
    the peak rate): each input read once, each output written once."""
    _, hp, c, _, win, _, _ = case
    hp, wp = hw(hp)
    s = torch.finfo(dtype).bits // 8
    n = batch * hp * wp
    t = win * win
    nwin = (hp // win) * (wp // win)
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


def check_k1(cases=K1_CASES, batch=B) -> float:
    """K1 vs its plain version at every case, bf16 and f32; returns the
    largest bf16 error at the main path's stage shapes (names s*; every
    case of another list)."""
    from cvcs_tpu_torch.ops import swin_attn

    worst = 0.0
    for case in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args, bias, kw = k1_inputs(case, dtype, batch=batch)
            got = swin_attn.swin_window_attention(*args, bias, **kw)
            torch.cuda.synchronize()
            want = swin_attn.swin_window_attention_plain(*args, bias, **kw)
            torch.cuda.synchronize()
            again = swin_attn.swin_window_attention(*args, bias, **kw)
            same = torch.equal(got, again)
            scale = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            mean = (got.float() - want.float()).abs().mean().item()
            ok = (err <= TOL[dtype] * scale and same
                  and bool(torch.isfinite(got).all()))
            log(f"  K1 {case[0]:>9} {str(dtype)[6:]:>8} B={batch} "
                f"Hp,Wp={hw(case[1])} h0,w0={hw(case[5])} "
                f"C={case[2]} heads={case[3]} win={case[4]} "
                f"mask={'none' if bias is None else 'yes'}: max_abs_err="
                f"{err:.3e} mean={mean:.2e} tol={TOL[dtype] * scale:.3e}; "
                f"repeat bit-equal: {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {case[0]} {dtype}: {err} > tol")
            if dtype == torch.bfloat16 and (cases is not K1_CASES
                                            or case[0].startswith("s")):
                worst = max(worst, err)
            del args, got, want, again
    return worst


# CUDA launches of each K1 / K2 kernel per op call (the rest: one)
LAUNCHES_PER_CALL = {"swin_attn_fwd_gemm": 2, "swin_bwd_gemm": 5}


def phase7_profile(fn, **kw) -> dict | None:
    """``device_profile`` for phase 7's splits, or None ("not measured")
    when every trace came back empty: late in a run the profiler records
    fewer and fewer device events (a third of the launches, then none at
    all), and a split is a reading, not a check."""
    try:
        return device_profile(fn, **kw)
    except RuntimeError as err:
        log(f"      {err}: not measured")
        return None


def kernel_split(fn, n: int = 3) -> dict | None:
    """Device time per op call of each CUDA kernel that ``fn`` issues,
    traced over ``n`` calls, by kernel name (``swin_attn_fwd_gemm``, ...;
    ``other`` for PyTorch's own, the parameter casts): each kernel's
    traced time over the launches the trace recorded (it can drop some),
    times its launches per op call. ``other`` is divided by the calls
    made, since its launches per call are not fixed by this script.
    None when the profiler recorded nothing."""
    prof = phase7_profile(lambda: [fn() for _ in range(n)])
    if prof is None:
        return None
    out, counts = {}, {}
    for name, (ms, count) in prof["by_name"].items():
        m = re.search(r"(swin_\w+)", name)
        key = m.group(1) if m else "other"
        out[key] = out.get(key, 0.0) + ms
        counts[key] = counts.get(key, 0) + count
    log(f"      traced {n} calls, launches recorded: {counts} (expected "
        + ", ".join(f"{k} {n * LAUNCHES_PER_CALL.get(k, 1)}"
                    for k in counts if k != "other") + ")")
    return {k: (v / n if k == "other"
                else v / counts[k] * LAUNCHES_PER_CALL.get(k, 1))
            for k, v in out.items()}


def split_line(split: dict | None, gemm_key: str, gemm_flops: float) -> str:
    if split is None:
        return "traced per call: not measured"
    gemm_ms = split.get(gemm_key, 0.0)
    tflops = gemm_flops / (gemm_ms * 1e-3) / 1e12 if gemm_ms else 0.0
    return ("traced per call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f" ms; GEMMs at {tflops:.1f} TFLOP/s")


def time_k1(cases=K1_CASES, per=K1_PER_FORWARD, batch=B,
            what="per forward") -> dict:
    """Per-case times (bf16) and the totals of one forward (the serving
    shapes, B windows) or of one train step (the p-224 training shapes,
    ``time_k1(K2_CASES, K2_PER_STEP, B_TRAIN, "per train step")``)."""
    from cvcs_tpu_torch.ops import swin_attn

    cases = {c[0]: c for c in cases}
    rows = {}
    for name, _ in per:
        args, bias, kw = k1_inputs(cases[name], torch.bfloat16, batch=batch)
        before = swin_attn.launches
        rows[name] = dict(
            ms=cuda_ms(lambda: swin_attn.swin_window_attention(
                *args, bias, **kw)),
            plain_ms=cuda_ms(lambda: swin_attn.swin_window_attention_plain(
                *args, bias, **kw)),
            library_ms=cuda_ms(lambda: k1_library(*args, bias, **kw)))
        rows[name]["bytes_ms"], rows[name]["ops_ms"] = k1_bound(
            cases[name], torch.bfloat16, bias is not None, batch)
        rows[name]["split"] = kernel_split(
            lambda: swin_attn.swin_window_attention(*args, bias, **kw))
        _, hp, c = cases[name][:3]
        gemm_flops = 8 * batch * math.prod(hw(hp)) * c * c
        rows[name]["bound_ms"] = max(rows[name]["bytes_ms"],
                                     rows[name]["ops_ms"])
        swin_attn.launches = before     # timing launches are not the path's
        r = rows[name]
        log(f"  K1 {name:>9} bf16 B={batch}: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, composite library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"(bytes {r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; "
            f"kernel at {r['bound_ms'] / r['ms'] * 100:.2f}% of bound)")
        log("      " + split_line(r["split"], "swin_attn_fwd_gemm", gemm_flops))
        del args
    total = {k: sum(rows[n][k] * cnt for n, cnt in per)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                       "ops_ms")}
    below = [n for n, _ in per if rows[n]["ms"] < rows[n]["library_ms"]]
    log(f"  K1 {what} ({sum(n for _, n in per)} op calls, bf16, "
        f"B={batch}): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, composite "
        f"library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.4f} ms; below the library in "
        f"{len(below)} of {len(per)} cases")
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
            again = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
            for name, a, r in zip(GRADS, got, again):
                if not torch.equal(a, r):
                    raise AssertionError(f"K2 {case[0]} {dtype} {name}: "
                                         "repeat not bit-equal")
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
                f"{TOL_BWD[dtype]:.0e}); repeat bit-equal ok")
            if dtype == torch.bfloat16 and case[0].startswith("s"):
                worst, worst_scaled = max(worst, e), max(worst_scaled, es)
            del args, got, want, again
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
        r["split"] = kernel_split(lambda: swin_attn._bwd_kernel_launch(
            *args, bias, cot, **kw))
        _, hp, c = cases[name][:3]
        gemm_flops = 22 * B_TRAIN * hp * hp * c * c
        swin_attn.bwd_launches = before  # timing launches are not the path's
        log(f"  K2 {name:>9} bf16: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, composite library backward "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"(bytes {r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; "
            f"kernel at {r['bound_ms'] / r['ms'] * 100:.2f}% of bound)")
        log("      " + split_line(r["split"], "swin_bwd_gemm", gemm_flops))
        del args
    total = {k: sum(rows[n][k] * cnt for n, cnt in K2_PER_STEP)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                       "ops_ms")}
    log(f"  K2 per train step (12 op calls, bf16, B={B_TRAIN}): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, composite "
        f"library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.4f} ms")
    return dict(total=total, per_case=rows)


# -- K5: fused augmentation ------------------------------------------------------
B_CHUNK = 160                      # patches of one training chunk
B_GID15 = 1920                     # patches of a chunk of GID15's scenes
# (P, C) for the launch-plan check: the chunk shapes, a ragged P, a band
# staged in two pieces, a patch too wide to stage
PLAN_SHAPES = [(224, 3), (224, 4), (97, 3), (512, 4), (3100, 1)]


def k5_inputs(c, seed=0, b=B_CHUNK):
    from cvcs_tpu_torch.ops import augment

    g = torch.Generator(device="cuda").manual_seed(seed + c)
    img = torch.randint(0, 256, (b, 224, 224, c), generator=g,
                        device="cuda", dtype=torch.uint8)
    flips, rots, factors = augment.draw_dihedral(b, 0.6, g)
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
    non-identity band mean/std: every element equal (both take the
    grayscale mean as an exact f32 sum of integers times the f32
    reciprocal of P*P, and the blend with separately rounded operations);
    the launch plan the built kernel computes equal to ``band_plan``'s."""
    from cvcs_tpu_torch.ops import augment

    worst = 0.0
    for c in (3, 4):
        args = k5_inputs(c)
        got = augment.fused_augment(*args)
        torch.cuda.synchronize()
        want = augment.fused_augment_plain(*args)
        lib = k5_library(*args)
        err = (got - want).abs().max().item()
        differ = int((got != want).sum())           # a count, not a mean
        ok = differ == 0 and torch.equal(lib, want)
        log(f"  K5 B={B_CHUNK} P=224 C={c}: "
            f"{(1 - differ / got.numel()) * 100:.4f}% elements equal to "
            f"plain ({differ} differ), max abs err {err:.3e}; library "
            f"composite equal to plain: {torch.equal(lib, want)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 C={c}: {differ} elements differ")
        worst = max(worst, err)
    plans = {shape: (augment.kernel_plan(*shape), augment.band_plan(*shape))
             for shape in PLAN_SHAPES}
    log("  K5 launch plans (cluster, rows per CTA, rows staged at once, "
        "shared memory bytes), the kernel's = band_plan's: " + "; ".join(
            f"P {p} C {c}: {tuple(k.values())}" + ("" if k == b else " FAIL")
            for (p, c), (k, b) in plans.items()))
    if any(k != b for k, b in plans.values()):
        raise AssertionError("K5's launch plan differs from band_plan")
    return worst


def first_designs():
    """The first designs of K4 and K5 (``csrc/fused_ce_v1.cu``,
    ``csrc/augment_v1.cu``), which the port no longer calls, as op calls
    with their wrappers as they were: phase 7 times them in turns with
    the redesigns."""
    from cvcs_tpu_torch.ops import _build

    bwd = _build.load("fused_ce_v1").cvcs_ce_bwd_v1
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_void_p] * 6
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    aug = _build.load("augment_v1").cvcs_fused_augment_v1
    aug.restype = ctypes.c_int
    aug.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])

    def k4(logits, labels, weights, g, wsum):
        n, c = logits.shape
        g = g.to(torch.float32).contiguous()
        out = torch.empty((n, c), dtype=torch.float32, device=logits.device)
        with torch.cuda.device(logits.device):
            rc = bwd(logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
                     g.data_ptr(), wsum.data_ptr(), out.data_ptr(), n, c,
                     torch.cuda.current_stream(logits.device).cuda_stream)
        assert rc == 0, rc
        return out

    def k5(images, flips, rots, factors, mean, std):
        b, p, _, c = images.shape
        args = [flips.to(torch.int32).contiguous(),
                rots.to(torch.int32).contiguous(),
                factors.to(torch.float32).contiguous(),
                mean.to(torch.float32).contiguous(),
                std.to(torch.float32).contiguous()]
        out = torch.empty(images.shape, dtype=torch.float32,
                          device=images.device)
        with torch.cuda.device(images.device):
            rc = aug(images.contiguous().data_ptr(),
                     *[a.data_ptr() for a in args], out.data_ptr(), b, p, c,
                     torch.cuda.current_stream(images.device).cuda_stream)
        assert rc == 0, rc
        return out

    return k4, k5


def in_turns(old, new, iters: int = 10) -> dict:
    """CUDA-event times of two versions in turns: old, new, new, old."""
    t = [cuda_ms(f, iters) for f in (old, new, new, old)]
    return dict(old_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns=t)


def traced_split(fn, n: int = 10) -> dict | None:
    """Device ms per launch of each CUDA kernel ``fn`` issues, traced over
    ``n`` calls, by kernel name: each kernel's traced time over the
    launches the trace recorded, which can be fewer than ``n``. None when
    the profiler recorded nothing."""
    prof = phase7_profile(lambda: [fn() for _ in range(n)])
    if prof is None:
        return None
    out, counts = {}, {}
    for name, (ms, count) in prof["by_name"].items():
        key = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", "")
                     .removeprefix("void "))[:48]
        out[key] = out.get(key, 0.0) + ms
        counts[key] = counts.get(key, 0) + count
    log(f"    traced {n} calls, launches recorded: {counts}")
    return {k: out[k] / counts[k] for k in out}


def split_sum(split: dict | None) -> float | None:
    return None if split is None else sum(split.values())


def split_text(split: dict | None) -> str:
    if split is None:
        return "not measured"
    return ", ".join(f"{k} {v:.4f}" for k, v in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def time_k5(v1) -> dict:
    """K5 on a 160-patch chunk and on a GID15-sized chunk of 1,920: the
    redesign and the first design in turns (CUDA events) and traced by
    CUDA kernel; the plain version and the library composite on the
    160-patch chunk; then the whole fused preset per chunk
    (``data/augment.py`` ``fused_dihedral_augment``: K5, the uint8
    rounding, the masks' dihedral gather), each part timed and the
    preset traced."""
    from cvcs_tpu_torch.data import augment as data_augment
    from cvcs_tpu_torch.ops import augment

    before = augment.launches
    r = {}
    for b in (B_CHUNK, B_GID15):
        args = k5_inputs(3, b=b)
        new = (lambda args=args: augment.fused_augment(*args))
        old = (lambda args=args: v1(*args))
        t = in_turns(old, new)
        t["split"] = traced_split(new)
        t["old_split"] = traced_split(old)
        t["device_ms"] = split_sum(t["split"])
        t["old_device_ms"] = split_sum(t["old_split"])
        nbytes = b * 224 * 224 * 3 * (1 + 4)
        t["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = b * 224 * 224 * 3 * 12 / PEAK_FLOPS[torch.float32] * 1e3
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        same = torch.equal(new(), old())
        if b == B_CHUNK:
            t["plain_ms"] = cuda_ms(lambda: augment.fused_augment_plain(*args))
            t["library_ms"] = cuda_ms(lambda: k5_library(*args))
        log(f"  K5 B={b} P=224 C=3 (bound {t['bound_ms']:.4f} ms, bytes): "
            f"redesign {t['ms']:.4f} ms by events ({t['bound_ms'] / t['ms'] * 100:.1f}% "
            f"of bound), first design {t['old_ms']:.4f} ms (turns old, new, "
            f"new, old: {', '.join(f'{x:.4f}' for x in t['turns'])}); traced "
            f"per call: {split_text(t['split'])} | first design "
            f"{split_text(t['old_split'])}; outputs equal: {same}"
            + (f"; plain {t['plain_ms']:.3f} ms, library composite "
               f"{t['library_ms']:.3f} ms" if b == B_CHUNK else ""))
        r[b] = t
        del args

        img, fl, ro, fa, _, _ = k5_inputs(3, b=b)
        masks = torch.randint(0, 16, (b, 224, 224), device="cuda",
                              dtype=torch.int32)
        zero, one = torch.zeros(3, device="cuda"), torch.ones(3, device="cuda")
        k5_out = augment.fused_augment(img, fl, ro, fa, zero, one)
        parts = dict(
            preset=cuda_ms(lambda: data_augment.fused_dihedral_augment(
                img, masks, fl, ro, fa)),
            K5=cuda_ms(lambda: augment.fused_augment(img, fl, ro, fa, zero,
                                                     one)),
            rounding=cuda_ms(lambda: torch.clamp(torch.round(k5_out), 0,
                                                 255).to(torch.uint8)),
            masks=cuda_ms(lambda: augment.dihedral(masks, fl, ro)))
        split = traced_split(lambda: data_augment.fused_dihedral_augment(
            img, masks, fl, ro, fa))
        log(f"  fused preset B={b}: {parts['preset']:.4f} ms per chunk by "
            f"events = K5 {parts['K5']:.4f} + uint8 rounding "
            f"{parts['rounding']:.4f} + masks' dihedral gather "
            f"{parts['masks']:.4f} (each alone); traced per call: "
            f"{split_text(split)}")
        r[b]["preset"] = dict(parts, split=split)
        del img, masks, k5_out
    augment.launches = before
    out = dict(r[B_CHUNK])
    out["gid15_chunk"] = r[B_GID15]
    return out


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
        k4_equal = all(torch.equal(fused_ce._bwd_launch(x, lab, w, g, wsum),
                                   dx) for _ in range(2))
        ok = (max(rel) <= TOL_CE and err <= TOL_CE * max(1.0, big)
              and err <= TOL_CE * big and bit_equal and k4_equal
              and bool(torch.isfinite(dx).all()))
        n = x.shape[0]
        log(f"  K3 {name:>6} N={n} C={NC}: loss {float(loss):.6f} vs plain "
            f"{float(want_sum / want_w):.6f}; relative errors loss_sum "
            f"{rel[0]:.2e}, wsum {rel[1]:.2e}, loss {rel[2]:.2e} (tol "
            f"{TOL_CE:.0e}); 3 runs bit-equal: {bit_equal}")
        log(f"  K4 {name:>6} N={n} C={NC}: dlogits max abs err {err:.3e}, "
            f"|plain|max {big:.3e}, err/|plain|max {err / big:.2e} (tol "
            f"{TOL_CE:.0e}); 3 runs bit-equal: {k4_equal} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3/K4 {name}: {rel}, {err}, {bit_equal}, "
                                 f"{k4_equal}")
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


def time_k3k4(v1) -> tuple[dict, dict]:
    """K3 and K4 at the recipe step's shape: kernel (CUDA events, and the
    device time of a traced loop), plain and library times; K4's redesign
    and its first design ``v1`` in turns, both by events and traced by
    CUDA kernel; bound from
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
    k4 = in_turns(lambda: v1(x, lab, w, g, wsum),
                  lambda: fused_ce._bwd_launch(x, lab, w, g, wsum))
    k4.update(plain_ms=cuda_ms(lambda: fused_ce.ce_grad_plain(x, lab, w,
                                                              scale)),
              library_ms=cuda_ms(lib_bwd))
    k4["split"] = traced_split(lambda: fused_ce._bwd_launch(x, lab, w, g,
                                                            wsum))
    k4["old_split"] = traced_split(lambda: v1(x, lab, w, g, wsum))
    k4["old_device_ms"] = split_sum(k4["old_split"])
    same = float((v1(x, lab, w, g, wsum)
                  - fused_ce._bwd_launch(x, lab, w, g, wsum)).abs().max())
    for r, key, fn in (
            (k3, "K3", lambda: fused_ce._fwd_launch(x, lab, w)),
            (k4, "K4", lambda: fused_ce._bwd_launch(x, lab, w, g, wsum))):
        # the events time of a back-to-back loop includes the wrapper's
        # host cost; the trace gives the kernels' own device time
        prof = phase7_profile(lambda: [fn() for _ in range(10)],
                              per_launch=True)
        r["device_ms"] = None if prof is None else prof[key]
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
    log(f"  K4 redesign vs first design in turns (old, new, new, old): "
        f"{', '.join(f'{t:.4f}' for t in k4['turns'])} ms; traced per call: "
        f"{split_text(k4['split'])} | first design "
        f"{split_text(k4['old_split'])}; max |difference| {same:.2e}")
    for name, r in (("K3", k3), ("K4", k4)):
        log(f"  {name} N={n} C={NC} f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, F.cross_entropy "
            f"{'forward' if name == 'K3' else 'backward'} "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes "
            f"{r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; kernel at "
            f"{r['bound_ms'] / r['ms'] * 100:.1f}% of bound); device time "
            + ("per launch not measured" if r["device_ms"] is None else
               f"per launch {r['device_ms']:.4f} ms (traced, "
               f"{r['bound_ms'] / r['device_ms'] * 100:.1f}% of bound)"))
    return k3, k4


# -- the serving path ----------------------------------------------------------
def synthetic_scene(h, w, seed):
    """Blocky uint8 scene with texture: labels vary across it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w] // 2
    return img + rng.integers(0, 64, (h, w, 3), np.uint8)


# cuDNN / cuBLAS kernel names: the convolutions (and GEMMs) of a trace;
# ``dgrad_engine`` / ``wgrad_engine`` are cuDNN's generic backward
# convolutions (the DeepLab ASPP's atrous convs take them)
CONV_NAMES = ("xmma", "cudnn", "conv", "gemm", "cutlass", "nvjet", "dgrad",
              "wgrad")


def device_profile(fn, attempts: int = 6, per_launch: bool = False) -> dict:
    """Run ``fn`` under torch.profiler: device time by kernel name, the
    span from the first kernel's start to the last one's end, and the
    device's idle share of that span. A trace that holds no device event
    at all is taken again after a pause, up to ``attempts`` times in all,
    before this raises: on the H100 host empty traces come now and then,
    and several in a row late in a long run (see ``phase7``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
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
        if spans:
            break
        log(f"  torch.profiler recorded no device time (trace {attempt} of "
            f"{attempts})")
        time.sleep(0.5)
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    spans.sort()
    busy_us, end = 0.0, spans[0][0]
    for s, e in spans:               # union of the kernels' intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    span_ms = (end - spans[0][0]) / 1e3

    def ms_of(key):
        """Traced ms of the kernels whose name holds ``key``: in all, or
        per op call (an op call launches each of its kernels once, so per
        the most launches of one of them that the trace recorded)."""
        hits = [(t, c) for name, (t, c) in by_name.items() if key in name]
        total = sum(t for t, _ in hits)
        if not per_launch:
            return total
        return total / max([1] + [c for _, c in hits])

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
    k1 = (f"; K1 {prof['K1']:.3f} ms in {k1_launches} CUDA launches (4 "
          f"per op call) = "
          f"{prof['K1'] / prof['kernel_ms'] * 100:.1f}% of kernel time"
          if k1_launches else "")
    log(f"  {name} forward bf16, {B} windows of 256x256: {ms:.3f} ms (CUDA "
        f"events); traced: kernels {prof['kernel_ms']:.3f} ms over a "
        f"{prof['span_ms']:.3f} ms span, device idle "
        f"{prof['idle_share'] * 100:.1f}%{k1}; convolutions and GEMMs "
        f"{prof['conv_ms']:.3f} ms = "
        f"{prof['conv_ms'] / prof['kernel_ms'] * 100:.1f}%, the rest "
        f"(BatchNorm, casts, elementwise, resizes) "
        f"{(1 - prof['conv_ms'] / prof['kernel_ms']) * 100:.1f}%")
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
        result["serve_outputs"] = served_outputs(out, entries)
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


def bf16_forward_check(result: dict) -> None:
    """One bf16 SwinUnet forward of B bc-256 windows through the kernels and
    one through the plain attention, each against the f32 forward through
    the plain attention (same weights, same input): the kernels' mean and
    max absolute logit errors must each be at most 1.5x the plain bf16
    forward's. Both bf16 forwards round at the same casting points, so
    they differ from the f32 one by the same kind of error; a wrong bf16
    mma fragment would not (the f32 instance runs no fragment, so the f32
    checks cannot see one)."""
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.models import swin as swin_mod
    from cvcs_tpu_torch.ops import swin_attn

    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (B, 256, 256, 3), generator=g,
                      dtype=torch.uint8).cuda().float()
    m16, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.bfloat16)
    m32, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.float32)
    before = swin_attn.launches
    with torch.inference_mode():
        kern = m16(x).float()
        swin_mod.swin_window_attention = swin_attn.swin_window_attention_plain
        try:
            plain = m16(x).float()
            ref = m32(x).float()
        finally:
            swin_mod.swin_window_attention = swin_attn.swin_window_attention
    assert swin_attn.launches - before == 12
    err = {}
    for name, out in (("kernels", kern), ("plain", plain)):
        d = (out - ref).abs()
        err[name] = (float(d.mean()), float(d.max()))
    ok = all(err["kernels"][i] <= 1.5 * err["plain"][i] for i in (0, 1))
    log(f"  bf16 forward of {B} windows vs the f32 plain forward: kernels "
        f"mean/max logit error {err['kernels'][0]:.4e} / "
        f"{err['kernels'][1]:.4e}, plain bf16 attention "
        f"{err['plain'][0]:.4e} / {err['plain'][1]:.4e} (|f32 logits| max "
        f"{float(ref.abs().max()):.3e}; limit 1.5x the plain's) "
        f"{'ok' if ok else 'FAIL'}")
    assert all(torch.isfinite(t).all() for t in (kern, plain, ref))
    assert ok, err
    result["bf16_forward_error"] = dict(kernels=err["kernels"],
                                        plain=err["plain"])
    del m16, m32, kern, plain, ref
    torch.cuda.empty_cache()


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


# -- the band paths: streamed, fullconv, chunked fullconv, ESA -------------
BAND_ROWS = 8                      # tile rows a band (1824 x 7200 with halo)
MIN_STREAM_AGREEMENT = 0.9999      # f32 streamed vs window labels (see below)


def run_timed(fn):
    """``fn()``, the seconds from a synchronised start to a synchronised
    end, and the peak device memory over it in GiB (statistics reset
    just before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def band_segmenter(name: str, dtype):
    """A full-width ``name`` (random weights, seed 0) in the scene cells'
    engine (p 224, bc 256, 128 windows a forward; fullconv halo 16)."""
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model

    model, spec = build_model(name, NC, seed=0, dtype=dtype)
    return SceneSegmenter(model, InferenceConfig(
        patch_size=224, border_correction=256, batch_tiles=128,
        num_classes=NC), stride_product=spec.stride_product)


def scene_path(name: str, path: str, fn, window_tps: float, k1: int = 0,
               warm: bool = True, varied: bool = True):
    """One whole-scene path on the full-size scene: a first run (``warm``:
    new shapes, the mask cache), then one with the launch counters zeroed
    just before and read just after, timed to its labels on the host or,
    for a device map, on the device. Returns (host labels, numbers)."""
    from cvcs_tpu_torch.infer.engine import labels_to_host

    if warm:
        fn()
    reset_counts()
    lab, secs, peak = run_timed(fn)
    counts = kernel_counts()
    lab = labels_to_host(lab)
    classes = np.unique(lab)
    log(f"  {name} {path}: labels {lab.shape} {lab.dtype}, {len(classes)} "
        f"classes, 960 tiles in {secs:.3f} s = {960 / secs:.1f} tiles/s "
        f"(window path {window_tps:.1f} in this run); peak memory "
        f"{peak:.2f} GiB; hand-written kernel launches {counts} (K1 "
        f"expected {k1})")
    assert lab.shape == (6720, 7168) and lab.dtype == np.uint8
    assert classes.max() < NC and (len(classes) > 1 or not varied)
    assert counts["K1"] == k1, counts
    assert not any(v for k, v in counts.items() if k != "K1"), counts
    return lab, dict(tiles_per_s=960 / secs, seconds=secs, peak_gib=peak,
                     launches=counts["K1"])


def differ_line(what: str, a: np.ndarray, b: np.ndarray) -> float:
    n = int((a != b).sum())
    log(f"  {what}: {n} of {a.size} pixels differ "
        f"({(1 - n / a.size) * 100:.4f}% agree)")
    return 1 - n / a.size


def streamed_rule(name: str, scene) -> float:
    """f32 (TF32 off) streamed labels against the window path's on the
    full-size scene: equal on every pixel, or on >= 99.99% with the count
    printed (cuDNN may pick another algorithm for a band's ragged batch;
    at 8 bands of 32 tile columns the batches are those of the window
    path, so none is expected)."""
    from cvcs_tpu_torch.infer.engine import labels_to_host

    seg = band_segmenter(name, torch.float32)
    want = labels_to_host(seg.predict_scene(scene))
    got = seg.predict_scene_streamed(scene, BAND_ROWS)
    agree = differ_line(f"{name} f32 streamed vs predict_scene", got, want)
    assert agree >= MIN_STREAM_AGREEMENT
    del seg
    torch.cuda.empty_cache()
    return agree


def swin_band_paths(result: dict, scene) -> None:
    """Full-width SwinUnet (seed 0, bf16) through the band paths on the
    full-size scene: streamed (K1 12 times a forward, 8 forwards), fullconv
    bands of 8 tile rows (4 band forwards: 48), the device-resident
    variant (equal bit for bit) and its 4 x 8-tile block grid, one band
    forward timed and traced; the f32 rules; the stage-1 mask's host
    cost; then ``cli.esa`` at p 512 on a raster that is not tile-aligned."""
    from PIL import Image

    from cvcs_tpu_torch.cli import esa as esa_cli
    from cvcs_tpu_torch.infer.engine import labels_to_host
    from cvcs_tpu_torch.models import swin as swin_mod
    from cvcs_tpu_torch.ops import swin_attn

    out = {}
    wtps = result["scene_tiles_per_s"]
    seg = band_segmenter("SwinUnet", torch.bfloat16)
    window, _, peak = run_timed(
        lambda: labels_to_host(seg.predict_scene(scene)))
    out["window_peak_gib"] = peak
    lab, out["streamed"] = scene_path(
        "SwinUnet", "predict_scene_streamed(band_rows=8)",
        lambda: seg.predict_scene_streamed(scene, BAND_ROWS), wtps,
        k1=12 * 8, warm=False)
    log(f"  SwinUnet peak memory: predict_scene {peak:.2f} GiB, streamed "
        f"{out['streamed']['peak_gib']:.2f} GiB")
    differ_line("SwinUnet bf16 streamed vs predict_scene", lab, window)

    # the mask's host cost: stage 1's region mask of a band, built in
    # numpy and copied to the card once per geometry
    dev = torch.device("cuda")
    _, secs, _ = run_timed(lambda: swin_mod.attn_bias.__wrapped__(
        456, 1800, 456, 1800, 8, 4, dev))
    out["stage1_bias_build_ms"] = secs * 1e3
    log(f"  stage-1 band mask (12,825 x 64 x 64 f32, 210 MB) built and "
        f"copied in {secs * 1e3:.1f} ms")

    fc, out["fullconv"] = scene_path(
        "SwinUnet", "predict_scene_fullconv(band_rows=8)",
        lambda: seg.predict_scene_fullconv(scene, BAND_ROWS), wtps, k1=48)
    differ_line("SwinUnet bf16 fullconv vs window labels (not a rule: "
                "other semantics)", fc, window)
    dev_lab, out["fullconv_padded"] = scene_path(
        "SwinUnet", "pad_scene_fullconv + predict_padded_fullconv",
        lambda: seg.predict_padded_fullconv(
            *seg.pad_scene_fullconv(scene), band_rows=BAND_ROWS),
        wtps, k1=48)
    assert np.array_equal(dev_lab, fc), "device-resident fullconv differs"
    log("  predict_padded_fullconv equals predict_scene_fullconv bit for "
        "bit")
    _, out["fullconv_chunks"] = scene_path(
        "SwinUnet", "predict_padded_fullconv(fullconv_chunks [4, 8])",
        lambda: seg.predict_padded_fullconv(
            *seg.pad_scene_fullconv(scene), band_rows=BAND_ROWS,
            row_tiles=4, col_tiles=8), wtps, k1=48)

    padded, _, _, halo = seg.pad_scene_fullconv(scene)
    band = padded[None, :BAND_ROWS * 224 + 2 * halo]
    del padded

    def forward():
        return seg._fullconv_forward(band, BAND_ROWS * 224, 7168, halo)

    ms = cuda_ms(forward, iters=5, warmup=1)
    prof = device_profile(forward)
    out["band_forward"] = dict(ms=ms, kernel_ms=prof["kernel_ms"],
                               span_ms=prof["span_ms"],
                               idle_share=prof["idle_share"],
                               conv_ms=prof["conv_ms"], k1_ms=prof["K1"])
    log(f"  SwinUnet one fullconv band forward ({tuple(band.shape[1:3])}, "
        f"bf16): {ms:.3f} ms (CUDA events); traced: kernels "
        f"{prof['kernel_ms']:.3f} ms over {prof['span_ms']:.3f} ms, idle "
        f"{prof['idle_share'] * 100:.1f}%, K1 {prof['K1']:.3f} ms = "
        f"{prof['K1'] / prof['kernel_ms'] * 100:.1f}%, convolutions and "
        f"GEMMs {prof['conv_ms']:.3f} ms")
    for k, (t, n) in sorted(prof["by_name"].items(),
                            key=lambda kv: -kv[1][0])[:6]:
        log(f"    {t:9.3f} ms {n:4d}x {k[:90]}")
    del seg, band
    torch.cuda.empty_cache()

    out["f32_streamed_agreement"] = streamed_rule("SwinUnet", scene)
    seg = band_segmenter("SwinUnet", torch.float32)
    reset_counts()
    kern = seg.predict_scene_fullconv(scene, BAND_ROWS)
    assert swin_attn.launches == 48, swin_attn.launches
    swin_mod.swin_window_attention = swin_attn.swin_window_attention_plain
    try:
        plain = seg.predict_scene_fullconv(scene, BAND_ROWS)
    finally:
        swin_mod.swin_window_attention = swin_attn.swin_window_attention
    agree = differ_line("SwinUnet f32 fullconv, kernel vs plain attention",
                        kern, plain)
    assert agree >= 0.999
    out["f32_fullconv_agreement"] = agree
    del seg
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "esa_in.png", Path(tmp) / "esa.png"
        Image.fromarray(synthetic_scene(2600, 3100, seed=5)).save(src)
        reset_counts()
        _, secs, peak = run_timed(lambda: esa_cli.run(dict(
            image=str(src), net="SwinUnet", num_classes=15,
            precision="bf16", out_image=str(dst))))
        counts = kernel_counts()
        got = np.asarray(Image.open(dst))
        log(f"  cli.esa SwinUnet p 512 on 2600x3100: map {got.shape} in "
            f"{secs:.2f} s (model build, decode and PNG included; 30 "
            f"tiles), peak {peak:.2f} GiB; launches {counts} (K1 expected "
            f"12: one forward)")
        assert got.shape == (2560, 3072, 3) and counts["K1"] == 12
        out["esa"] = dict(seconds=secs, peak_gib=peak, launches=counts["K1"])
    result["swin_bands"] = out


def other_band_paths(result: dict, scene) -> None:
    """Unetv2 (the serve recipe's model): streamed against the window path
    (the f32 rule) and fullconv bands of 8; Resnet101: fullconv bands of
    8; SegformerMod: fullconv_chunks [2, 4] (blocks of 480 x 928: a full
    1824 x 7200 band would give stage 1 a 820,800 x 12,825 score matrix)."""
    from cvcs_tpu_torch.infer.engine import labels_to_host

    out = {}
    seg = band_segmenter("Unetv2", torch.bfloat16)
    wtps = result["unet_scene_tiles_per_s"]
    window = labels_to_host(seg.predict_scene(scene))
    lab, out["unet_streamed"] = scene_path(
        "Unetv2", "predict_scene_streamed(band_rows=8)",
        lambda: seg.predict_scene_streamed(scene, BAND_ROWS), wtps,
        warm=False)
    differ_line("Unetv2 bf16 streamed vs predict_scene", lab, window)
    _, out["unet_fullconv"] = scene_path(
        "Unetv2", "predict_scene_fullconv(band_rows=8)",
        lambda: seg.predict_scene_fullconv(scene, BAND_ROWS), wtps)
    del seg
    torch.cuda.empty_cache()
    out["unet_f32_streamed_agreement"] = streamed_rule("Unetv2", scene)

    seg = band_segmenter("Resnet101", torch.bfloat16)
    _, out["resnet101_fullconv"] = scene_path(
        "Resnet101", "predict_scene_fullconv(band_rows=8)",
        lambda: seg.predict_scene_fullconv(scene, BAND_ROWS),
        result["deeplab_scene"]["Resnet101"]["tiles_per_s"], varied=False)
    del seg
    torch.cuda.empty_cache()

    seg = band_segmenter("SegformerMod", torch.bfloat16)
    _, out["segformer_fullconv_chunks"] = scene_path(
        "SegformerMod", "predict_padded_fullconv(fullconv_chunks [2, 4])",
        lambda: seg.predict_padded_fullconv(
            *seg.pad_scene_fullconv(scene), band_rows=BAND_ROWS,
            row_tiles=2, col_tiles=4),
        result["segformer_scene"]["tiles_per_s"], varied=False)
    del seg
    torch.cuda.empty_cache()
    result["other_bands"] = out


# -- retrieval: cli.retrieve over a GID15-sized candidate pool ---------------
RETRIEVAL_SCENE = (6720, 7168)     # the largest multiple of 224 in 6800 x 7200
RETRIEVAL_BLOCK = 112              # label blocks: 4 a patch, so scores tie
TOL_SCORES = 1e-6                  # card scores vs host reference, absolute
TOL_EMBED = 1e-4                   # f32 card vs CPU, x max(1, |CPU|max)
EMBED_CHECK = 16                   # patches whose embeddings card and CPU give
EMBED_BATCH = 16                   # the entry point's default batch_size
EMBED_TIMED = 20                   # batches the embedding rate is timed over
SCORE_ORDER = (("emd", False), ("miou", True), ("wiou", True),
               ("pprec", True))


def vit_flops(variant: str) -> float:
    """Operations of one DINO trunk's forward at p 224: per block
    24·T·d² (QKV, projection and MLP products) + 4·T²·d (the two
    attention products), T tokens of width d."""
    from cvcs_tpu_torch.models.vit import VIT_VARIANTS

    v = VIT_VARIANTS[variant]
    t, d = (224 // v["patch"]) ** 2 + 1, v["dim"]
    return v["depth"] * (24 * t * d * d + 4 * t * t * d)


def retrieval_dataset(root: Path, shape=RETRIEVAL_SCENE, n: int = 2) -> str:
    """Two (or ``n``) 6720 x 7168 scenes (or ``shape``; uncompressed
    TIFF, so decoding is a copy) with labels in 112 x 112 blocks, seeded:
    1,920 patches at p 224."""
    from PIL import Image

    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    rng = np.random.default_rng(40)
    h, w = shape
    b = RETRIEVAL_BLOCK
    blocks = [rng.integers(0, NC, (h // b, w // b), dtype=np.uint8)
              for _ in range(n)]

    def write(i):
        Image.fromarray(synthetic_scene(h, w, 40 + i)).save(
            root / "Image__8bit_NirRGB" / f"s{i}.tif")
        Image.fromarray(np.kron(blocks[i], np.ones((b, b), np.uint8))).save(
            root / "Annotation__index" / f"s{i}_15label.tif")

    with ThreadPoolExecutor(min(n, 4)) as pool:   # numpy and PIL drop the lock
        list(pool.map(write, range(n)))
    return str(root)


def _class_sum(x: np.ndarray) -> np.ndarray:
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = (acc + x[:, i]).astype(np.float32)
    return acc


def _class_cumsum(x: np.ndarray) -> np.ndarray:
    out = [x[:, 0]]
    for i in range(1, x.shape[1]):
        out.append((out[-1] + x[:, i]).astype(np.float32))
    return np.stack(out, axis=1)


def host_scores(t: np.ndarray, q: np.ndarray) -> dict:
    """The four mask scores of ``q`` (B, H, W) against ``t`` (H, W) on the
    host, by another route than ``retrieval/scores.py``: every count from
    one joint (target class, query class) histogram a query, then f32
    ratios and class-order f32 sums."""
    f32 = np.float32
    b = q.shape[0]
    codes = (t.reshape(1, -1).astype(np.int32) * NC + q.reshape(b, -1)
             + (np.arange(b, dtype=np.int32) * NC * NC)[:, None])
    joint = np.bincount(codes.ravel(), minlength=b * NC * NC).reshape(
        b, NC, NC)                               # [query, t class, q class]
    inter = joint[:, np.arange(NC), np.arange(NC)][:, 1:]
    tcount, qcount = joint.sum(2)[:, 1:], joint.sum(1)[:, 1:]
    union = tcount + qcount - inter
    iou = np.where(union > 0, inter.astype(f32)
                   / np.maximum(union, 1).astype(f32), f32(0))
    support = tcount[0]
    n_fg = f32(max(int(support.sum()), 1))

    def hist(c):
        tot = c.sum(1, keepdims=True)
        return np.where(tot > 0, c.astype(f32)
                        / np.maximum(tot, 1).astype(f32), f32(0))

    return {
        "miou": _class_sum(iou)
        / np.maximum((union > 0).sum(1), 1).astype(f32),
        "wiou": _class_sum(iou * (support.astype(f32) / n_fg)[None]),
        "pprec": inter.sum(1).astype(f32) / n_fg,
        "emd": _class_sum(np.abs(_class_cumsum(hist(tcount[:1]))
                                 - _class_cumsum(hist(qcount)))),
    }


def tie_runs(order, values) -> dict:
    """Candidate id -> its run in the reference ranking: a run ends where
    neighbouring reference scores differ by more than ``TOL_SCORES``
    (``tests/test_torch_retrieval.py``'s tie rule)."""
    runs, run = {}, 0
    for i, k in enumerate(order):
        prev = float(values[order[i - 1]])
        if i and abs(float(values[k]) - prev) > TOL_SCORES:
            run += 1
        runs[int(k)] = run
    return runs


def traced_breakdown(what: str, fn) -> dict | None:
    """One call of ``fn`` traced: device kernel time over the span, the
    idle share, the launches, and the four costliest kernels; None ("not
    measured") when the profiler recorded nothing."""
    prof = phase7_profile(fn)
    if prof is None:
        return None
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:4]
    launches = sum(c for _, c in prof["by_name"].values())
    log(f"    {what} traced: kernels {prof['kernel_ms']:.3f} ms over a "
        f"{prof['span_ms']:.3f} ms span, idle {prof['idle_share'] * 100:.1f}%"
        f", {launches} launches; "
        + "; ".join(f"{t:.3f} ms {n}x {k[:60]}" for k, (t, n) in top))
    return dict(kernel_ms=prof["kernel_ms"], span_ms=prof["span_ms"],
                idle_share=prof["idle_share"], launches=launches,
                top=[dict(name=k[:90], ms=t, count=n) for k, (t, n) in top])


def check_mask_retrieval(got: dict, masks: torch.Tensor) -> dict:
    """The first three probes' card scores against :func:`host_scores`
    (within ``TOL_SCORES``; bit-equal elements counted), and the entry
    point's top-10 rankings against the host scores' under the tie rule;
    the card's time to score one probe against the pool."""
    from cvcs_tpu_torch.retrieval.scores import SCORE_NAMES, compute_scores

    host = masks.cpu().numpy()
    worst, equal, total, runs_seen = 0.0, 0, 0, []
    for r in got["mask_rankings"][:3]:
        p = r["probe"]
        card = compute_scores(masks[p], masks, NC)
        card = dict(zip(SCORE_NAMES, torch.stack(
            [card[k] for k in SCORE_NAMES]).cpu().numpy()))
        ref = host_scores(host[p], host)
        for key, higher in SCORE_ORDER:
            worst = max(worst, float(np.abs(card[key] - ref[key]).max()))
            equal += int((card[key] == ref[key]).sum())
            total += card[key].size
            order = np.argsort(ref[key])
            order = [int(k) for k in (order[::-1] if higher else order)
                     if k != p]
            runs = tie_runs(order, ref[key])
            runs_seen.append(len(set(runs.values())))
            assert ([runs[k] for k in r[key]]
                    == [runs[k] for k in order[:len(r[key])]]), (p, key)
    probe = got["mask_rankings"][0]["probe"]
    score_ms = cuda_ms(lambda: compute_scores(masks[probe], masks, NC))
    trace = traced_breakdown("compute_scores of one probe",
                             lambda: compute_scores(masks[probe], masks, NC))
    log(f"  scores of 3 probes x {masks.shape[0]} masks on the card vs the "
        f"host reference: max |diff| {worst:.3g} (tolerance {TOL_SCORES}), "
        f"{equal} of {total} bit-equal; the top-10 rankings agree under the "
        f"tie rule ({min(runs_seen)}-{max(runs_seen)} runs of ties among "
        f"{masks.shape[0] - 1} candidates); compute_scores {score_ms:.3f} ms"
        f" a probe (CUDA events, mean of 10)")
    assert worst <= TOL_SCORES
    return dict(max_abs_err=worst, bit_equal=equal, compared=total,
                score_ms_per_probe=score_ms, trace=trace)


def embed_rate(cfg: dict, images: torch.Tensor) -> dict:
    """The embedder of ``cfg`` alone on the card: patches/s over
    ``EMBED_TIMED`` batches after one to warm, synchronised; one batch
    traced; and its f32 embeddings of the first ``EMBED_CHECK`` patches."""
    from cvcs_tpu_torch.cli import retrieve as retrieve_cli

    embed, _ = retrieve_cli.build_embedder(cfg, torch.device("cuda"))
    batches = [images[s:s + EMBED_BATCH] for s in range(
        0, EMBED_TIMED * EMBED_BATCH, EMBED_BATCH)]
    embed(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = torch.cat([embed(b) for b in batches])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert torch.isfinite(emb).all()
    trace = traced_breakdown(f"{cfg['net']}, one batch of {EMBED_BATCH}",
                             lambda: embed(batches[0]))
    on_card, _ = retrieve_cli.build_embedder(dict(cfg, precision="f32"),
                                             torch.device("cuda"))
    return dict(dim=int(emb.shape[1]),
                patches_per_s=EMBED_TIMED * EMBED_BATCH / secs, trace=trace,
                f32_card=on_card(images[:EMBED_CHECK]).cpu())


def retrieval_path(result: dict):
    """``cli.retrieve``'s entry point over two GID15-sized scenes (1,920
    patches at p 224 on the card): mask-only (10 probes, top 10; scores and
    rankings against the host reference); then ``net: vitb8`` and
    ``vits16`` (DINO-named ``.pth`` of seeded random weights through
    ``load_checkpoint``, bf16) and the zoo taps of MobileNet (max-pooled,
    960-d) and Unetv2 (x5, 1024-d), each with its embedding rate, the peak
    memory above the run's start, and the card's f32 embeddings of
    ``EMBED_CHECK`` patches. The CPU's f32 embeddings of the same patches
    are computed on a worker thread after the card's measurements, while
    the caller goes on (the CPU's ViT-B/8 takes seconds); the returned
    callable waits for them and holds the card's against them."""
    from cvcs_tpu_torch.cli import retrieve as retrieve_cli
    from cvcs_tpu_torch.models.vit import dino_vit

    def timed(cfg):
        base = torch.cuda.memory_allocated() / 2 ** 30
        got, secs, peak = run_timed(lambda: retrieve_cli.retrieve(dict(cfg)))
        return got, secs, peak - base

    out, on_cpu = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = retrieval_dataset(tmp / "pool")
        log(f"  two {RETRIEVAL_SCENE[0]} x {RETRIEVAL_SCENE[1]} scenes "
            f"written in {time.perf_counter() - t0:.2f} s")
        base = dict(dataset=root, patch_size=224, num_probes=10, topk=10,
                    seed=0)
        got, secs, peak = timed(base)
        n = 2 * (RETRIEVAL_SCENE[0] // 224) * (RETRIEVAL_SCENE[1] // 224)
        assert got["num_probes"] == 10 and len(got["mask_rankings"]) == 10
        for r in got["mask_rankings"]:
            for key, _ in SCORE_ORDER:
                assert len(r[key]) == 10 and r["probe"] not in r[key]
        images, masks = retrieve_cli.candidate_pool(base,
                                                    torch.device("cuda"))
        assert images.shape[0] == masks.shape[0] == n
        log(f"  cli.retrieve mask-only, {n} patches on the card "
            f"({images.numel() / 1e6:.0f} MB of images, "
            f"{masks.numel() / 1e6:.0f} MB of masks): {secs:.2f} s, peak {peak:.2f} GiB above its "
            f"start; timings {got['timings']}; "
            f"{got['timings']['scores_s'] * 100:.1f} ms a probe end to end")
        out["mask_only"] = dict(seconds=secs, peak_gib=peak,
                                timings=got["timings"],
                                **check_mask_retrieval(got, masks))
        del masks
        for net in ("vitb8", "vits16", "MobileNet", "Unetv2"):
            cfg = dict(base, net=net)
            if net.startswith("vit"):
                ckpt = tmp / f"dino_{net}.pth"
                torch.save(dino_vit(net, seed=0).state_dict(), ckpt)
                cfg["load_checkpoint"] = str(ckpt)
            got, secs, peak = timed(cfg)
            ag = got["agreement"]
            assert set(ag) >= {"top1", "top5", "top10", "top5to50"}
            assert all(0.0 <= v <= 1.0 for v in ag.values())
            emb = embed_rate(cfg, images)
            rate = ""
            if net.startswith("vit"):
                flops = vit_flops(net)
                emb.update(gflop_per_patch=flops / 1e9,
                           tflops=flops * emb["patches_per_s"] / 1e12,
                           bound_patches_per_s=PEAK_FLOPS[torch.bfloat16]
                           / flops)
                rate = (f" = {emb['tflops']:.1f} TFLOP/s of its "
                        f"{emb['gflop_per_patch']:.2f} GFLOP a patch (bf16 "
                        f"peak: {emb['bound_patches_per_s']:.0f} patches/s)")
            log(f"  cli.retrieve net {net} bf16: {secs:.2f} s, peak "
                f"{peak:.2f} GiB above its start, timings {got['timings']}; "
                f"agreement { {k: round(v, 3) for k, v in ag.items()} }; the"
                f" embedder alone {emb['patches_per_s']:.1f} patches/s over "
                f"{EMBED_TIMED} batches of {EMBED_BATCH}{rate}; "
                f"{emb['dim']}-d")
            out[net] = dict(seconds=secs, peak_gib=peak,
                            timings=got["timings"], agreement=ag, **emb)
            on_cpu[net], _ = retrieve_cli.build_embedder(
                dict(cfg, precision="f32"), torch.device("cpu"))
        host = images[:EMBED_CHECK].cpu()
        del images
    result["retrieval"] = out
    torch.cuda.empty_cache()
    worker = ThreadPoolExecutor(1)
    refs = {net: worker.submit(fn, host) for net, fn in on_cpu.items()}

    def compare() -> None:
        for net, ref in refs.items():
            want = ref.result()
            got = out[net].pop("f32_card")
            err = (float((got - want).abs().max())
                   / max(1.0, float(want.abs().max())))
            log(f"  {net} f32 embeddings of {EMBED_CHECK} patches, card vs "
                f"CPU: {err:.3g} of scale (tolerance {TOL_EMBED})")
            assert err <= TOL_EMBED, (net, err)
            out[net]["f32_card_vs_cpu"] = err
        worker.shutdown()

    return compare


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
    k5_launches = sum(n for k, (_, n) in load["by_name"].items()
                      if "augment_kernel" in k)
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
        f" ms (K5 {load['K5']:.3f} ms in {k5_launches} launches) over a "
        f"{load['span_ms']:.3f} ms span,"
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
                K5_launches_traced=k5_launches, shares=shares,
                top=[dict(name=k[:90], ms_per_step=t / 4, count=n // 4)
                     for k, (t, n) in top])


def train_config(data: dict, net: str, epochs: int, ckpt_dir: Path,
                 metrics_log: Path) -> dict:
    """The recipe's geometry (p 224, batch 10, wCEL with ignore_background,
    SGD2, bf16, random_shift) with ``augmentation: fused`` on the train
    cell's cuts."""
    return dict(data, checkpoint_directory=str(ckpt_dir), device="gpu",
                net=net, epochs=epochs, chunk_size=2, validation_chunk_size=1,
                patch_size=224, batch_size=B_TRAIN, loss="wCEL", opt="SGD2",
                ignore_background=True, random_shift=True,
                augmentation="fused", freq=1, precision_evaluation_freq=1,
                num_classes=15, verbose=True, precision="bf16", seed=0,
                metrics_log=str(metrics_log))


def run_train_main(cfg: dict, path: Path, name: str) -> dict:
    """``cli.train``'s ``main`` on ``cfg``: its counts (K5 once per chunk,
    no other kernel), finite losses, the epoch's throughput."""
    import yaml

    from cvcs_tpu_torch.cli import train as train_cli

    path.write_text(yaml.safe_dump(cfg))
    reset_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(["train", str(path)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernel_counts()
    assert rc == 0, rc
    epochs = cfg["epochs"]
    metrics = [json.loads(x) for x in
               Path(cfg["metrics_log"]).read_text().splitlines()]
    meta = json.loads((Path(cfg["checkpoint_directory"])
                       / f"checkpoint{epochs}" / "meta.json").read_text())
    losses = meta["training_loss_values"]
    log(f"  cli.train {name} bf16, {epochs} epoch(s) x {STEPS_PER_EPOCH} "
        f"steps in {secs:.2f} s (model build, class weights, validation and "
        f"evaluation included); epoch {epochs}: "
        f"{metrics[-1]['patches_per_s']:.1f} patches/s over "
        f"{metrics[-1]['epoch_s']:.2f} s; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; validation losses "
        f"{[round(v, 4) for v in meta['validation_loss_values'][::8]]}; "
        f"launches {counts} (expected K5 {epochs}, one per chunk, and no "
        f"other)")
    assert counts == dict(K1=0, K2=0, K3=0, K4=0, K5=epochs), counts
    assert len(losses) == epochs * STEPS_PER_EPOCH
    assert np.isfinite(losses).all()
    assert np.isfinite(meta["validation_loss_values"]).all()
    assert len(meta["conf_flat"]) == epochs
    return dict(launches=dict(K5=counts["K5"]), seconds=secs,
                patches_per_s=metrics[-1]["patches_per_s"],
                epoch_s=metrics[-1]["epoch_s"], first_loss=losses[0],
                last_loss=losses[-1], losses=losses)


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

        result["train"]["export"] = export_path(
            cfg, tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}", tmp)
        trainer = train_cli.build_trainer(dict(cfg, load_checkpoint=None))
        result["train"]["breakdown"] = train_breakdown(trainer)
        del trainer
    torch.cuda.empty_cache()


def export_path(cfg: dict, ckpt: Path, tmp: Path) -> dict:
    """``cli.export``'s ``main`` on the checkpoint the train run wrote: the
    file loads with ``strict=True`` into a fresh SwinUnet, whose logits on
    one validation batch equal those of a trainer restored from the same
    checkpoint, bit for bit."""
    import yaml

    from cvcs_tpu_torch.cli import export as export_cli
    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.models import build_model

    out = tmp / "swin_export.pt"
    path = tmp / "export.yaml"
    path.write_text(yaml.safe_dump(dict(
        net="SwinUnet", load_checkpoint=str(ckpt), output=str(out),
        num_classes=15)))
    t0 = time.perf_counter()
    assert export_cli.main(["export", str(path)]) == 0
    secs = time.perf_counter() - t0
    sd = torch.load(out, weights_only=True)
    fresh, _ = build_model("SwinUnet", NC, seed=1)
    fresh.load_state_dict(sd, strict=True)
    trainer = train_cli.build_trainer(dict(cfg, load_checkpoint=str(ckpt)))
    model = trainer.state.model.eval()
    batch = next(trainer.val_loader.get_chunk(0, shuffle_patches=False)
                 .batches(B_TRAIN, drop_last=False, pad_tail=False))
    with torch.no_grad():
        want, got = model(batch.image), fresh.eval()(batch.image)
    same = bool(torch.equal(got, want))
    log(f"  cli.export SwinUnet {ckpt.name}: {len(sd)} tensors, "
        f"{out.stat().st_size / 1e6:.1f} MB in {secs:.2f} s; loads strict "
        f"into a fresh SwinUnet; logits of {B_TRAIN} validation patches "
        f"equal the restored trainer's bit for bit: {same}")
    assert same
    return dict(tensors=len(sd), mb=out.stat().st_size / 1e6, seconds=secs,
                logits_equal=same)


def unet_train_path(result: dict, ckpts: Path) -> None:
    """The canonical Unetv2 recipe through the CLI's entry point (eager
    wCEL: no hand-written kernel runs), resumed; then one epoch of a
    ``Trainer`` built the same way with ``build_fused_ce`` as its loss,
    which must launch K3 once per train step and per validation batch and
    K4 once per train step. Its checkpoints go to ``ckpts / "Unetv2"``,
    where the ensemble phase reads them."""
    import yaml

    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.ops import fused_ce
    from cvcs_tpu_torch.train.loop import Trainer

    ckpt_dir = ckpts / "Unetv2"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # configs/train_unetv2.yaml, on the synthetic set and 2 epochs
        cfg = dict(
            train=synthetic_dataset(tmp / "train", 2, seed=20),
            validation=synthetic_dataset(tmp / "val", 1, seed=30),
            checkpoint_directory=str(ckpt_dir), device="gpu",
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
        meta = json.loads((ckpt_dir / f"checkpoint{TRAIN_EPOCHS}"
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

        cfg.update(load_checkpoint=str(ckpt_dir / "checkpoint1"),
                   metrics_log=str(tmp / "resume.jsonl"))
        path.write_text(yaml.safe_dump(cfg))
        assert train_cli.main(["train", str(path)]) == 0
        again = json.loads((ckpt_dir / f"checkpoint{TRAIN_EPOCHS}"
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


# -- SegFormer: SegformerMod (MiT-B3) at full width ----------------------------
SEGFORMER_PARAMETERS = 47_257_600  # 16 classes: the JAX model's count too
# bf16 labels vs f32 labels at random initial weights: the JAX package's
# own bf16 forward agrees with its f32 one on 98.50% of the pixels there
# (tests/test_torch_segformer.py, on the CPU), so a point below that
MIN_AGREEMENT = 0.975


def segformer_scene(result: dict, scene) -> None:
    """Full-width SegformerMod (random weights, seed 0, bf16) segments the
    full-size scene at the other scene phases' geometry; one forward is
    timed and traced. The JAX SegFormer reaches no Pallas kernel, so no
    hand-written kernel runs on this path."""
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.train.state import param_count

    cfg = InferenceConfig(patch_size=224, border_correction=256,
                          batch_tiles=128, num_classes=16)
    model, _ = build_model("SegformerMod", NC, seed=0, dtype=torch.bfloat16)
    n_params = param_count(model)
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
    log(f"  SegformerMod ({n_params:,} parameters, expected "
        f"{SEGFORMER_PARAMETERS:,}) predict_scene 6800x7200x3 bf16: labels "
        f"{lab.shape} {lab.dtype}, {len(classes)} classes, 960 tiles in "
        f"{secs:.2f} s = {960 / secs:.1f} tiles/s; hand-written kernel "
        f"launches {kernel_counts()} (none on this path)")
    assert n_params == SEGFORMER_PARAMETERS, n_params
    assert lab.shape == (6720, 7168) and lab.dtype == np.uint8
    assert classes.max() < NC
    assert not any(kernel_counts().values())
    result["segformer_scene"] = dict(
        parameters=n_params, tiles_per_s=960 / secs, seconds=secs,
        forward=forward_breakdown(model, "SegformerMod"))
    del model, seg, labels
    torch.cuda.empty_cache()


def segformer_train_path(result: dict, ckpts: Path) -> None:
    """SegformerMod through ``cli.train``'s ``main`` with the train cell's
    geometry and cuts and ``augmentation: fused`` (K5 once per chunk),
    resumed from checkpoint1 through ``build_trainer`` (what ``main``
    runs); ``cli.evaluate`` on the checkpoint the resumed run wrote, whose
    restored weights must equal the trainer's and whose metrics must
    match the trainer's own evaluation of the same state; the breakdown
    of a step; then one epoch through ``build_fused_ce`` (K3 per step and
    validation batch, K4 per step, K5 per chunk). Its checkpoints go to
    ``ckpts / "SegformerMod"``, where the ensemble phase reads them."""
    from cvcs_tpu_torch.cli import common
    from cvcs_tpu_torch.cli import evaluate as evaluate_cli
    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.ops import fused_ce
    from cvcs_tpu_torch.train.loop import Trainer

    ckpt_dir = ckpts / "SegformerMod"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = dict(train=synthetic_dataset(tmp / "train", 2, seed=20),
                    validation=synthetic_dataset(tmp / "val", 1, seed=30))
        cfg = train_config(data, "SegformerMod", TRAIN_EPOCHS, ckpt_dir,
                           tmp / "metrics.jsonl")
        out = run_train_main(cfg, tmp / "train.yaml", "SegformerMod")
        losses = out.pop("losses")
        steps = TRAIN_EPOCHS * STEPS_PER_EPOCH

        cfg.update(load_checkpoint=str(ckpt_dir / "checkpoint1"),
                   metrics_log=str(tmp / "resume.jsonl"))
        trainer = train_cli.build_trainer(cfg)
        trainer.train()
        hist = trainer.training_loss_values
        log(f"  resumed from checkpoint1: {len(hist)} training losses, the "
            f"first {STEPS_PER_EPOCH} equal to the first run's: "
            f"{hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]}; epoch 2 "
            f"again {hist[STEPS_PER_EPOCH]:.4f} -> {hist[-1]:.4f}; last "
            f"evaluation mIoU {trainer.last_metrics['mIoU']:.4f}")
        assert len(hist) == steps and np.isfinite(hist).all()
        assert hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]

        # cli.evaluate on the checkpoint the resumed run wrote
        eval_cfg = dict(dataset=cfg["validation"], net="SegformerMod",
                        patch_size=224, num_classes=15, precision="bf16",
                        ignore_background=True, batch_size=8,
                        load_checkpoint=str(ckpt_dir
                                            / f"checkpoint{TRAIN_EPOCHS}"))
        restored, _, _ = common.build_apply(
            eval_cfg, common.device_context(eval_cfg))
        want = trainer.state.model.state_dict()
        differ = [k for k, v in restored.state_dict().items()
                  if not torch.equal(v, want[k])]
        del restored
        reset_counts()
        t0 = time.perf_counter()
        ev = evaluate_cli.evaluate(eval_cfg)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        gap = max(abs(ev[k] - trainer.last_metrics[k])
                  for k in ("mIoU", "oa_score", "dice_score"))
        log(f"  cli.evaluate {eval_cfg['load_checkpoint'][-11:]} on the "
            f"validation scene (80 patches) in {eval_s:.2f} s: restored "
            f"weights equal to the trainer's in {len(want) - len(differ)} of "
            f"{len(want)} tensors; mIoU {ev['mIoU']:.6f}, OA "
            f"{ev['oa_score']:.6f} vs the trainer's evaluation "
            f"{trainer.last_metrics['mIoU']:.6f} / "
            f"{trainer.last_metrics['oa_score']:.6f} (largest gap {gap:.2e}, "
            f"limit 1e-3); launches {kernel_counts()}")
        assert not differ, differ[:5]
        assert gap <= 1e-3, gap
        assert not any(kernel_counts().values())
        out["evaluate"] = dict(seconds=eval_s, mIoU=ev["mIoU"],
                               oa=ev["oa_score"], gap=gap)
        result["segformer_trained"] = {k: v.detach().cpu().clone()
                                       for k, v in want.items()}
        out["breakdown"] = train_breakdown(trainer, "SegformerMod")
        del trainer

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
        want_counts = dict(K1=0, K2=0, K3=STEPS_PER_EPOCH + VAL_BATCHES,
                           K4=STEPS_PER_EPOCH, K5=1)
        log(f"  Trainer(loss_fn=build_fused_ce) SegformerMod bf16, 1 epoch "
            f"in {secs:.2f} s: losses {fused_losses[0]:.4f} -> "
            f"{fused_losses[-1]:.4f}; launches {counts} (expected "
            f"{want_counts}: K3 {STEPS_PER_EPOCH} steps + {VAL_BATCHES} "
            "validation batches, K4 a step, K5 a chunk)")
        assert counts == want_counts, counts
        assert len(fused_losses) == STEPS_PER_EPOCH
        assert np.isfinite(fused_losses).all()
        out["launches"].update(K3=counts["K3"], K4=counts["K4"],
                               K5_fused_epoch=counts["K5"])
        out.update(fused_epoch_s=secs,
                   fused_losses=[fused_losses[0], fused_losses[-1]])
        del trainer, base
    result["segformer_train"] = out
    torch.cuda.empty_cache()


def first_updates(state) -> dict:
    """The first SGD step's update of each parameter, lr * (grad + wd *
    p), in f64: what the step adds before it is rounded into the f32
    parameter. (A SegFormer update of 1e-7 on a weight near 0.3 is a few
    ulps of it, so the stored parameters cannot resolve 5e-2 of it.)"""
    group = state.optimizer.opt.param_groups[0]
    lr, wd = group["lr"], group["weight_decay"]
    return {k: lr * (p.grad.double() + wd * p.detach().double())
            for k, p in state.model.named_parameters()}


def segformer_correctness(result: dict) -> None:
    """One f32 SegformerMod step through K3/K4 vs one through the eager
    wCEL from the same weights, batch and dropout seed (the U-Net rule:
    loss 1e-5 relative, each parameter's update within 5e-2 of the eager
    one's, taken before the update is rounded into the parameters,
    ``first_updates``; a loss passing half its gradient must fail); two bf16 steps
    from one seed give bit-equal losses and another dropout seed another
    loss; a bf16 forward's logits are within the bf16 parity tolerance
    (``TOL``, x max(1, |f32|max)) of an f32 forward's and its labels agree
    on >= ``MIN_AGREEMENT`` of the pixels, at the random initial weights
    (the share with the weights the train phase reached is printed: after
    32 steps on random labels the loss is still near ln 16, the logits
    near a tie, so bf16 rounding flips more labels there)."""
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
    weights = class_weights(np.bincount(mask[mask < NC].numpy(),
                                        minlength=NC), True)
    mask = mask.to(torch.int32).cuda()
    fused = fused_ce.build_fused_ce(weights, ignore_background=True)
    eager = losses.build_loss("wCEL", weights=weights, ignore_background=True,
                              device="cuda")

    def one_step(loss_fn, dtype, dropout_seed=0xD0):
        model, _ = build_model("SegformerMod", NC, seed=0, dtype=dtype)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        state = TrainState(model, opt, dropout_seed=dropout_seed)
        loss = float(train_step(state, loss_fn, image, mask))
        return loss, first_updates(state), model.state_dict()

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    before = kernel_counts()
    f_loss, f_upd, f_sd = one_step(fused, torch.float32)
    after = kernel_counts()
    assert (after["K3"] - before["K3"], after["K4"] - before["K4"]) == (1, 1)
    e_loss, e_upd, e_sd = one_step(eager, torch.float32)
    _, e2_upd, e2_sd = one_step(eager, torch.float32)
    h_loss, h_upd, _ = one_step(half_fused, torch.float32)
    rel = abs(f_loss - e_loss) / abs(e_loss)
    names, zero = list(e_upd), {k: 0.0 for k in e_upd}
    upd, upd_max = update_err(f_upd, e_upd, zero, names)
    upd_half, _ = update_err(h_upd, e_upd, zero, names)
    upd_again, _ = update_err(e2_upd, e_upd, zero, names)
    # the same comparisons read from the stored f32 parameters
    start = build_model("SegformerMod", NC, seed=0, dtype=torch.float32)[0]
    start = start.state_dict()
    stored = update_err(f_sd, e_sd, start, names)[0]
    stored_again = update_err(e2_sd, e_sd, start, names)[0]
    log(f"  f32 SegformerMod step, fused K3/K4 vs eager wCEL (same dropout "
        f"seed): loss {f_loss:.6f} vs {e_loss:.6f} (relative {rel:.2e}, tol "
        f"1e-5); largest parameter update {upd_max:.3e}; update error "
        f"{upd:.2e} (tol {TOL_UPDATE:.0e}; a second eager step "
        f"{upd_again:.2e}); with half the gradient {upd_half:.2e} (must "
        f"fail). Read from the stored f32 parameters instead: fused "
        f"{stored:.2e}, a second eager step {stored_again:.2e}")
    assert rel <= 1e-5 and upd <= TOL_UPDATE
    assert h_loss == f_loss and upd_half > TOL_UPDATE
    del f_upd, e_upd, e2_upd, h_upd, f_sd, e_sd, e2_sd, start

    seeded = [one_step(eager, torch.bfloat16, s)[0] for s in (0xD0, 0xD0,
                                                             0xD1)]
    log(f"  bf16 steps, dropout seed 0xD0 twice and 0xD1: losses "
        f"{seeded[0]!r}, {seeded[1]!r}, {seeded[2]!r} (the first two must be "
        "bit-equal, the third not)")
    assert seeded[0] == seeded[1] and seeded[2] != seeded[0]

    x = torch.from_numpy(synthetic_scene(1792, 2240, seed=30)[:896, :1120]
                         .reshape(4, 224, 5, 224, 3).transpose(0, 2, 1, 3, 4)
                         .reshape(20, 224, 224, 3).copy()).cuda().float()
    agreement, logit_err = {}, {}
    for which in ("initial", "trained"):
        models = {}
        for dt in (torch.float32, torch.bfloat16):
            models[dt], _ = build_model("SegformerMod", NC, seed=0, dtype=dt)
            if which == "trained":
                models[dt].load_state_dict(result["segformer_trained"])
        with torch.inference_mode():
            out32 = models[torch.float32](x)
            out16 = models[torch.bfloat16](x)
        agreement[which] = float((out32.argmax(-1) == out16.argmax(-1))
                                 .float().mean())
        scale = max(1.0, float(out32.abs().max()))
        logit_err[which] = float((out16 - out32).abs().max()) / scale
        del models, out32, out16
    log(f"  bf16 vs f32 SegformerMod on 20 patches of the validation scene: "
        f"labels agree on {agreement['initial'] * 100:.3f}% with the random "
        f"initial weights (limit {MIN_AGREEMENT * 100:.1f}%), "
        f"{agreement['trained'] * 100:.3f}% with the trained ones; max logit "
        f"error / max(1, |f32|max) {logit_err['initial']:.2e} and "
        f"{logit_err['trained']:.2e} (limit {TOL[torch.bfloat16]:.0e})")
    assert agreement["initial"] >= MIN_AGREEMENT
    assert max(logit_err.values()) <= TOL[torch.bfloat16]
    result["segformer_correctness"] = dict(
        f32_fused_vs_eager_loss_rel=rel, f32_fused_vs_eager_update_err=upd,
        largest_update=upd_max, half_gradient_update_err=upd_half,
        eager_again_update_err=upd_again,
        stored_param_update_err=dict(fused=stored, eager_again=stored_again),
        seeded_losses=seeded, bf16_label_agreement=agreement,
        bf16_logit_err=logit_err)
    del result["segformer_trained"]
    torch.cuda.empty_cache()


# -- DeepLab: Resnet101 and MobileNet at full width, and the Ensemble ---------
DEEPLAB_PARAMETERS = {"Resnet101": 58_629_712, "Resnet50": 39_637_584,
                      "MobileNet": 11_024_192, "MobileNetGoogle": 12_133_560,
                      "MobileNetResnet18": 20_775_480}  # 16 classes, = JAX's
# bf16 labels vs f32 labels of Resnet101 at random initial weights: the
# JAX package's own bf16 forward agrees with its f32 one on 99.98% of the
# pixels there (the port's on 99.83%; tests/test_torch_deeplab.py, on the
# CPU), so a point below
MIN_AGREEMENT_R101 = 0.989
TOL_CARD_CPU = 1e-4                # f32 logits, x max(1, |CPU|max)


def deeplab_scene(result: dict, scene) -> None:
    """Full-width Resnet101 and MobileNet (random weights, seed 0, bf16)
    segment the full-size scene at the other scene phases' geometry; one
    forward of each is timed and traced. The JAX DeepLab reaches no Pallas
    kernel, so no hand-written kernel runs on this path."""
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.train.state import param_count

    cfg = InferenceConfig(patch_size=224, border_correction=256,
                          batch_tiles=128, num_classes=16)
    out = {}
    for name in ("Resnet101", "MobileNet"):
        model, _ = build_model(name, NC, seed=0, dtype=torch.bfloat16)
        n_params = param_count(model)
        seg = SceneSegmenter(model, cfg)
        seg.predict_scene(scene[:1792, :2240])      # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        labels = seg.predict_scene(scene)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lab = labels.cpu().numpy()
        classes = np.unique(lab)
        log(f"  {name} ({n_params:,} parameters, expected "
            f"{DEEPLAB_PARAMETERS[name]:,}) predict_scene 6800x7200x3 bf16: "
            f"labels {lab.shape} {lab.dtype}, {len(classes)} classes, 960 "
            f"tiles in {secs:.2f} s = {960 / secs:.1f} tiles/s; hand-written "
            f"kernel launches {kernel_counts()} (none on this path)")
        assert n_params == DEEPLAB_PARAMETERS[name], n_params
        assert lab.shape == (6720, 7168) and lab.dtype == np.uint8
        assert classes.max() < NC
        assert not any(kernel_counts().values())
        out[name] = dict(parameters=n_params, tiles_per_s=960 / secs,
                         seconds=secs, forward=forward_breakdown(model, name))
        del model, seg, labels
        torch.cuda.empty_cache()
    result["deeplab_scene"] = out


def deeplab_train_path(result: dict, ckpts: Path) -> None:
    """Resnet101 through ``cli.train``'s ``main`` with the recipe's
    geometry and ``augmentation: fused`` on the train cell's cuts (K5 once
    per chunk), resumed from checkpoint1; one epoch of a ``Trainer`` built
    the same way with ``build_fused_ce`` (K3 per step and validation
    batch, K4 per step, K5 per chunk), whose steps are timed and traced;
    then MobileNet for one epoch through ``main``, and its steps timed and
    traced. The checkpoints go to ``ckpts / net``, where the ensemble
    phase reads them."""
    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.ops import fused_ce
    from cvcs_tpu_torch.train.loop import Trainer

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = dict(train=synthetic_dataset(tmp / "train", 2, seed=20),
                    validation=synthetic_dataset(tmp / "val", 1, seed=30))
        cfg = train_config(data, "Resnet101", TRAIN_EPOCHS,
                           ckpts / "Resnet101", tmp / "r101.jsonl")
        r101 = run_train_main(cfg, tmp / "r101.yaml", "Resnet101")
        losses = r101.pop("losses")

        cfg.update(load_checkpoint=str(ckpts / "Resnet101" / "checkpoint1"),
                   metrics_log=str(tmp / "resume.jsonl"))
        trainer = train_cli.build_trainer(cfg)
        trainer.train()
        hist = trainer.training_loss_values
        log(f"  resumed from checkpoint1: {len(hist)} training losses, the "
            f"first {STEPS_PER_EPOCH} equal to the first run's: "
            f"{hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]}; epoch 2 "
            f"again {hist[STEPS_PER_EPOCH]:.4f} -> {hist[-1]:.4f}")
        assert len(hist) == len(losses) and np.isfinite(hist).all()
        assert hist[:STEPS_PER_EPOCH] == losses[:STEPS_PER_EPOCH]
        del trainer

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
        want = dict(K1=0, K2=0, K3=STEPS_PER_EPOCH + VAL_BATCHES,
                    K4=STEPS_PER_EPOCH, K5=1)
        log(f"  Trainer(loss_fn=build_fused_ce) Resnet101 bf16, 1 epoch in "
            f"{secs:.2f} s: losses {fused_losses[0]:.4f} -> "
            f"{fused_losses[-1]:.4f}; launches {counts} (expected {want}: "
            f"K3 {STEPS_PER_EPOCH} steps + {VAL_BATCHES} validation batches, "
            "K4 a step, K5 a chunk)")
        assert counts == want, counts
        assert len(fused_losses) == STEPS_PER_EPOCH
        assert np.isfinite(fused_losses).all()
        r101["launches"].update(K3=counts["K3"], K4=counts["K4"],
                                K5_fused_epoch=counts["K5"])
        r101.update(fused_epoch_s=secs,
                    fused_losses=[fused_losses[0], fused_losses[-1]],
                    breakdown=train_breakdown(trainer,
                                              "Resnet101 (fused loss)"))
        out["resnet101"] = r101
        del trainer, base
        torch.cuda.empty_cache()

        cfg = train_config(data, "MobileNet", 1, ckpts / "MobileNet",
                           tmp / "mobilenet.jsonl")
        mobilenet = run_train_main(cfg, tmp / "mobilenet.yaml", "MobileNet")
        del mobilenet["losses"]
        trainer = train_cli.build_trainer(dict(
            cfg, checkpoint_directory=str(tmp / "mobilenet_steps")))
        mobilenet["breakdown"] = train_breakdown(trainer, "MobileNet")
        out["mobilenet"] = mobilenet
        del trainer
    result["deeplab_train"] = out
    torch.cuda.empty_cache()


def deeplab_correctness(result: dict) -> None:
    """The five DeepLab names' f32 eval logits on the card against the same
    weights on the CPU (p 64, batch 2, cuDNN's deterministic algorithms,
    TF32 off): within ``TOL_CARD_CPU`` * max(1, |CPU|max), which holds
    cuDNN's dilated, depthwise and grouped convolutions to the CPU's. The
    bf16 Resnet101 labels against its f32 labels on 20 validation
    patches (>= ``MIN_AGREEMENT_R101``). One f32 Resnet101 step through
    K3/K4 against one through the eager wCEL by the U-Net and SegFormer
    rule (loss 1e-5 relative, each parameter's update within 5e-2 of the
    eager one's, ``first_updates``; half the gradient must fail). One SGD2
    step on MobileNetGoogle: its ``aux_layer``, which the head never
    reads, gets the momentum optax's decay gives it, wd * p exactly, and
    moves by lr times that, to within one f32 ulp."""
    import copy

    from cvcs_tpu_torch.data.reader import class_weights
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.ops import fused_ce, losses
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    out: dict = {"card_vs_cpu": {}}
    g = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (2, 64, 64, 3), generator=g).float()
    torch.backends.cudnn.deterministic = True
    try:
        for name in DEEPLAB_PARAMETERS:
            cpu, _ = build_model(name, NC, device="cpu", seed=0,
                                 dtype=torch.float32)
            card = copy.deepcopy(cpu).cuda()
            with torch.inference_mode():
                want = cpu(x)
                got = card(x.cuda()).cpu()
            err = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            out["card_vs_cpu"][name] = err
            same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            log(f"  {name} f32 p 64 batch 2, card vs CPU: max logit error / "
                f"max(1, |CPU|max) {err:.2e} (tol {TOL_CARD_CPU:.0e}); "
                f"labels agree on {same * 100:.3f}%")
            assert err <= TOL_CARD_CPU, (name, err)
            del cpu, card
    finally:
        torch.backends.cudnn.deterministic = False

    patches = torch.from_numpy(
        synthetic_scene(1792, 2240, seed=30)[:896, :1120]
        .reshape(4, 224, 5, 224, 3).transpose(0, 2, 1, 3, 4)
        .reshape(20, 224, 224, 3).copy()).cuda().float()
    logits = {}
    for dt in (torch.float32, torch.bfloat16):
        model, _ = build_model("Resnet101", NC, seed=0, dtype=dt)
        with torch.inference_mode():
            logits[dt] = model(patches)
        del model
    agree = float((logits[torch.float32].argmax(-1)
                   == logits[torch.bfloat16].argmax(-1)).float().mean())
    logit_err = float((logits[torch.bfloat16] - logits[torch.float32]).abs()
                      .max()) / max(1.0, float(logits[torch.float32].abs()
                                               .max()))
    log(f"  bf16 vs f32 Resnet101 on 20 patches of the validation scene: "
        f"labels agree on {agree * 100:.3f}% (limit "
        f"{MIN_AGREEMENT_R101 * 100:.1f}%); max logit error / max(1, "
        f"|f32|max) {logit_err:.2e}")
    assert agree >= MIN_AGREEMENT_R101
    out.update(bf16_label_agreement=agree, bf16_logit_err=logit_err)
    del logits, patches

    g = torch.Generator().manual_seed(7)
    image = torch.randint(0, 256, (B_TRAIN, 224, 224, 3), generator=g,
                          dtype=torch.uint8).cuda()
    blocks = torch.randint(0, NC, (B_TRAIN, 7, 7), generator=g)
    blocks[0, 0, :3] = 255                       # void
    mask = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    weights = class_weights(np.bincount(mask[mask < NC].numpy(),
                                        minlength=NC), True)
    mask = mask.to(torch.int32).cuda()
    fused = fused_ce.build_fused_ce(weights, ignore_background=True)
    eager = losses.build_loss("wCEL", weights=weights, ignore_background=True,
                              device="cuda")

    def one_step(name, loss_fn, img=image, msk=mask):
        model, _ = build_model(name, NC, seed=0, dtype=torch.float32)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        state = TrainState(model, opt)
        loss = float(train_step(state, loss_fn, img, msk))
        return loss, state

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    torch.backends.cudnn.deterministic = True
    try:
        before = kernel_counts()
        f_loss, state = one_step("Resnet101", fused)
        f_upd = first_updates(state)
        after = kernel_counts()
        assert (after["K3"] - before["K3"],
                after["K4"] - before["K4"]) == (1, 1)
        e_loss, state = one_step("Resnet101", eager)
        e_upd = first_updates(state)
        h_loss, state = one_step("Resnet101", half_fused)
        h_upd = first_updates(state)
        del state
    finally:
        torch.backends.cudnn.deterministic = False
    rel = abs(f_loss - e_loss) / abs(e_loss)
    names, zero = list(e_upd), {k: 0.0 for k in e_upd}
    upd, upd_max = update_err(f_upd, e_upd, zero, names)
    upd_half, _ = update_err(h_upd, e_upd, zero, names)
    log(f"  f32 Resnet101 step, fused K3/K4 vs eager wCEL: loss "
        f"{f_loss:.6f} vs {e_loss:.6f} (relative {rel:.2e}, tol 1e-5); "
        f"largest parameter update {upd_max:.3e}; update error {upd:.2e} "
        f"(tol {TOL_UPDATE:.0e}); with half the gradient {upd_half:.2e} "
        "(must fail)")
    assert rel <= 1e-5 and upd <= TOL_UPDATE
    assert h_loss == f_loss and upd_half > TOL_UPDATE
    out.update(f32_fused_vs_eager_loss_rel=rel,
               f32_fused_vs_eager_update_err=upd, largest_update=upd_max,
               half_gradient_update_err=upd_half)
    del f_upd, e_upd, h_upd
    torch.cuda.empty_cache()

    start = build_model("MobileNetGoogle", NC, seed=0,
                        dtype=torch.float32)[0].backbone.aux_layer
    start = {k: v.detach().clone() for k, v in start.named_parameters()}
    _, state = one_step("MobileNetGoogle", eager, image[:2], mask[:2])
    aux = state.model.backbone.aux_layer
    group = state.optimizer.opt.param_groups[0]
    moved = {}
    for k, p in aux.named_parameters():
        buf = state.optimizer.opt.state[p]["momentum_buffer"]
        want_buf = start[k] * group["weight_decay"]     # optax: 0 + wd * p
        want_p = start[k] - group["lr"] * want_buf
        ulps = ((p.detach() - want_p).abs()
                / torch.finfo(torch.float32).eps
                / want_p.abs().clamp(min=torch.finfo(torch.float32).tiny))
        moved[k] = dict(buffer_equal=bool(torch.equal(buf, want_buf)),
                        max_ulps=float(ulps.max()),
                        moved=int((p.detach() != start[k]).sum()),
                        size=p.numel())
        assert moved[k]["buffer_equal"] and moved[k]["max_ulps"] <= 1.0, (
            k, moved[k])
    assert {id(p) for p in state.unused} == {id(p) for p in aux.parameters()}
    log(f"  SGD2 step on MobileNetGoogle (p 224, batch 2): its unused "
        f"aux_layer's momentum equals wd * p exactly and the parameters are "
        f"within 1 ulp of p - lr * wd * p: {moved}")
    out["aux_layer_decay"] = moved
    result["deeplab_correctness"] = out
    del state
    torch.cuda.empty_cache()


def evaluate_confusion(cfg: dict) -> tuple[dict, np.ndarray, float]:
    """``cli.evaluate`` on ``cfg``: its metric dict, the confusion matrix
    it scored (caught at ``print_metrics``) and its seconds."""
    from cvcs_tpu_torch.cli import evaluate as evaluate_cli
    from cvcs_tpu_torch.metrics import scores

    confs = []
    print_metrics = scores.print_metrics

    def record(conf, *a, **kw):
        confs.append(np.asarray(conf))
        return print_metrics(conf, *a, **kw)

    scores.print_metrics = record
    try:
        t0 = time.perf_counter()
        ev = evaluate_cli.evaluate(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        scores.print_metrics = print_metrics
    assert len(confs) == 1
    return ev, confs[0], secs


def ensemble_path(result: dict, ckpts: Path) -> None:
    """The four-member ensemble of ``configs/ensemble_test.yaml`` (Unetv2,
    Resnet101, MobileNet, SegformerMod), each member the checkpoint the
    train phase wrote for it: ``cli.evaluate`` with ``net: Ensemble`` on
    the 80 validation patches, whose confusion matrix must equal the one
    of the members' own predictions voted on the host with numpy (the
    first maximum winning); then one ``predict_scene`` of the ensemble on
    a 1792 x 2240 raster."""
    import yaml

    from cvcs_tpu_torch.cli import common
    from cvcs_tpu_torch.data.loader import ChunkLoader
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

    members = {"Unetv2": ckpts / "Unetv2" / f"checkpoint{TRAIN_EPOCHS}",
               "Resnet101": ckpts / "Resnet101" / f"checkpoint{TRAIN_EPOCHS}",
               "MobileNet": ckpts / "MobileNet" / "checkpoint1",
               "SegformerMod": (ckpts / "SegformerMod"
                                / f"checkpoint{TRAIN_EPOCHS}")}
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        member_map = tmp / "ensemble.yaml"
        member_map.write_text(yaml.safe_dump(
            {k: str(v) for k, v in members.items()}, sort_keys=False))
        cfg = dict(dataset=synthetic_dataset(tmp / "val", 1, seed=30),
                   net="Ensemble", ensemble_config=str(member_map),
                   patch_size=224, num_classes=15, precision="bf16",
                   ignore_background=True, batch_size=8)
        reset_counts()
        ev, conf, secs = evaluate_confusion(cfg)
        assert not any(kernel_counts().values())

        device = torch.device("cuda")
        chunk = ChunkLoader(cfg["dataset"], chunk_size=1, patch_size=224,
                            seed=0, device=device).get_chunk(
                                0, shuffle_patches=False)
        votes = np.zeros(tuple(chunk.masks.shape) + (NC,), np.int32)
        agree = {}
        preds = {}
        for name, ckpt in members.items():
            model, _, _ = common.build_apply(
                dict(cfg, net=name, load_checkpoint=str(ckpt)), device)
            with torch.inference_mode():
                preds[name] = np.concatenate([
                    model(b.image.float()).argmax(-1).cpu().numpy()
                    for b in chunk.batches(cfg["batch_size"],
                                           drop_last=False)])
            votes += preds[name][..., None] == np.arange(NC)
            del model
        vote = votes.argmax(-1)                 # the first maximum
        for name, pred in preds.items():
            agree[name] = float((pred == vote).mean())
        target = chunk.masks.cpu().numpy()
        keep = (target > 0) & (target < NC)     # ignore_background
        want = np.zeros((NC, NC), np.int64)
        np.add.at(want, (target[keep], vote[keep]), 1)
        same = np.array_equal(conf, want)
        log(f"  cli.evaluate net: Ensemble ({', '.join(members)}) on the "
            f"validation scene (80 patches) in {secs:.2f} s: mIoU "
            f"{ev['mIoU']:.6f}; confusion matrix equal to the host vote of "
            f"the members' own predictions: {same} ({int(want.sum())} "
            f"pixels); each member's share of pixels equal to the vote: "
            + ", ".join(f"{k} {v * 100:.2f}%" for k, v in agree.items()))
        assert same
        out.update(evaluate_s=secs, mIoU=ev["mIoU"], member_agreement=agree)
        del chunk, votes, preds

        ens, spec, num_classes = common.build_apply(cfg, device)
        seg = SceneSegmenter(ens, InferenceConfig(
            patch_size=224, border_correction=256, batch_tiles=128,
            num_classes=num_classes), returns_logits=spec.returns_logits)
        raster = synthetic_scene(1792, 2240, seed=40)
        seg.predict_scene(raster[:448, :448])       # warm-up, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lab = seg.predict_scene(raster).cpu().numpy()
        secs = time.perf_counter() - t0
        classes = np.unique(lab)
        log(f"  Ensemble predict_scene 1792x2240x3 bf16 (stride product "
            f"{spec.stride_product}): labels {lab.shape} {lab.dtype}, "
            f"{len(classes)} classes, 80 tiles in {secs:.2f} s = "
            f"{80 / secs:.1f} tiles/s")
        assert lab.shape == (1792, 2240) and classes.max() < NC
        out.update(scene_tiles_per_s=80 / secs, scene_s=secs)
        del ens, seg
    result["ensemble"] = out
    torch.cuda.empty_cache()


# -- checkpoint interop, context windows and random_tps -------------------------
TPS = [[448, 0.1], [300, 0.1]]     # random_tps: [crop size, share of tiles]
CONTEXT_SCENE = (6800, 7200)       # GID15's scene: 30 x 32 tiles at p 224
CONTEXT_OFF = 0.01                 # card vs CPU: share of values one level apart
INTEROP_NETS = ("Unetv2", "Resnet101", "MobileNet", "SegformerMod")
# train steps of one epoch: 160 tiles + 2 x 16 tps crops in batches of 10
TPS_STEPS = -(-(160 + 2 * 16) // B_TRAIN)


class ConfusionMetric:
    """Stands in for the reference's confusion-metric objects: a class the
    port's checkpoint loader has never heard of."""

    def __init__(self, mat):
        self.mat = mat


def cpu_clone(obj):
    """``obj`` with every tensor copied to the CPU (a synchronous copy)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: cpu_clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(cpu_clone(v) for v in obj)
    return obj


def tensors_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tensors_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tensors_equal, a, b))
    return a == b


def context_chunk(tmp: Path):
    """One chunk of two 6800 x 7200 scenes at p 224 through ``get_chunk``
    on the card with ``load_context``, ``random_shift`` and ``TPS``: its
    ms (CUDA events; a fresh loader after a warm-up one), of which the
    scenes' decode, padding and upload alone (host clock, another fresh
    loader), and its peak device memory. Nothing else runs meanwhile.
    Returns the numbers and a function that starts the CPU port's chunk
    from the same draws on a worker thread and returns another that holds
    the card's chunk against it."""
    from cvcs_tpu_torch.data.loader import ChunkLoader

    root = retrieval_dataset(tmp / "scenes", CONTEXT_SCENE)
    kw = dict(chunk_size=2, patch_size=224, random_shift=True,
              load_context=True, seed=7)
    ChunkLoader(root, device="cuda", **kw).get_chunk(0, TPS)    # warm-up
    loader = ChunkLoader(root, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chunk = loader.get_chunk(0, TPS)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    other = ChunkLoader(root, device="cuda", **kw)
    t0 = time.perf_counter()
    scenes = other._load_scene_stack(other.chunks[0], other._pad())
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    del scenes, other
    n = len(chunk)
    log(f"  get_chunk: 2 scenes {CONTEXT_SCENE[0]}x{CONTEXT_SCENE[1]} at p "
        f"224, load_context, random_shift, random_tps {TPS}: {n} patches "
        f"({2 * loader.tpi} tiles + crops) with {len(chunk.contexts)} "
        f"contexts in {ms:.1f} ms (CUDA events), of which the scenes' "
        f"decode, padding and upload {load_ms:.1f} ms (host clock); peak "
        f"device memory {peak_gb:.2f} GB above the {held / 1e9:.2f} GB "
        "held before")
    assert n == 2 * loader.tpi + sum(int(f * 2 * loader.tpi) for _, f in TPS)
    out = dict(ms=ms, scene_load_ms=load_ms, peak_gb=peak_gb, patches=n,
               tiles=2 * loader.tpi)

    def start_cpu():
        pool = ThreadPoolExecutor(1)
        on_cpu = pool.submit(
            lambda: ChunkLoader(root, device="cpu", **kw).get_chunk(0, TPS))
        pool.shutdown(wait=False)
        t_cpu = time.perf_counter()

        def compare() -> dict:
            """``out`` with the share of values that differ."""
            cpu = on_cpu.result()
            out["cpu_s"] = time.perf_counter() - t_cpu
            assert torch.equal(cpu.masks.cuda(), chunk.masks)
            for what, got, want in (("patches and tps crops", chunk.images,
                                     cpu.images),
                                    ("contexts", chunk.contexts,
                                     cpu.contexts)):
                diff = (got.int() - want.cuda().int()).abs()
                worst = int(diff.max())
                share = float((diff > 0).float().mean())
                log(f"  card vs CPU port, same draws: {what} at most "
                    f"{worst} level apart, {share * 100:.4f}% of values "
                    f"differ (allowed: 1 level on {CONTEXT_OFF * 100:.0f}%);"
                    " masks equal")
                assert worst <= 1 and share <= CONTEXT_OFF
                out[f"{what.split()[0]}_differ_share"] = share
            return out

        return compare

    return out, start_cpu


def context_train_path(tmp: Path) -> dict:
    """Full-width SwinUnet through ``cli.train`` with the train cell's
    geometry plus ``load_context``, ``random_tps`` and
    ``async_checkpoints``: 2 epochs, then a third resumed with
    ``load_checkpoint: auto``. The counters: K1 and K2 12 times a step
    (K1 also per validation and evaluation batch), K5 once a chunk. Each
    asynchronous checkpoint equals, bit for bit, a synchronous copy of
    the state taken when its save was issued (the next epoch's steps
    update that state in place while the write runs)."""
    import yaml

    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.train import checkpoint as ckpt_lib

    data = dict(train=synthetic_dataset(tmp / "train", 2, seed=20),
                validation=synthetic_dataset(tmp / "val", 1, seed=30))
    cfg = dict(train_config(data, "SwinUnet", TRAIN_EPOCHS, tmp / "ckpt",
                            tmp / "metrics.jsonl"),
               load_context=True, random_tps=TPS, async_checkpoints=True)
    issued = {}
    # seconds the training thread spent blocked in wait_for_saves, and in
    # asynchronous saves outside it (the copy of the state to the host)
    blocked = {"copy": 0.0, "wait": 0.0}
    save, wait = ckpt_lib.save_checkpoint, ckpt_lib.wait_for_saves

    def timed_wait():
        t0 = time.perf_counter()
        try:
            wait()
        finally:
            blocked["wait"] += time.perf_counter() - t0

    def recording(directory, epoch, state, *a, async_save=False, **kw):
        if not async_save:
            return save(directory, epoch, state, *a, **kw)
        issued[epoch] = cpu_clone(dict(
            model=state.model.state_dict(),
            optimizer=state.optimizer.opt.state_dict()))
        waited, t0 = blocked["wait"], time.perf_counter()
        out = save(directory, epoch, state, *a, async_save=True, **kw)
        blocked["copy"] += (time.perf_counter() - t0
                            - (blocked["wait"] - waited))
        return out

    path = tmp / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ckpt_lib.save_checkpoint, ckpt_lib.wait_for_saves = recording, timed_wait
    try:
        reset_counts()
        t0 = time.perf_counter()
        assert train_cli.main(["train", str(path)]) == 0
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
    finally:
        ckpt_lib.save_checkpoint, ckpt_lib.wait_for_saves = save, wait
    steps = TRAIN_EPOCHS * TPS_STEPS
    want = dict(K1=12 * (steps + TRAIN_EPOCHS * (VAL_BATCHES + EVAL_BATCHES)),
                K2=12 * steps, K3=0, K4=0, K5=TRAIN_EPOCHS)
    metrics = [json.loads(x) for x in
               (tmp / "metrics.jsonl").read_text().splitlines()]
    meta = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS}"
                       / "meta.json").read_text())
    losses = meta["training_loss_values"]
    snap = {e: tensors_equal(
        {k: v for k, v in torch.load(
            tmp / "ckpt" / f"checkpoint{e + 1}" / ckpt_lib.STATE,
            weights_only=True).items() if k != "step"}, issued[e])
        for e in sorted(issued)}
    log(f"  cli.train SwinUnet bf16 + load_context + random_tps {TPS} + "
        f"async_checkpoints, {TRAIN_EPOCHS} epochs x {TPS_STEPS} steps "
        f"in {secs:.2f} s; epoch 2: {metrics[-1]['patches_per_s']:.1f} "
        f"patches/s over {metrics[-1]['epoch_s']:.2f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} (expected "
        f"{want}); asynchronous saves: {blocked['copy']:.3f} s in the saves "
        f"outside the wait (the state's copy to pinned host memory), {blocked['wait']:.3f} s blocked in "
        f"wait_for_saves; checkpoints equal to the state at issue, bit for "
        f"bit: {snap}")
    assert counts == want, counts
    assert len(losses) == steps and np.isfinite(losses).all()
    assert snap and all(snap.values())

    cfg.update(epochs=TRAIN_EPOCHS + 1, load_checkpoint="auto",
               metrics_log=str(tmp / "resume.jsonl"))
    path.write_text(yaml.safe_dump(cfg))
    reset_counts()
    assert train_cli.main(["train", str(path)]) == 0
    again = json.loads((tmp / "ckpt" / f"checkpoint{TRAIN_EPOCHS + 1}"
                        / "meta.json").read_text())["training_loss_values"]
    resumed = kernel_counts()
    log(f"  resumed with load_checkpoint: auto from checkpoint"
        f"{TRAIN_EPOCHS}: {len(again)} training losses, the first {steps} "
        f"the first run's: {again[:steps] == losses}; launches {resumed}")
    assert again[:steps] == losses and len(again) == steps + TPS_STEPS
    assert resumed["K2"] == 12 * TPS_STEPS and resumed["K5"] == 1
    return dict(launches=dict(K1=counts["K1"], K2=counts["K2"],
                              K5=counts["K5"]),
                seconds=secs, patches_per_s=metrics[-1]["patches_per_s"],
                epoch_s=metrics[-1]["epoch_s"], async_copy_s=blocked["copy"],
                async_wait_s=blocked["wait"], snapshots_equal=snap,
                first_loss=losses[0], last_loss=losses[-1],
                resumed_launches=resumed)


def reference_layout(sd: dict, net: str) -> dict:
    """A port state dict as the reference's 12-key checkpoint: the keys
    under each wrapper's DataParallel prefixes, an optimizer and a
    scheduler state dict, loss lists, and confusion histories of a numpy
    array and a metric object."""
    prefix = "module.model." if net.startswith("Resnet") else "module."
    weight = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([weight], lr=6e-3, momentum=0.9)
    conf = np.eye(NC, dtype=np.int64)
    return {"epoch": 1, "model_state_dict": {prefix + k: v
                                             for k, v in sd.items()},
            "optimizer_state_dict": opt.state_dict(),
            "scheduler_state_dict": torch.optim.lr_scheduler.PolynomialLR(
                opt, total_iters=20).state_dict(),
            "training_loss_values": [1.0], "validation_loss_values": [1.0],
            "macro_precision": [], "weighted_precision": [],
            "batch_size": B_TRAIN, "conf_flat": [conf],
            "conf_normalized": [ConfusionMetric(conf.astype(np.float64))],
            "optimizer": "SGD2"}


def reference_pickles(tmp: Path) -> dict:
    """The four full-width nets of ``configs/ensemble_test.yaml`` from the
    port's seeded random weights, saved as a native ``.pt`` and as a
    reference pickle: ``restore_variables`` of the pickle gives the saved
    tensors bit for bit, and ``cli.evaluate`` (f32) on the 80 validation
    patches one confusion matrix for both files. cuDNN's deterministic
    algorithms: at random weights the logits sit near ties, and one that
    sums in another order moves pixels across them (SegformerMod's
    matrices differed without it in one full run)."""
    from cvcs_tpu_torch.cli import common

    data = synthetic_dataset(tmp / "val", 1, seed=30)
    tmp.mkdir(exist_ok=True)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for net in INTEROP_NETS:
            cfg = dict(dataset=data, net=net, patch_size=224, num_classes=15,
                       precision="f32", ignore_background=True, batch_size=8)
            model, _, _ = common.build_net(cfg, torch.device("cuda"),
                                           seed=11)
            sd = cpu_clone(model.state_dict())
            native, ref = tmp / f"{net}.pt", tmp / f"{net}_checkpoint"
            torch.save(sd, native)
            torch.save(reference_layout(sd, net), ref)
            with torch.no_grad():
                for v in model.state_dict().values():
                    v.zero_()
            common.restore_variables(dict(cfg, load_checkpoint=str(ref)),
                                     model)
            restored = tensors_equal(sd, model.state_dict())
            del model
            confs, secs = [], []
            for path in (native, ref, native):
                if len(confs) == 2 and np.array_equal(*confs):
                    break        # a third run only to tell a mismatch apart
                with contextlib.redirect_stdout(io.StringIO()):
                    _, conf, t = evaluate_confusion(dict(
                        cfg, load_checkpoint=str(path)))
                confs.append(conf)
                secs.append(t)
            same = np.array_equal(confs[0], confs[1])
            if not same:
                log(f"  {net}: the native .pt twice: "
                    f"{int(np.abs(confs[0] - confs[2]).sum()) // 2} pixels "
                    "moved; the pickle against it: "
                    f"{int(np.abs(confs[0] - confs[1]).sum()) // 2}")
            log(f"  {net}: the reference pickle ({ref.stat().st_size / 1e6:.1f}"
                f" MB, {len(sd)} tensors under the wrapper's prefixes) "
                f"restores them bit for bit: {restored}; cli.evaluate from it"
                f" in {secs[1]:.2f} s, from the native .pt in {secs[0]:.2f} "
                f"s: confusion matrices equal: {same} ({int(confs[0].sum())}"
                " pixels)")
            assert restored and same
            out[net] = dict(restored=restored, equal=same, seconds=secs,
                            pixels=int(confs[0].sum()))
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return out


def orbax_case() -> dict:
    """Whether ``tensorstore`` imports on this host; where it does not, the
    Orbax reader raises ``ImportError`` naming ``cvcs_tpu.cli.export``."""
    import importlib.util

    from cvcs_tpu_torch.train import orbax_read

    if importlib.util.find_spec("tensorstore") is not None:
        log("  Orbax: tensorstore imports on this host; an Orbax directory "
            "is written only by the JAX package, which this host lacks, so "
            "the reader is CPU-tested only "
            "(tests/test_torch_checkpoint_interop.py)")
        return dict(tensorstore=True)
    try:
        orbax_read.read_state_tree("checkpoint1")
    except ImportError as err:
        message = str(err)
    else:
        raise AssertionError("the Orbax reader ran without tensorstore")
    log("  Orbax: tensorstore does not import on this host, so the Orbax "
        "reader is CPU-tested only (tests/test_torch_checkpoint_interop.py);"
        f" here it raises ImportError: {message}")
    assert "cvcs_tpu.cli.export" in message
    return dict(tensorstore=False, message=message)


def interop_path(result: dict) -> None:
    """Phase 8: the context / random_tps chunk, the reference pickles
    (while the CPU computes its chunk), the SwinUnet training with
    contexts, tps crops and asynchronous checkpoints, and the Orbax
    case."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, start_cpu = context_chunk(tmp / "chunk")
        # the CPU's chunk is computed beside the pickles' evaluations, and
        # has landed before the timed training starts
        compare = start_cpu()
        out = dict(reference_pickles=reference_pickles(tmp / "pickles"))
        out["chunk"] = compare()
        del compare                       # and with it the card's chunk
        torch.cuda.empty_cache()
        out["train"] = context_train_path(tmp / "train")
    out["orbax"] = orbax_case()
    result["interop"] = out


# -- phase 9: the mesh on torch.distributed ---------------------------------------
# windows per forward on both sides of the sharded-scene comparisons: the
# scene's 960 tiles are 6 batches of 160 and a rank's strip of 480 is 3, so
# the one-device and the two-rank runs forward the same batches
MESH_BT = 160
MESH_STEPS = (("Unetv2", "eager"), ("Unetv2", "eager_f64"),
              ("SwinUnet", "eager"), ("Unetv2", "fused"))
# a data-parallel f32 step's gradient sums in another order than the
# one-process step's, and at random weights the train-mode gradients are
# ill-conditioned: on the CPU, Unetv2's DP gradient at the recipe's
# geometry is 7.1e-2 of a parameter's largest from the one-process one in
# f32 and 7.5e-7 with f64 compute. Phase 6's rule holds the f64 step;
# the f32 steps are held to the bound a gross fault breaks (a half or a
# per-rank gradient moves updates by 0.5 or more)
TOL_UPDATE_F32_DP = 0.25


def mesh_batch():
    """The global batch of the data-parallel steps (phase 6's recipe
    batch: 10 patches at p 224, 32 x 32 label blocks, a void run) and its
    class weights, on the host."""
    from cvcs_tpu_torch.data.reader import class_weights

    g = torch.Generator().manual_seed(17)
    image = torch.randint(0, 256, (B_TRAIN, 224, 224, 3), generator=g,
                          dtype=torch.uint8)
    blocks = torch.randint(0, NC, (B_TRAIN, 7, 7), generator=g)
    blocks[0, 0, :3] = 255                       # void
    mask = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    counts = np.bincount(mask[mask < NC].numpy(), minlength=NC)
    return image, mask.to(torch.int32), class_weights(counts, True)


def mesh_step(name: str, kind: str, mesh=None, rows: bool = False,
              dtype=torch.float32):
    """One SGD2 step (f32 unless ``dtype`` says otherwise) of full-width
    ``name`` from seed-0 weights on
    :func:`mesh_batch` (wCEL with ignore_background, eager or through
    ``build_fused_ce``; ``eager_f64`` computes in f64); with ``mesh``, this rank's share of it,
    data-parallel, and with ``rows`` its strip of rows (``spatial_parallel``).
    Returns (loss, state dict on the card, the step's
    gradient of each parameter: the sum over the ranks under a mesh)."""
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.ops import fused_ce, losses
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    image, mask, weights = mesh_batch()
    model, _ = build_model(name, NC, seed=0, dtype=torch.float64
                           if kind.endswith("f64") else dtype)
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    fn = (fused_ce.build_fused_ce(weights, ignore_background=True)
          if kind == "fused" else losses.build_loss(
              "wCEL", weights=weights, ignore_background=True,
              device="cuda"))
    x, m = image.cuda(), mask.cuda()
    if mesh is not None:
        x, m = mesh_lib.shard_batch((x, m), mesh)
    if rows:
        x, m = mesh_lib.shard_rows((x, m), mesh)
    loss = float(train_step(TrainState(model, opt), fn, x, m, mesh=mesh,
                            rows=rows))
    return loss, model.state_dict(), {n: p.grad for n, p in
                                      model.named_parameters()}


def stats_err(got: dict, want: dict) -> float:
    """The largest running-statistics error of a state dict, over
    max(1, the statistic's largest value)."""
    return max((float((got[k] - v).abs().max()) / max(1.0, float(
        v.abs().max())) for k, v in want.items() if "running" in k),
        default=0.0)


def grad_update_err(got: dict, want: dict, start: dict) -> tuple:
    """Phase 6's rule (:func:`update_err`) on the first SGD2 update
    lr * (g + 1e-5 p) rebuilt in f64 from each step's gradients (lr
    cancels): the parameters' own f32 storage would round an update of
    1e-6 on a weight near 1 to a few ulps, 6e-8 each."""
    upd = {k: want[k].double() + 1e-5 * start[k].double() for k in want}
    top = max(float(u.abs().max()) for u in upd.values())
    return max(float((got[k].double() + 1e-5 * start[k].double() - u)
                     .abs().max()) / max(float(u.abs().max()), 1e-3 * top)
               for k, u in upd.items()), top


def mesh_serve_cfg(tmp: Path, out: str, **kw) -> dict:
    return dict(watch_dir=str(tmp / "watch"), output=str(tmp / out),
                net="SwinUnet", patch_size=224, border_correction=256,
                batch_tiles=80, num_classes=15, precision="bf16",
                max_polls=1, poll_s=0, **kw)


def mesh_train_cfg(tmp: Path, epochs: int, **kw) -> dict:
    return dict(train_config(dict(train=str(tmp / "train"),
                                  validation=str(tmp / "val")),
                             "SwinUnet", epochs, tmp / "ckpt",
                             tmp / "metrics.jsonl"), **kw)


def mesh_eval_cfg(tmp: Path, batch_size: int, **kw) -> dict:
    return dict(dataset=str(tmp / "val"), net="SwinUnet", patch_size=224,
                load_checkpoint=str(tmp / "ckpt" / "checkpoint2"),
                num_classes=15, precision="f32", ignore_background=True,
                batch_size=batch_size, **kw)


def mesh_rank(rank: int, world: int, tmp: str, backend: str) -> int:
    """``chip_smoke.py --mesh-rank <rank> <world> <dir> <backend>``, one
    rank of phase 9 (backend ``gloo`` or ``nccl``) or of phase 10
    (``spatial``: gloo) on ``cuda:0`` (``LOCAL_RANK`` 0), joined over a
    ``file://`` rendezvous in ``dir``; writes its JSON there (rank 0 also
    the label maps and states the main process compares)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo" if backend == "spatial" else backend,
                            init_method=f"file://{tmp}/rdv_{backend}",
                            rank=rank, world_size=world)
    try:
        out = (mesh_rank_nccl(tmp) if backend == "nccl"
               else spatial_rank(rank, tmp) if backend == "spatial"
               else mesh_rank_gloo(rank, tmp))
        out.update(rank=rank, backend=dist.get_backend())
        (tmp / f"rank{rank}_{backend}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_rank_nccl(tmp: Path) -> dict:
    """One rank under NCCL: the spatial scene path on a 1 x 1 mesh (its
    all-gather an NCCL collective) on one 1792 x 2240 raster, bf16."""
    from cvcs_tpu_torch.core.mesh import MeshConfig, create_mesh
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model

    mesh = create_mesh(MeshConfig(data=1, spatial=1))
    model, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.bfloat16)
    seg = SceneSegmenter(model, InferenceConfig(
        patch_size=224, border_correction=256, batch_tiles=128,
        num_classes=16))
    reset_counts()
    lab = seg.predict_scene_sharded(synthetic_scene(1792, 2240, seed=10),
                                    mesh)
    torch.cuda.synchronize()
    np.save(tmp / "nccl_labels.npy", lab.cpu().numpy())
    return dict(launches=kernel_counts(), device=str(mesh.device))


def mesh_rank_gloo(rank: int, tmp: Path) -> dict:
    """Rank ``rank`` of two gloo ranks sharing the card: the spatial scene
    path (f32 and bf16) and the fullconv strips at spatial 2, one halo
    exchange timed, the scene-parallel pass and the serve daemon at data
    2, the data-parallel steps, ``cli.train`` for an epoch and a resume,
    and ``cli.evaluate``, each with its launch counts."""
    from cvcs_tpu_torch.cli import serve as serve_cli
    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.parallel.halo import exchange_row_halo

    import yaml

    sp = mesh_lib.create_mesh(mesh_lib.MeshConfig(data=1, spatial=2))
    dp = mesh_lib.create_mesh(mesh_lib.MeshConfig(data=2, spatial=1))
    out = dict(device=str(sp.device))
    scene = synthetic_scene(6800, 7200, seed=1)
    cfg = InferenceConfig(patch_size=224, border_correction=256,
                          batch_tiles=MESH_BT, num_classes=16)

    def timed(key, fn, tiles=None):
        mesh_lib.barrier(sp)
        reset_counts()
        t0 = time.perf_counter()
        lab = fn()
        torch.cuda.synchronize()
        mesh_lib.barrier(sp)
        secs = time.perf_counter() - t0
        out[key] = dict(seconds=secs, launches=kernel_counts())
        if tiles:
            out[key]["tiles_per_s"] = tiles / secs
        if rank == 0 and lab is not None:
            np.save(tmp / f"{key}.npy", lab.cpu().numpy())

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model, _ = build_model("SwinUnet", 16, seed=0, dtype=dtype)
        seg = SceneSegmenter(model, cfg)
        seg.predict_scene_sharded(scene[:1792, :2240], sp)       # warm-up
        timed(f"scene_{tag}", lambda: seg.predict_scene_sharded(scene, sp),
              960)
        if tag == "f32":
            timed("fullconv_f32", lambda: seg.predict_scene_fullconv_sharded(
                scene[:6720, :7168], sp), 960)
        del model, seg
        torch.cuda.empty_cache()

    # one halo exchange of the window path's strip (bc - p = 32 rows)
    strip = torch.zeros((15 * 224, 7168 + 64, 3), dtype=torch.uint8,
                        device="cuda")
    ms = []
    for _ in range(6):
        mesh_lib.barrier(sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exchange_row_halo(strip, 32, sp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["halo"] = dict(bytes_each_way=32 * (7168 + 64) * 3, ms=ms[1:])
    del strip

    model, _ = build_model("SwinUnet", 16, seed=0, dtype=torch.bfloat16)
    seg = SceneSegmenter(model, InferenceConfig(
        patch_size=224, border_correction=256, batch_tiles=128,
        num_classes=16))
    rasters = [synthetic_scene(1792, 2240, seed=10 + i) for i in range(2)]
    timed("scenes", lambda: seg.predict_scenes_sharded(rasters, dp), 160)
    del model, seg
    def serve():
        out["served"] = serve_cli.serve(mesh_serve_cfg(
            tmp, "served_mesh", mesh={"data": 2}))

    timed("serve", serve)
    torch.cuda.empty_cache()

    for name, kind in MESH_STEPS:
        reset_counts()
        loss, sd, grads = mesh_step(name, kind, dp)
        torch.cuda.synchronize()
        out[f"step_{name}_{kind}"] = dict(loss=loss, launches=kernel_counts(),
                                          digest=float(sum(
                                              v.double().abs().sum()
                                              for v in sd.values()
                                              if v.is_floating_point())))
        if rank == 0:
            torch.save(dict(state={k: v.cpu() for k, v in sd.items()},
                            grads={k: v.cpu() for k, v in grads.items()}),
                       tmp / f"step_{name}_{kind}.pt")
        del sd, grads
        torch.cuda.empty_cache()

    for key, epochs, extra in (("train", 1, {}),
                               ("resume", 2, {"load_checkpoint": "auto"})):
        path = tmp / f"train_{key}_{rank}.yaml"
        path.write_text(yaml.safe_dump(mesh_train_cfg(
            tmp, epochs, mesh={"data": 2}, **extra)))
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_cli.main(["train", str(path)])
        torch.cuda.synchronize()
        out[key] = dict(rc=rc, seconds=time.perf_counter() - t0,
                        launches=kernel_counts())
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    reset_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, conf, secs = evaluate_confusion(mesh_eval_cfg(
                tmp, 8, mesh={"data": 2}))
    finally:
        torch.backends.cudnn.deterministic = False
    out["evaluate"] = dict(seconds=secs, launches=kernel_counts(),
                           confusion=conf.tolist())
    return out


def phase9_alone() -> int:
    """``chip_smoke.py --phase9``: build the kernels and run phase 9 alone
    (its comparison with phase 5's epoch rate then reads 0)."""
    from cvcs_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    _build.build(["swin_attn", "swin_attn_bwd", "augment", "fused_ce"])
    result: dict = {}
    mesh_path(result)
    log(json.dumps(result["mesh"]))
    return 0


def run_ranks(world: int, tmp: Path, backend: str, timeout: float) -> list:
    """The ``world`` rank processes of one phase-9 run, all on ``cuda:0``;
    their JSON, in rank order. Kills them all if one fails or the time
    runs out."""
    import os

    env = dict(os.environ, LOCAL_RANK="0")
    logs = [tmp / f"rank{r}_{backend}.log" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(world), str(tmp), backend], env=env,
        stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r, path in enumerate(logs):
            log(f"  rank {r} ({backend}) exited {rcs[r]}; its log ends:\n"
                + path.read_text()[-3000:])
        raise RuntimeError(f"phase 9/10 {backend} ranks exited {rcs}")
    return [json.loads((tmp / f"rank{r}_{backend}.json").read_text())
            for r in range(world)]


def mesh_path(result: dict) -> None:
    """Phase 9: the port's mesh on ``torch.distributed``. Two gloo ranks
    share the one card (NCCL refuses two ranks on one GPU; gloo takes CUDA
    tensors in its collectives, and the halo exchange stages its rows
    through pinned host buffers, since gloo's sends take none), and one
    NCCL rank runs the scene path on a 1 x 1 mesh. The references are
    computed here, on one device, before the ranks start."""
    from PIL import Image

    from cvcs_tpu_torch.cli import serve as serve_cli
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic_dataset(tmp / "train", 2, seed=20)
        synthetic_dataset(tmp / "val", 1, seed=30)
        (tmp / "watch").mkdir()
        for i in range(3):
            Image.fromarray(synthetic_scene(1792, 2240, seed=10 + i)).save(
                tmp / "watch" / f"r{i}.png")

        # references on one device
        scene = synthetic_scene(6800, 7200, seed=1)
        ref = {}
        cfg = InferenceConfig(patch_size=224, border_correction=256,
                              batch_tiles=MESH_BT, num_classes=16)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            model, _ = build_model("SwinUnet", 16, seed=0, dtype=dtype)
            seg = SceneSegmenter(model, cfg)
            ref[f"scene_{tag}"] = seg.predict_scene(scene).cpu().numpy()
            if tag == "f32":
                padded, rows, cols, halo = seg.pad_scene_fullconv(
                    scene[:6720, :7168])
                ref["fullconv_f32"] = seg.predict_padded_fullconv(
                    padded, rows, cols, halo, band_rows=15).cpu().numpy()
                del padded
            else:
                t0 = time.perf_counter()
                seg.predict_scene(scene)
                torch.cuda.synchronize()
                ref["scene_tiles_per_s"] = 960 / (time.perf_counter() - t0)
                seg.cfg = InferenceConfig(patch_size=224,
                                          border_correction=256,
                                          batch_tiles=128, num_classes=16)
                ref["scenes"] = np.stack([
                    seg.predict_scene(synthetic_scene(1792, 2240, 10 + i))
                    .cpu().numpy() for i in range(2)])
            del model, seg
            torch.cuda.empty_cache()
        del scene
        with contextlib.redirect_stdout(io.StringIO()):
            assert serve_cli.serve(mesh_serve_cfg(tmp, "served")) == 3
        steps = {}
        for name, kind in MESH_STEPS:
            loss, sd, grads = mesh_step(name, kind)
            steps[(name, kind)] = (loss, {k: v.cpu() for k, v in sd.items()},
                                   {k: v.cpu() for k, v in grads.items()})
        starts = {name: build_model(name, NC, seed=0, dtype=torch.float32)[0]
                  for name in ("Unetv2", "SwinUnet")}
        names = {k: [n for n, _ in m.named_parameters()]
                 for k, m in starts.items()}
        starts = {k: {n: v.cpu() for n, v in m.state_dict().items()}
                  for k, m in starts.items()}
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase
        log(f"  references on one device in {t_ref:.1f} s; two gloo ranks on "
            "cuda:0 next")

        t0 = time.perf_counter()
        ranks = run_ranks(2, tmp, "gloo", 600)
        t_gloo = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = run_ranks(1, tmp, "nccl", 300)
        t_nccl = time.perf_counter() - t0

        # -- the spatial scene path, the fullconv strips ---------------------
        r0, r1 = ranks
        for key in ("scene_f32", "scene_bf16", "fullconv_f32"):
            assert r0[key]["launches"] == r1[key]["launches"], key
        k1 = r0["scene_f32"]["launches"]["K1"]
        assert k1 == r0["scene_bf16"]["launches"]["K1"] == 12 * 3, k1
        f32 = np.load(tmp / "scene_f32.npy")
        bf16 = np.load(tmp / "scene_bf16.npy")
        f32_equal = bool(np.array_equal(f32, ref["scene_f32"]))
        bf16_share = float((bf16 == ref["scene_bf16"]).mean())
        halo = r0["halo"]
        log(f"  predict_scene_sharded, spatial 2 (15 tile rows a rank, the "
            f"80-row bottom overhang in rank 1's lower halo), full-width "
            f"SwinUnet, {MESH_BT} windows a forward: f32 labels equal to "
            f"the one-device window path's: {f32_equal}; bf16 labels agree "
            f"on {bf16_share * 100:.4f}% (>= 99.9%); K1 launches per rank "
            f"{k1} (12 x 3 forwards) on both; bf16 "
            f"{r0['scene_bf16']['tiles_per_s']:.1f} tiles/s over the two "
            f"ranks sharing the card against the one-device window path's "
            f"{ref['scene_tiles_per_s']:.1f} in this phase; halo "
            f"{halo['bytes_each_way']} B each way a rank, "
            f"{min(halo['ms']):.3f}-{max(halo['ms']):.3f} ms an exchange "
            f"(staged through pinned host buffers, gloo)")
        assert f32.shape == (6720, 7168) and f32_equal
        assert bf16_share >= 0.999
        fc = np.load(tmp / "fullconv_f32.npy")
        fc_equal = bool(np.array_equal(fc, ref["fullconv_f32"]))
        fc_k1 = r0["fullconv_f32"]["launches"]["K1"]
        log(f"  predict_scene_fullconv_sharded, spatial 2, f32, scene cropped"
            f" to its 30 x 32 tiles: equal to predict_padded_fullconv with "
            f"band_rows 15 on one device: {fc_equal}; K1 per rank {fc_k1} "
            "(12: one strip forward)")
        assert fc_equal and fc_k1 == 12

        # -- scene-parallel, the serve daemon -------------------------------
        scenes = np.load(tmp / "scenes.npy")
        sc_equal = bool(np.array_equal(scenes, ref["scenes"]))
        sc_k1 = (r0["scenes"]["launches"]["K1"],
                 r1["scenes"]["launches"]["K1"])
        served = {}
        for which in ("served", "served_mesh"):
            entries = [json.loads(x) for x in (tmp / which / "manifest.jsonl")
                       .read_text().splitlines()]
            served[which] = dict(
                journal=[{k: e[k] for k in ("name", "mask", "shape", "batch")}
                         for e in entries],
                masks=[np.asarray(Image.open(tmp / which / e["mask"]))
                       for e in entries])
        masks_equal = all(np.array_equal(a, b) for a, b in zip(
            served["served"]["masks"], served["served_mesh"]["masks"]))
        journal_equal = (served["served"]["journal"]
                         == served["served_mesh"]["journal"])
        serve_k1 = (r0["serve"]["launches"]["K1"],
                    r1["serve"]["launches"]["K1"])
        log(f"  predict_scenes_sharded, data 2, two 1792x2240 rasters bf16: "
            f"labels equal to predict_scene's: {sc_equal}; K1 per rank "
            f"{sc_k1}; serve with mesh {{data: 2}} on three rasters (a "
            f"scene-parallel pair and one alone): masks equal: "
            f"{masks_equal}, journal equal: {journal_equal}, K1 per rank "
            f"{serve_k1}")
        assert sc_equal and sc_k1 == (12, 12)
        assert masks_equal and journal_equal and len(
            served["served_mesh"]["masks"]) == 3
        assert serve_k1 == (24, 24) and r0["served"] == r1["served"] == 3

        # -- data-parallel steps ---------------------------------------------
        step_out = {}
        for name, kind in MESH_STEPS:
            key = f"step_{name}_{kind}"
            want_loss, want, want_grads = steps[(name, kind)]
            saved = torch.load(tmp / f"{key}.pt", weights_only=True)
            got = saved["state"]
            assert r0[key]["digest"] == r1[key]["digest"], key
            assert r0[key]["loss"] == r1[key]["loss"], key
            rel = abs(r0[key]["loss"] - want_loss) / abs(want_loss)
            stored, _ = update_err(got, want, starts[name], names[name])
            upd, top = grad_update_err(saved["grads"], want_grads,
                                       starts[name])
            stats = max(float((got[k] - v).abs().max()) / max(1.0, float(
                v.abs().max())) for k, v in want.items()
                if "running" in k)
            launches = (r0[key]["launches"], r1[key]["launches"])
            log(f"  {name} step ({kind} wCEL) at data 2 vs one process "
                f"on the global batch of {B_TRAIN}: loss "
                f"{r0[key]['loss']:.6f} vs {want_loss:.6f} (relative "
                f"{rel:.2e}, tol 1e-5); update error {upd:.2e} (tol "
                f"{TOL_UPDATE if kind.endswith('f64') else TOL_UPDATE_F32_DP:g}"
                f", largest update / lr {top:.2e}; "
                f"{stored:.2e} as stored in the f32 parameters); running "
                f"statistics err/scale {stats:.2e} (tol 1e-5); launches per "
                f"rank {launches[0]}")
            assert rel <= 1e-5 and stats <= 1e-5
            assert upd <= (TOL_UPDATE if kind.endswith("f64")
                           else TOL_UPDATE_F32_DP)
            assert launches[0] == launches[1]
            if name == "SwinUnet":
                assert (launches[0]["K1"], launches[0]["K2"]) == (12, 12)
            if kind == "fused":
                assert (launches[0]["K3"], launches[0]["K4"]) == (1, 1)
            step_out[key] = dict(loss_rel=rel, update_err=upd,
                                 stored_update_err=stored, stats_err=stats,
                                 launches=launches[0])

        # -- cli.train, its resume, cli.evaluate ----------------------------
        per_epoch = dict(K1=12 * (STEPS_PER_EPOCH + VAL_BATCHES
                                  + EVAL_BATCHES),
                         K2=12 * STEPS_PER_EPOCH, K3=0, K4=0, K5=1)
        metrics = [json.loads(x) for x in (tmp / "metrics.jsonl")
                   .read_text().splitlines()]
        for key in ("train", "resume"):
            assert r0[key]["rc"] == r1[key]["rc"] == 0, key
            assert r0[key]["launches"] == r1[key]["launches"] == per_epoch, (
                key, r0[key]["launches"], r1[key]["launches"])
        meta = json.loads((tmp / "ckpt" / "checkpoint2" / "meta.json")
                          .read_text())
        losses = meta["training_loss_values"]
        assert len(losses) == 2 * STEPS_PER_EPOCH
        assert np.isfinite(losses).all()
        assert [m["epoch"] for m in metrics] == [1, 2]
        smi = gpu_line()
        rate = metrics[0]["patches_per_s"]
        plain = result.get("train", {}).get("patches_per_s_epoch2", 0.0)
        log(f"  cli.train SwinUnet bf16, mesh {{data: 2}} (5 patches a rank a"
            f" step), 1 epoch then a resume with load_checkpoint: auto: "
            f"launches per rank per epoch {r0['train']['launches']} (K1, K2 "
            f"12 a step, K5 once a chunk); epoch 1 {rate:.1f} patches/s, "
            f"epoch 2 {metrics[1]['patches_per_s']:.1f}, against phase 5's "
            f"one process {plain:.1f} ({smi}; two ranks on one card measure "
            f"overhead, not scaling); losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
        torch.backends.cudnn.deterministic = True
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                _, conf, _ = evaluate_confusion(mesh_eval_cfg(tmp, 4))
        finally:
            torch.backends.cudnn.deterministic = False
        conf_equal = bool(np.array_equal(np.asarray(r0["evaluate"]
                                                    ["confusion"]), conf))
        log(f"  cli.evaluate of checkpoint2 with mesh {{data: 2}} (8 patches "
            f"a batch, 4 a rank) vs one device (4 a batch: the same "
            f"forwards), f32, cuDNN deterministic: confusion matrices "
            f"equal: {conf_equal} ({int(conf.sum())} pixels)")
        assert conf_equal and int(conf.sum()) > 0

        # -- one NCCL rank --------------------------------------------------
        lab = np.load(tmp / "nccl_labels.npy")
        nccl_equal = bool(np.array_equal(lab, ref["scenes"][0]))
        log(f"  one NCCL rank ({nccl['backend']}, {nccl['device']}): "
            f"predict_scene_sharded on a 1 x 1 mesh, 1792x2240 bf16, equal to"
            f" predict_scene's: {nccl_equal}; K1 {nccl['launches']['K1']}")
        assert nccl["backend"] == "nccl" and nccl_equal
        assert nccl["launches"]["K1"] == 12
        seconds = time.perf_counter() - t_phase
        log(f"  phase 9: {seconds:.1f} s (references {t_ref:.1f}, gloo ranks "
            f"{t_gloo:.1f}, NCCL rank {t_nccl:.1f})")
        out = dict(
            backend=r0["backend"], seconds=seconds, references_s=t_ref,
            gloo_ranks_s=t_gloo, nccl_rank_s=t_nccl,
            scene=dict(f32_equal=f32_equal, bf16_share=bf16_share,
                       bf16_tiles_per_s=r0["scene_bf16"]["tiles_per_s"],
                       one_device_tiles_per_s=ref["scene_tiles_per_s"],
                       launches=r0["scene_bf16"]["launches"]),
            halo=halo, fullconv=dict(equal=fc_equal,
                                     launches=r0["fullconv_f32"]["launches"]),
            scenes=dict(equal=sc_equal, launches=r0["scenes"]["launches"]),
            serve=dict(masks_equal=masks_equal, journal_equal=journal_equal,
                       launches=r0["serve"]["launches"]),
            steps=step_out,
            train=dict(launches_per_epoch=r0["train"]["launches"],
                       patches_per_s=[m["patches_per_s"] for m in metrics],
                       seconds=[r0["train"]["seconds"],
                                r0["resume"]["seconds"]],
                       one_process_patches_per_s=plain, card=smi),
            evaluate=dict(equal=conf_equal,
                          launches=r0["evaluate"]["launches"]),
            nccl=dict(equal=nccl_equal, launches=nccl["launches"]))
    result["mesh"] = out


# -- phase 10: spatially partitioned training, tensor parallelism -----------
# f32 steps at spatial 2 against one process on mesh_batch (phase 9's rule)
SPATIAL_STEPS = (("Unetv2", "eager"), ("Unetv2", "eager_f64"),
                 ("SwinUnet", "eager"), ("SegformerMod", "eager"),
                 ("Unetv2", "fused"), ("Resnet101", "eager"),
                 ("Resnet101", "eager_f64"), ("MobileNet", "eager"),
                 ("Resnet50", "eager"), ("MobileNetGoogle", "eager"),
                 ("MobileNetResnet18", "eager"), ("Resnet101", "fused"))
# f32 steps' running statistics are held to 1e-5 of scale, except where
# f32 rounding alone moves one process's statistics further (against its
# own f64 step): the ResNet stems' BatchNorm sees raw 0-255 pixels, whose
# fast variance E[x^2] - E[x]^2 cancels. Resnet101's sound spatial steps
# read 1.66e-5 and one process's own f32-vs-f64 error 1.77e-5 on the
# H100, so its limit is a fixed 4e-5 (Resnet50 reads 5.9e-6, the
# MobileNet trunks 7.1e-7 to 2.9e-6, and stay at 1e-5)
SPATIAL_STATS_TOL = {"Resnet101": 4e-5}
# bf16 steps: peak memory a rank
SPATIAL_MEMORY = ("Unetv2", "SwinUnet", "Resnet101")
SPATIAL_TRAIN = ("Unetv2", "SwinUnet", "MobileNet")   # cli.train at spatial 2
TP_NETS = ("Unetv2", "Resnet101", "SegformerMod")
TP_BATCH = 2                                # forwards at p 224
SPATIAL_STEPS_PER_EPOCH = 8                 # 1 train scene x 80 tiles / 10
SPATIAL_VAL_BATCHES, SPATIAL_EVAL_BATCHES = 8, 10


def tp_input():
    g = torch.Generator().manual_seed(23)
    return torch.rand((TP_BATCH, 224, 224, 3), generator=g) * 255


def step_memory(name: str, mesh=None) -> dict:
    """Peak device memory of one bf16 step of full-width ``name`` on
    :func:`mesh_batch` (on row strips with ``mesh``): the most allocated
    during model build and step above what was allocated before, with
    the halo exchanges and gathers of the step."""
    from cvcs_tpu_torch.parallel import halo

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    halo.reset_stats()
    halo.reset_gathered()
    t0 = time.perf_counter()
    mesh_step(name, "eager", mesh, rows=mesh is not None,
              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return dict(peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                step_s=time.perf_counter() - t0, halo=dict(halo.stats),
                gathered=halo.gathered())


def spatial_train_cfg(tmp: Path, net: str, epochs: int, **kw) -> dict:
    """Phase 5's recipe geometry on one train and one validation scene,
    ``mesh: {data: 1, spatial: 2}``; Unetv2 with the recipe's
    ``augmentation: True``, SwinUnet and MobileNet with ``augmentation:
    fused``."""
    cfg = train_config(dict(train=str(tmp / "sp_train"),
                            validation=str(tmp / "sp_val")), net, epochs,
                       tmp / f"ckpt_{net}", tmp / f"metrics_{net}.jsonl")
    cfg.update(chunk_size=1, mesh={"data": 1, "spatial": 2}, **kw)
    if net == "Unetv2":
        cfg["augmentation"] = True
    return cfg


def spatial_rank(rank: int, tmp: Path) -> dict:
    """Rank ``rank`` of two gloo ranks sharing the card, phase 10: the f32
    steps at spatial 2 (each with its halo traffic and the ops that took
    the gather), the bf16 steps' peak memory and halo traffic, the TP
    forwards, then ``cli.train`` of Unetv2, SwinUnet and MobileNet at
    spatial 2 for an epoch and a resume; each with its launch counts."""
    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.parallel import halo, tp

    sp = mesh_lib.create_mesh(mesh_lib.MeshConfig(data=1, spatial=2))
    out = dict(device=str(sp.device))
    for name, kind in SPATIAL_STEPS:
        reset_counts()
        halo.reset_gathered()
        halo.reset_stats()
        loss, sd, grads = mesh_step(name, kind, sp, rows=True)
        torch.cuda.synchronize()
        out[f"step_{name}_{kind}"] = dict(
            loss=loss, launches=kernel_counts(), gathered=halo.gathered(),
            halo=dict(halo.stats),
            digest=float(sum(v.double().abs().sum() for v in sd.values()
                             if v.is_floating_point())))
        if rank == 0:
            torch.save(dict(state={k: v.cpu() for k, v in sd.items()},
                            grads={k: v.cpu() for k, v in grads.items()}),
                       tmp / f"spatial_{name}_{kind}.pt")
        del sd, grads
        torch.cuda.empty_cache()
    for name in SPATIAL_MEMORY:
        mesh_lib.barrier(sp)
        reset_counts()
        out[f"memory_{name}"] = dict(step_memory(name, sp),
                                     launches=kernel_counts())
        torch.cuda.empty_cache()

    x = tp_input().cuda()
    for name in TP_NETS:
        model, _ = build_model(name, NC, seed=0, dtype=torch.float32)
        whole = {k: v.numel() * v.element_size()
                 for k, v in model.named_parameters()}
        rule = tp.channel_shardings(model, sp)
        tp.shard_params(model, sp)
        mine = dict(model.named_parameters())
        sharded = {k: (whole[k], mine[k].numel() * mine[k].element_size())
                   for k, dim in rule.items() if dim is not None}
        mesh_lib.barrier(sp)
        t0 = time.perf_counter()
        with torch.no_grad(), tp.tensor_parallel(sp):
            logits = model(x)
        torch.cuda.synchronize()
        out[f"tp_{name}"] = dict(
            seconds=time.perf_counter() - t0, kernels=len(sharded),
            whole_bytes=sum(w for w, _ in sharded.values()),
            rank_bytes=sum(m for _, m in sharded.values()),
            halves=all(2 * m == w for w, m in sharded.values()),
            params_bytes=sum(v.numel() * v.element_size()
                             for v in mine.values()))
        if rank == 0:
            torch.save(logits.cpu(), tmp / f"tp_{name}.pt")
        del model, logits
        torch.cuda.empty_cache()

    for name in SPATIAL_TRAIN:
        for key, epochs, extra in (("train", 1, {}),
                                   ("resume", 2, {"load_checkpoint": "auto"})):
            cfg = spatial_train_cfg(tmp, name, epochs, **extra)
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train_cli.build_trainer(cfg)
                trainer.train()
            torch.cuda.synchronize()
            sd = trainer.state.model.state_dict()
            out[f"{key}_{name}"] = dict(
                seconds=time.perf_counter() - t0, launches=kernel_counts(),
                losses=trainer.training_loss_values,
                digest=float(sum(v.double().abs().sum() for v in sd.values()
                                 if v.is_floating_point())))
            del trainer, sd
            torch.cuda.empty_cache()
    return out


def phase10_alone() -> int:
    """``chip_smoke.py --phase10``: build the kernels and run phase 10
    alone (its comparisons with phase 5's epoch rates then read 0)."""
    from cvcs_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    _build.build(["swin_attn", "swin_attn_bwd", "augment", "fused_ce"])
    result: dict = {}
    spatial_path(result)
    log(json.dumps(result["spatial"]))
    return 0


def spatial_path(result: dict) -> None:
    """Phase 10: spatially partitioned training and tensor parallelism on
    two gloo ranks sharing the card (as phase 9). The references run
    here, on one device, before the ranks start."""
    from cvcs_tpu_torch.models import build_model

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic_dataset(tmp / "sp_train", 1, seed=40)
        synthetic_dataset(tmp / "sp_val", 1, seed=50)
        steps = {}
        for name, kind in SPATIAL_STEPS:
            loss, sd, grads = mesh_step(name, kind)
            steps[(name, kind)] = (loss, {k: v.cpu() for k, v in sd.items()},
                                   {k: v.cpu() for k, v in grads.items()})
            del sd, grads
        starts, names = {}, {}
        for name in {n for n, _ in SPATIAL_STEPS}:
            model = build_model(name, NC, seed=0, dtype=torch.float32)[0]
            names[name] = [n for n, _ in model.named_parameters()]
            starts[name] = {k: v.cpu() for k, v in model.state_dict().items()}
            del model
        torch.cuda.empty_cache()
        one = {}
        for name in SPATIAL_MEMORY:
            one[name] = step_memory(name)
            torch.cuda.empty_cache()
        x = tp_input().cuda()
        tp_ref = {}
        with torch.no_grad():
            for name in TP_NETS:
                model = build_model(name, NC, seed=0, dtype=torch.float32)[0]
                tp_ref[name] = model(x).cpu()
                del model
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase
        log(f"  references on one device in {t_ref:.1f} s; two gloo ranks on "
            "cuda:0 next")
        t0 = time.perf_counter()
        r0, r1 = run_ranks(2, tmp, "spatial", 600)
        t_ranks = time.perf_counter() - t0
        smi = gpu_line()

        # -- steps at spatial 2 against one process ------------------------
        step_out = {}
        for name, kind in SPATIAL_STEPS:
            key = f"step_{name}_{kind}"
            want_loss, want, want_grads = steps[(name, kind)]
            saved = torch.load(tmp / f"spatial_{name}_{kind}.pt",
                               weights_only=True)
            got = saved["state"]
            assert r0[key]["digest"] == r1[key]["digest"], key
            assert r0[key]["loss"] == r1[key]["loss"], key
            rel = abs(r0[key]["loss"] - want_loss) / abs(want_loss)
            stored, _ = update_err(got, want, starts[name], names[name])
            upd, top = grad_update_err(saved["grads"], want_grads,
                                       starts[name])
            stats = stats_err(got, want)
            tol_stats = (1e-5 if kind.endswith("f64") else
                         SPATIAL_STATS_TOL.get(name, 1e-5))
            tol = TOL_UPDATE if kind.endswith("f64") else TOL_UPDATE_F32_DP
            launches = (r0[key]["launches"], r1[key]["launches"])
            h = r0[key]["halo"]
            log(f"  {name} step ({kind} wCEL) at spatial 2 vs one process "
                f"on the global batch of {B_TRAIN}: loss "
                f"{r0[key]['loss']:.6f} vs {want_loss:.6f} (relative "
                f"{rel:.2e}, tol 1e-5); update error {upd:.2e} (tol {tol:g}, "
                f"largest update / lr {top:.2e}; {stored:.2e} as stored in "
                f"the f32 parameters); running statistics err/scale "
                f"{stats:.2e} (tol {tol_stats:g}); launches per rank "
                f"{launches[0]}; "
                f"halo exchanges a rank {h['exchanges']} "
                f"({h['exchange_bytes'] / 1e6:.3f} MB, "
                f"{h['exchange_s'] * 1e3:.1f} ms host clock), gathers "
                f"{h['gathers']} ({h['gather_bytes'] / 1e6:.3f} MB); "
                f"gathered: {sorted(r0[key]['gathered']) or 'none'}")
            assert rel <= 1e-5 and stats <= tol_stats, (key, rel, stats)
            assert upd <= tol, (key, upd)
            assert launches[0] == launches[1]
            if name == "SwinUnet":
                assert (launches[0]["K1"], launches[0]["K2"]) == (12, 12)
            if kind == "fused":
                assert (launches[0]["K3"], launches[0]["K4"]) == (1, 1)
            step_out[key] = dict(loss_rel=rel, update_err=upd,
                                 stored_update_err=stored, stats_err=stats,
                                 stats_tol=tol_stats,
                                 launches=launches[0], halo=h,
                                 gathered=r0[key]["gathered"])

        # -- what spatial partitioning is for: memory, halos, gathers --------
        memory = {}
        for name in SPATIAL_MEMORY:
            mine = (r0[f"memory_{name}"], r1[f"memory_{name}"])
            h = mine[0]["halo"]
            log(f"  {name} bf16 step at spatial 2 (batch {B_TRAIN}, p 224): "
                f"peak {mine[0]['peak_gib']:.3f} / {mine[1]['peak_gib']:.3f} "
                f"GiB a rank against one process's {one[name]['peak_gib']:.3f}"
                f" GiB; halo exchanges a step a rank: {h['exchanges']} "
                f"({h['exchange_bytes'] / 1e6:.3f} MB sent, "
                f"{h['exchange_s'] * 1e3:.1f} ms host clock); gathers "
                f"{h['gathers']} ({h['gather_bytes'] / 1e6:.3f} MB, "
                f"{h['gather_s'] * 1e3:.1f} ms); gathered ops: "
                f"{sorted(mine[0]['gathered']) or 'none'}; step "
                f"{mine[0]['step_s']:.2f} s with model build ({smi})")
            if name == "SwinUnet":
                assert mine[0]["launches"]["K1"] == 12, mine[0]["launches"]
            memory[name] = dict(rank_peak_gib=[m["peak_gib"] for m in mine],
                                one_process_peak_gib=one[name]["peak_gib"],
                                halo=h, gathered=mine[0]["gathered"],
                                launches=mine[0]["launches"])

        # -- tensor parallelism ------------------------------------------------
        tp_out = {}
        for name in TP_NETS:
            got = torch.load(tmp / f"tp_{name}.pt", weights_only=True)
            want = tp_ref[name]
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max()) / scale
            a, b = r0[f"tp_{name}"], r1[f"tp_{name}"]
            log(f"  {name} f32 forward at p 224 (batch {TP_BATCH}) under "
                f"tensor_parallel over 2 ranks: logits err/scale {err:.2e} "
                f"(tol 1e-4) against one device; {a['kernels']} sharded "
                f"kernels, {a['rank_bytes'] / 1e6:.1f} MB a rank of "
                f"{a['whole_bytes'] / 1e6:.1f} MB (halves: "
                f"{a['halves'] and b['halves']}); all parameters "
                f"{a['params_bytes'] / 1e6:.1f} MB a rank; "
                f"{a['seconds'] * 1e3:.1f} ms a forward")
            assert err <= 1e-4 and a["halves"] and b["halves"], name
            assert 2 * a["rank_bytes"] == a["whole_bytes"] > 0
            tp_out[name] = dict(err=err, kernels=a["kernels"],
                                rank_bytes=a["rank_bytes"],
                                whole_bytes=a["whole_bytes"],
                                params_bytes=a["params_bytes"],
                                ms=a["seconds"] * 1e3)

        # -- cli.train at spatial 2 -------------------------------------------
        per_step = SPATIAL_STEPS_PER_EPOCH
        forwards = per_step + SPATIAL_VAL_BATCHES + SPATIAL_EVAL_BATCHES
        train_out = {}
        phase5 = {name: result.get(key, {}).get("patches_per_s_epoch2", 0.0)
                  for name, key in (("Unetv2", "unet_train"),
                                    ("SwinUnet", "train"))}
        phase5["MobileNet"] = result.get("deeplab_train", {}).get(
            "mobilenet", {}).get("patches_per_s", 0.0)
        for name in SPATIAL_TRAIN:
            metrics = [json.loads(x) for x in (tmp / f"metrics_{name}.jsonl")
                       .read_text().splitlines()]
            runs = {}
            for key in ("train", "resume"):
                got = (r0[f"{key}_{name}"], r1[f"{key}_{name}"])
                assert got[0]["launches"] == got[1]["launches"], (name, key)
                assert got[0]["losses"] == got[1]["losses"], (name, key)
                assert got[0]["digest"] == got[1]["digest"], (name, key)
                assert np.isfinite(got[0]["losses"]).all()
                want = (dict(K1=12 * forwards, K2=12 * per_step, K3=0, K4=0,
                             K5=1) if name == "SwinUnet" else
                        dict(K1=0, K2=0, K3=0, K4=0,
                             K5=int(name == "MobileNet")))
                assert got[0]["launches"] == want, (name, key,
                                                    got[0]["launches"])
                runs[key] = dict(seconds=got[0]["seconds"],
                                 launches=got[0]["launches"])
            losses = r0[f"resume_{name}"]["losses"]
            assert len(losses) == 2 * per_step
            rates = [m["patches_per_s"] for m in metrics]
            log(f"  cli.train {name} bf16 at mesh {{data: 1, spatial: 2}} "
                f"(the recipe's geometry, {per_step} steps an epoch), 1 epoch "
                f"then a resume with load_checkpoint: auto: launches per rank "
                f"an epoch {runs['train']['launches']} (K1/K2 12 a step and "
                f"forward, K5 once a chunk where fused); {rates[0]:.1f} and "
                f"{rates[-1]:.1f} patches/s against phase 5's one process "
                f"{phase5[name]:.1f} ({smi}; two ranks on one card measure "
                f"overhead, not scaling); losses {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}; the ranks end on one state")
            train_out[name] = dict(runs=runs, patches_per_s=rates,
                                   one_process_patches_per_s=phase5[name])
        seconds = time.perf_counter() - t_phase
        log(f"  phase 10: {seconds:.1f} s (references {t_ref:.1f}, gloo ranks"
            f" {t_ranks:.1f}; limit 240)")
        assert seconds < 240, seconds
    result["spatial"] = dict(seconds=seconds, references_s=t_ref,
                             ranks_s=t_ranks, steps=step_out, memory=memory,
                             tp=tp_out, train=train_out, card=smi)


# -- phase 11: the host decode and encode tier --------------------------------
TIER_STEPS = 30        # Unetv2 bf16 train steps on each chunk
TIER_CHUNKS = 3        # cold; prefetched in a cold get_chunk; in steady state
TIER_SIDE = 3400       # the convoy measure's raster (tools/pil_gil.py)
# PIL-written files of each codec and layout the C++ tier carries
TIER_CODECS = [(None, {}), ("tiff_lzw", {}), ("tiff_lzw", {317: 2}),
               ("tiff_deflate", {}), ("tiff_deflate", {317: 2, 278: 64}),
               ("tiff_adobe_deflate", {}), ("packbits", {})]


def served_outputs(out: Path, entries: list) -> dict:
    """The serve daemon's masks (arrays) and journal (less its times)."""
    from PIL import Image

    return dict(masks={e["mask"]: np.asarray(Image.open(out / e["mask"]))
                       for e in entries},
                journal=sorted([e["name"], e["mask"], e["shape"], e["batch"]]
                               for e in entries))


@contextlib.contextmanager
def reader_tier(tier):
    """The data reader's host tier switched to ``tier`` (``native``, the
    C++ library, or ``native.plain``) inside the block: a switch of this
    script's, not a config key."""
    from cvcs_tpu_torch.data import reader

    old, reader.native = reader.native, tier
    try:
        yield
    finally:
        reader.native = old


def cached(tier) -> int:
    """Entries in a tier's decode cache."""
    lib = tier.load()
    return lib.tr_cache_size() if hasattr(lib, "tr_cache_size") else lib.size()


def tier_parity(tmp: Path, rasters: list) -> dict:
    """Both tiers on the same files, byte for byte: the serve rasters and a
    PIL-written file of each codec (``TIER_CODECS``) and layout (1-4
    channels) and each PNG type; and a mask PNG written by the C++ writer,
    read back under PIL. (The scenes and their masks: ``tier_leg``.)"""
    from PIL import Image

    from cvcs_tpu_torch import native
    from cvcs_tpu_torch.data.palette import PALETTE
    from cvcs_tpu_torch.native import plain

    formats = tmp / "formats"
    formats.mkdir()
    scene = synthetic_scene(1000, 1400, seed=31)
    layouts = {1: scene[..., 0], 2: scene[..., :2], 3: scene,
               4: np.dstack([scene, scene[..., :1]])}
    for c, arr in layouts.items():
        for i, (comp, info) in enumerate(TIER_CODECS):
            Image.fromarray(arr).save(formats / f"c{c}_{i}.tif",
                                      compression=comp, tiffinfo=info)
        Image.fromarray(arr).save(formats / f"c{c}.png")
    files = list(rasters) + sorted(formats.iterdir())
    equal = True
    for f in files:
        a, b = native.decode(f), plain.decode(f)
        equal = equal and a is not None and b is not None and (
            a.dtype, a.shape) == (b.dtype, b.shape) and np.array_equal(a, b)
    rng = np.random.default_rng(32)
    labels = np.kron(rng.integers(0, 16, (1792 // 16, 2240 // 16), np.uint8),
                     np.ones((16, 16), np.uint8))
    t0 = time.perf_counter()
    assert native.write_png(formats / "mask.png", PALETTE[labels])
    write_ms = (time.perf_counter() - t0) * 1e3
    mask_equal = np.array_equal(np.asarray(Image.open(formats / "mask.png")),
                                PALETTE[labels])
    log(f"  host tier parity: {len(files)} files ({len(rasters)} serve "
        f"rasters, {len(files) - len(rasters)} codecs, layouts and PNG "
        f"types) equal byte for byte through the C++ and the plain tier: "
        f"{equal}; a 1792x2240 mask PNG written by the C++ writer in "
        f"{write_ms:.1f} ms reads back equal under PIL: {mask_equal}")
    assert equal and mask_equal
    return dict(files=len(files), equal=equal, mask_equal=mask_equal,
                mask_write_ms=write_ms)


def tier_leg(root: str, kw: dict, tier, name: str, state, fn, smi: str,
             first: dict) -> dict:
    """The chunk leg through ``tier``: a ``ChunkLoader`` over the scenes
    under ``root``; chunk 1 taken cold (its rasters decode inline while
    ``get_chunk`` has queued chunk 2's on the worker), then
    ``TIER_STEPS`` bf16 Unetv2 train steps on its batches; chunk 2, whose
    decode ran beside chunk 1's, and as many steps while the worker
    decodes chunk 3; chunk 3, the steady state, whose decode overlapped
    chunk 2's ``get_chunk`` and steps, and as many steps with nothing
    queued. For each ``get_chunk``: its ms (host clock to a
    synchronisation), the ms in its decodes (chunk 1: inline; chunks 2,
    3: ``take``, the wait for the worker) and its steps' ms. ``first``:
    the first leg's chunks (on the card) and decoded arrays (by path),
    which a later leg's must equal, byte for byte; the first leg fills it
    and holds chunks 2 and 3's arrays to an inline ``tier.decode`` of the
    same files."""
    from cvcs_tpu_torch.data.loader import ChunkLoader
    from cvcs_tpu_torch.train.step import train_step

    loader = ChunkLoader(root, device="cuda", **kw)
    ds = loader.dataset
    decode = ds._decode
    decoded = {}                          # path -> (seconds, array)

    def timed_decode(path):
        t0 = time.perf_counter()
        arr = decode(path)
        decoded[str(path)] = (time.perf_counter() - t0, arr)
        return arr

    ds._decode = timed_decode
    lead = not first
    if lead:
        first.update(chunks=[], arrays={})
    chunks, prefetched, same, same_arrays = [], [], True, True
    with reader_tier(tier):
        for c in range(TIER_CHUNKS):
            decoded.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk = loader.get_chunk(c)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dec = sum(t for t, _ in decoded.values()) * 1e3
            # the chunk's first steps: on chunks 1 and 2 while the worker
            # decodes the next chunk, on chunk 3 with nothing queued;
            # queued_done: the steps taken before the next chunk's 4
            # rasters were all cached (0: already during get_chunk)
            queued_done = None
            t0 = time.perf_counter()
            for i, batch in zip(range(TIER_STEPS), chunk.batches(B_TRAIN)):
                if queued_done is None and cached(tier) >= 4:
                    queued_done = i
                train_step(state, fn, batch.image, batch.mask)
            torch.cuda.synchronize()
            chunks.append(dict(ms=ms, decode_ms=dec, decode_share=dec / ms,
                               patches=len(chunk), rasters=len(decoded),
                               steps_ms=(time.perf_counter() - t0) * 1e3,
                               queued_done_at_step=queued_done))
            if c and lead:
                prefetched.append(dict(decoded))
            parts = (chunk.images, chunk.masks, chunk.contexts)
            if lead:
                first["chunks"].append(parts)
                first["arrays"].update(
                    (k, arr) for k, (_, arr) in decoded.items())
            else:
                same = same and all(
                    (a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(parts, first["chunks"][c]))
                same_arrays = same_arrays and all(
                    np.array_equal(arr, first["arrays"][k])
                    for k, (_, arr) in decoded.items())
            del chunk, parts
        assert cached(tier) == 0
    equal = True
    for chunk, got in zip(chunks[1:], prefetched):
        serial_ms = 0.0
        for path, (_, arr) in got.items():
            t0 = time.perf_counter()
            want = tier.decode(path)
            serial_ms += (time.perf_counter() - t0) * 1e3
            equal = equal and np.array_equal(arr, want)
        chunk["inline_decode_ms"] = serial_ms
    del prefetched, decoded
    cold, warm_chunk, steady = chunks
    if lead:
        check = (f"an inline decode of the 4 rasters of chunk 2 "
                 f"{warm_chunk['inline_decode_ms']:.1f} ms, of chunk 3 "
                 f"{steady['inline_decode_ms']:.1f} ms serially, arrays "
                 f"equal to take's: {equal}")
    else:
        check = (f"the {len(first['arrays'])} rasters' arrays and the "
                 f"chunks equal to the first leg's: {same_arrays}, {same}")
    log(f"  host tier ({name}), ChunkLoader over {2 * TIER_CHUNKS} scenes "
        f"{CONTEXT_SCENE[0]}x{CONTEXT_SCENE[1]} (TIFF), 2 a chunk, p 224, "
        f"load_context, random_shift: chunk 1 cold {cold['ms']:.1f} ms, "
        f"of it {cold['decode_ms']:.1f} ms decoding its {cold['rasters']}"
        f" rasters inline ({cold['decode_share'] * 100:.1f}%) while the "
        f"worker decodes chunk 2, then {TIER_STEPS} Unetv2 bf16 steps "
        f"{cold['steps_ms']:.1f} ms; chunk 2 (decoded during chunk 1's "
        f"get_chunk) {warm_chunk['ms']:.1f} ms, of it "
        f"{warm_chunk['decode_ms']:.1f} ms in take "
        f"({warm_chunk['decode_share'] * 100:.1f}%), then {TIER_STEPS} "
        f"steps {warm_chunk['steps_ms']:.1f} ms while the worker decodes "
        f"chunk 3 (all cached before step "
        f"{warm_chunk['queued_done_at_step']} of {TIER_STEPS}; None: "
        f"after the last); chunk 3 (decoded during chunk 2's get_chunk and "
        f"steps) {steady['ms']:.1f} ms, of it {steady['decode_ms']:.1f} "
        f"ms in take ({steady['decode_share'] * 100:.1f}%), then "
        f"{TIER_STEPS} steps with nothing queued {steady['steps_ms']:.1f}"
        f" ms (the steps beside chunk 3's decode at "
        f"{warm_chunk['steps_ms'] / steady['steps_ms']:.3f}x); {check} "
        f"({smi})")
    assert equal and same and same_arrays
    assert all(c["rasters"] == 4 for c in chunks)
    return dict(chunk_cold=cold, chunk_prefetched=warm_chunk,
                chunk_steady=steady, arrays_equal_inline=equal if lead
                else None, equal_to_first_leg=None if lead
                else same and same_arrays,
                steps_beside_decode_ratio=(warm_chunk["steps_ms"]
                                           / steady["steps_ms"]))


def host_tier_path(result: dict) -> None:
    """Phase 11: the host tier (``cvcs_tpu_torch.native``: the C++ library,
    its decode worker and its writer thread) beside its plain version
    (``native.plain``: PIL on Python threads). Six 6800 x 7200 TIFF
    scenes with their index masks and phase 4's three 1792 x 2240 serve
    rasters are written; both tiers must decode the rasters, and a file of
    each codec and PNG type, to equal arrays (``tier_parity``). The chunk
    leg (``tier_leg``: two scenes a chunk, ``load_context`` and
    ``random_shift`` as phase 8) runs through the C++ tier, then through
    the plain one with the same seeds: every scene's and mask's array and
    every chunk equal. Then the serve daemon
    through the C++ tier on the three rasters (SwinUnet bf16, K1 24
    times): its ``batch_seconds`` beside the rasters' serial decode by
    each tier; its masks and journal must equal phase 4's (run alone, the
    masks must agree with ``predict_scene``'s palette on >= 99%, phase
    4's rule). Last, the convoy measure (``tools/pil_gil.py``) of both
    tiers' decode of a 3400 x 3400 TIFF and PNG beside a busy Python
    thread."""
    from PIL import Image

    from cvcs_tpu_torch import native
    from cvcs_tpu_torch.cli import serve as serve_cli
    from cvcs_tpu_torch.data.loader import ChunkLoader
    from cvcs_tpu_torch.data.palette import PALETTE
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model
    from cvcs_tpu_torch.native import plain
    from cvcs_tpu_torch.ops import losses
    from cvcs_tpu_torch.tools import pil_gil
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    t_phase = time.perf_counter()
    smi = gpu_line()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = retrieval_dataset(tmp / "scenes", CONTEXT_SCENE,
                                 n=2 * TIER_CHUNKS)
        watch = tmp / "in"
        watch.mkdir()
        rasters = [synthetic_scene(1792, 2240, seed=10 + i) for i in range(3)]
        for i, r in enumerate(rasters):
            Image.fromarray(r).save(watch / f"r{i}.png")
        t_data = time.perf_counter() - t_phase
        tier = dict(parity=tier_parity(tmp, sorted(watch.glob("r*.png"))))

        kw = dict(chunk_size=2, patch_size=224, random_shift=True,
                  load_context=True, seed=7)
        warm = ChunkLoader(root, device="cuda", **kw)
        warm.specify([0, 1])                  # one chunk: nothing queued
        warm.get_chunk(0)
        del warm
        model, _ = build_model("Unetv2", NC, seed=0, dtype=torch.bfloat16)
        state = TrainState(model, build_optimizer("SGD2", model.parameters()))
        state.optimizer.set_epoch(0)
        fn = losses.build_loss("wCEL", weights=np.ones(NC, np.float32),
                               ignore_background=True, device="cuda")
        image, mask, _ = mesh_batch()
        for _ in range(3):                    # warm-up, not counted
            train_step(state, fn, image.cuda(), mask.cuda())
        first: dict = {}
        for key, name, mod in (("cpp", "C++", native), ("plain", "PIL", plain)):
            tier[f"chunks_{key}"] = tier_leg(root, kw, mod, name, state, fn,
                                             smi, first)
        del model, state, first
        torch.cuda.empty_cache()

        # -- the serve daemon through the C++ tier -------------------------
        reset_counts()
        t0 = time.perf_counter()
        n = serve_cli.serve(dict(
            watch_dir=str(watch), net="SwinUnet", patch_size=224,
            border_correction=256, batch_tiles=128, num_classes=15,
            precision="bf16", max_polls=1, poll_s=0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernel_counts()
        out = watch / "output"
        entries = [json.loads(x) for x in
                   (out / "manifest.jsonl").read_text().splitlines()]
        got = served_outputs(out, entries)
        decode_s = {}
        for key, mod in (("cpp", native), ("plain", plain)):
            t0 = time.perf_counter()
            for f in sorted(watch.glob("r*.png")):
                mod.decode(f)
            decode_s[key] = time.perf_counter() - t0
        batch_s = entries[0]["batch_seconds"]
        ref = result.get("serve_outputs")
        if ref is not None:
            same = (got["journal"] == ref["journal"] and all(
                np.array_equal(v, ref["masks"][k])
                for k, v in got["masks"].items()))
            check = f"masks and journal equal to phase 4's: {same}"
        else:
            model, _ = build_model("SwinUnet", 16, seed=0,
                                   dtype=torch.bfloat16)
            seg = SceneSegmenter(model, InferenceConfig(
                patch_size=224, border_correction=256, batch_tiles=128,
                num_classes=16))
            agree = min(float((got["masks"][f"r{i}_mask.png"] == PALETTE[
                seg.predict_scene(r).cpu().numpy()]).all(-1).mean())
                for i, r in enumerate(rasters))
            del model, seg
            same = agree >= 0.99
            check = (f"run alone: masks vs predict_scene's palette, least "
                     f"{agree * 100:.4f}% (>= 99%)")
        log(f"  serve through the C++ tier: {n} rasters 1792x2240 in "
            f"{secs:.2f} s (model build included); batch_seconds "
            f"{batch_s:.3f} (segment, queue and flush the mask PNGs) beside "
            f"{decode_s['cpp']:.3f} s to decode the 3 rasters serially "
            f"through the C++ tier ({decode_s['plain']:.3f} s through PIL);"
            f" K1 {launches['K1']}; {check} ({smi})")
        assert n == 3 and launches["K1"] == 24 and same
        assert [j[:2] for j in got["journal"]] == [
            [f"r{i}.png", f"r{i}_mask.png"] for i in range(3)]
        tier["serve"] = dict(seconds=secs, batch_seconds=batch_s,
                             serial_decode_s=decode_s["cpp"],
                             serial_decode_plain_s=decode_s["plain"],
                             launches=launches, equal=same)
    tier["convoy"] = pil_gil.measure(
        TIER_SIDE, log=lambda line: log(f"  convoy: {line} ({smi})"))
    seconds = time.perf_counter() - t_phase
    log(f"  phase 11: {seconds:.1f} s (the scenes written in {t_data:.1f}; "
        "limit 90)")
    assert seconds < 90, seconds
    tier.update(seconds=seconds, card=smi)
    result["host_tier"] = tier


def build_all(sources) -> dict[str, float]:
    """Every CUDA source (one nvcc each, in parallel) and, beside them, the
    host tier's C++ library (g++); {name: seconds} of the builds that ran,
    the host library's under ``native/tile_reader.cpp``."""
    from cvcs_tpu_torch import native
    from cvcs_tpu_torch.ops import _build

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build)
        secs = _build.build(list(sources))
        secs["native/tile_reader.cpp"] = host.result()
    return secs


def phase11_alone() -> int:
    """``chip_smoke.py --phase11``: build the kernels and the host tier
    and run phase 11 alone (its serve check then holds the masks to
    ``predict_scene``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    secs = build_all(["swin_attn", "swin_attn_bwd", "augment", "fused_ce"])
    log(f"[2] built native/tile_reader.cpp with g++ in "
        f"{secs['native/tile_reader.cpp']:.1f} s")
    result: dict = {}
    host_tier_path(result)
    log(json.dumps(result["host_tier"]))
    return 0


def trace_train(out_path: str) -> int:
    """``chip_smoke.py --trace-train <json>``, run by
    :func:`trace_train_in_child` in a process of its own (a fresh
    profiler: see :func:`phase7`) and a scratch working directory (the
    trainer's ``debug/`` lands there): one SwinUnet epoch over one
    1792 x 2240 scene (8 steps, 8 validation batches) through
    ``cli.train``'s ``main`` (the train cell's recipe, ``augmentation:
    fused``) with ``profile_dir`` and, where matplotlib imports,
    ``debug_plot``. The trace it writes must name K1's, K2's and K5's CUDA
    kernels; each chunk must leave a debug PNG."""
    import importlib.util

    import yaml

    from cvcs_tpu_torch.cli import train as train_cli
    from cvcs_tpu_torch.utils.profiling import TRACE_FILE

    tmp = Path.cwd()
    plots = importlib.util.find_spec("matplotlib") is not None
    data = synthetic_dataset(tmp / "data", 1, seed=20)
    cfg = dict(
        train=data, validation=data,
        checkpoint_directory=str(tmp / "ckpt"), net="SwinUnet", epochs=1,
        chunk_size=1, validation_chunk_size=1, patch_size=224,
        batch_size=B_TRAIN, loss="wCEL", opt="SGD2", ignore_background=True,
        random_shift=True, augmentation="fused", precision_evaluation_freq=5,
        num_classes=15, precision="bf16", seed=0, debug_plot=plots)
    out = dict(matplotlib=plots)
    for attempt in (1, 2):
        cfg["profile_dir"] = str(tmp / f"prof{attempt}")
        path = tmp / "train.yaml"
        path.write_text(yaml.safe_dump(cfg))
        reset_counts()
        t0 = time.perf_counter()
        assert train_cli.main(["train", str(path)]) == 0
        torch.cuda.synchronize()
        trace = Path(cfg["profile_dir"]) / TRACE_FILE
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        out.update(seconds=time.perf_counter() - t0, attempt=attempt,
                   trace_mb=trace.stat().st_size / 1e6, events=len(events),
                   kernel_events=len(kernels), launches=kernel_counts(), **{
                       f"{k}_kernel_events": sum(key in n for n in kernels)
                       for k, key in (("K1", "swin_attn_fwd"),
                                      ("K2", "swin_bwd_"),
                                      ("K5", "augment_kernel"))})
        if kernels:
            break
    if plots:
        out["debug_pngs"] = sorted(p.name for p in (tmp / "debug").iterdir())
    Path(out_path).write_text(json.dumps(out))
    return 0


def trace_train_in_child() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "trace.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--trace-train", str(out)], check=True, timeout=600,
                       cwd=tmp)
        got = json.loads(out.read_text())
    log(f"  cli.train SwinUnet, 1 epoch, profile_dir: {got['seconds']:.2f} s "
        f"(attempt {got['attempt']}); trace.json {got['trace_mb']:.1f} MB, "
        f"{got['events']} events, {got['kernel_events']} CUDA kernels, of "
        f"them K1 {got['K1_kernel_events']}, K2 {got['K2_kernel_events']}, "
        f"K5 {got['K5_kernel_events']}; launch counters {got['launches']}")
    assert got["K1_kernel_events"] and got["K2_kernel_events"]
    assert got["K5_kernel_events"]
    if got["matplotlib"]:
        log(f"  debug_plot: {got['debug_pngs']}")
        assert got["debug_pngs"] == ["debug_e0_c0_b0.png"]
    else:
        log("  debug_plot: matplotlib is not importable on this host, so "
            "the debug plots are skipped and the trace alone is checked")
    return got


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


def phase7(out_path: str) -> int:
    """Phase 7, run as ``chip_smoke.py --phase7 <json>`` by
    :func:`phase7_in_child`: the kernels' times, written as JSON. Late in
    a long run torch.profiler records fewer and fewer device events (a
    third of the launches, then none at all for K3/K4/K5 in full runs on
    the H100, while a fresh process traced the same kernels in full), so
    the traces are taken in a fresh process; the kernels are already
    built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = dict(k1=time_k1(),
                 k1_train=time_k1(K2_CASES, K2_PER_STEP, B_TRAIN,
                                  "per train step"),
                 k1_band=time_k1(K1_BAND_CASES, K1_PER_BAND, 1,
                                 "per fullconv band forward"),
                 k2=time_k2())
    v1_k4, v1_k5 = first_designs()
    times["k5"] = time_k5(v1_k5)
    times["k3"], times["k4"] = time_k3k4(v1_k4)
    Path(out_path).write_text(json.dumps(times))
    return 0


def phase7_in_child() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "times.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--phase7", str(out)], check=True, timeout=900)
        return json.loads(out.read_text())


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

    sources = ("swin_attn", "swin_attn_bwd", "augment", "fused_ce",
               "augment_v1", "fused_ce_v1")   # the last two: phase 7's yardsticks
    secs = build_all(sources)
    for name in sources:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2] built {name}.cu for sm_90a in {secs.get(name, 0):.1f} s: "
            + " | ".join(ptxas[:6]) + (" | ..." if len(ptxas) > 6 else ""))
    log(f"[2] built native/tile_reader.cpp (the host tier) with g++ in "
        f"{secs['native/tile_reader.cpp']:.1f} s, beside the nvcc builds")

    log(f"[3] kernels vs plain versions on the card ({since(t_start)})")
    k1_err = check_k1()
    k1_band_err = check_k1(K1_BAND_CASES, batch=1)
    k1_chunk_err = check_k1([K1_CHUNK_CASE], batch=B_CHUNK_BLOCKS)
    k2_err, k2_scaled = check_k2()
    k5_err = check_k5()
    ce_err = check_k3k4()

    log(f"[4] serving path ({since(t_start)})")
    result: dict = {}
    scene = main_path(result)
    bf16_forward_check(result)
    unet_scene(result, scene)
    segformer_scene(result, scene)
    deeplab_scene(result, scene)
    log(f"[4] band paths: streamed, fullconv, chunked fullconv, ESA "
        f"({since(t_start)})")
    swin_band_paths(result, scene)
    log(f"[4] band paths of Unetv2, Resnet101 and SegformerMod "
        f"({since(t_start)})")
    other_band_paths(result, scene)
    del scene
    log(f"[4] retrieval: cli.retrieve over 1,920 patches ({since(t_start)})")
    compare_embeddings = retrieval_path(result)

    log(f"[5] training path ({since(t_start)}); first one traced epoch "
        "(profile_dir, debug_plot) in a process of its own, while the CPU "
        "computes phase 4's reference embeddings")
    result["trace_train"] = trace_train_in_child()
    compare_embeddings()
    with tempfile.TemporaryDirectory() as ckpts:
        ckpts = Path(ckpts)
        train_path(result)
        unet_train_path(result, ckpts)
        segformer_train_path(result, ckpts)
        deeplab_train_path(result, ckpts)
        log("[5] the ensemble of the trained Unetv2, Resnet101, MobileNet and "
            "SegformerMod")
        ensemble_path(result, ckpts)

    log(f"[6] training correctness ({since(t_start)})")
    train_correctness(result)
    unet_correctness(result)
    segformer_correctness(result)
    deeplab_correctness(result)

    log(f"[7] times (CUDA events, mean of 10 after 2 warm-up; "
        f"{since(t_start)}), in a process of their own")
    times = phase7_in_child()
    k1_times, k1_train, k1_band = (times["k1"], times["k1_train"],
                                   times["k1_band"])
    k2_times, k5_times = times["k2"], times["k5"]
    k3_times, k4_times = times["k3"], times["k4"]

    log(f"[8] contexts, random_tps, asynchronous checkpoints, reference "
        f"pickles and Orbax ({since(t_start)})")
    interop_path(result)
    il = result["interop"]["train"]["launches"]

    log(f"[9] the mesh on torch.distributed: two gloo ranks sharing the card,"
        f" one NCCL rank ({since(t_start)})")
    mesh_path(result)
    mk = result["mesh"]

    log(f"[10] spatially partitioned training and tensor parallelism: two "
        f"gloo ranks sharing the card ({since(t_start)})")
    spatial_path(result)
    sk = result["spatial"]

    log(f"[11] the host decode and encode tier ({since(t_start)})")
    host_tier_path(result)
    sw = sk["train"]["SwinUnet"]["runs"]
    smn = sk["train"]["MobileNet"]["runs"]

    tl = result["train"]["launches"]
    ul = result["unet_train"]["launches"]
    sl = result["segformer_train"]["launches"]
    rl = result["deeplab_train"]["resnet101"]["launches"]
    ml = result["deeplab_train"]["mobilenet"]["launches"]
    k5_paths = dict(swin_train=tl["K5"], swin_context_tps_train=il["K5"],
                    mesh_train_per_rank=mk["train"]["launches_per_epoch"]["K5"]
                    * 2,
                    spatial_train_per_rank=sw["train"]["launches"]["K5"]
                    + sw["resume"]["launches"]["K5"],
                    spatial_mobilenet_train_per_rank=smn["train"][
                        "launches"]["K5"] + smn["resume"]["launches"]["K5"],
                    segformer_train=sl["K5"],
                    segformer_fused_epoch=sl["K5_fused_epoch"],
                    resnet101_train=rl["K5"],
                    resnet101_fused_epoch=rl["K5_fused_epoch"],
                    mobilenet_train=ml["K5"])
    ce_paths = {k: dict(unet_fused_epoch=ul[k], segformer_fused_epoch=sl[k],
                        resnet101_fused_epoch=rl[k],
                        mesh_fused_step_per_rank=mk["steps"][
                            "step_Unetv2_fused"]["launches"][k],
                        spatial_fused_step_per_rank=sk["steps"][
                            "step_Unetv2_fused"]["launches"][k],
                        spatial_resnet101_fused_step_per_rank=sk["steps"][
                            "step_Resnet101_fused"]["launches"][k])
                for k in ("K3", "K4")}
    sb = result["swin_bands"]
    mesh_k1 = dict(mesh_scene_per_rank=mk["scene"]["launches"]["K1"],
                   mesh_fullconv_per_rank=mk["fullconv"]["launches"]["K1"],
                   mesh_scenes_per_rank=mk["scenes"]["launches"]["K1"],
                   mesh_serve_per_rank=mk["serve"]["launches"]["K1"],
                   mesh_train_epoch_per_rank=mk["train"][
                       "launches_per_epoch"]["K1"],
                   mesh_nccl_scene=mk["nccl"]["launches"]["K1"],
                   spatial_swin_step_per_rank=sk["steps"][
                       "step_SwinUnet_eager"]["launches"]["K1"],
                   spatial_train_epoch_per_rank=sw["train"]["launches"]["K1"])
    k1_paths = dict(window_scene=result["launches"],
                    serve=result["serve_launches"],
                    streamed=sb["streamed"]["launches"],
                    fullconv=sb["fullconv"]["launches"],
                    fullconv_padded=sb["fullconv_padded"]["launches"],
                    fullconv_chunks=sb["fullconv_chunks"]["launches"],
                    esa=sb["esa"]["launches"], swin_train=tl["K1"],
                    swin_context_tps_train=il["K1"], **mesh_k1)

    # what the per-geometry mask cache (models/swin.py attn_bias) holds on
    # the card at the end of the run: the memory its entries free
    from cvcs_tpu_torch.models import swin as swin_mod

    entries = swin_mod.attn_bias.cache_info().currsize
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    swin_mod.attn_bias.cache_clear()
    bias_cache_mb = (held - torch.cuda.memory_allocated()) / 1e6
    log(f"  attn_bias cache at the end of the run: {entries} geometries, "
        f"{bias_cache_mb:.1f} MB on the card")
    line = {"kernels": [
        kernel_entry(swin_attn.KERNEL, result["launches"], k1_err, k1_times,
                     "composite: F.layer_norm + F.linear + "
                     "F.scaled_dot_product_attention + F.linear",
                     "one SwinUnet forward at bc 256, 128 windows "
                     "(12 launches)", launches_train=tl["K1"],
                     launches_by_path=k1_paths,
                     train_step=dict(per=f"one SwinUnet train step at p 224,"
                                     f" batch {B_TRAIN} (12 launches)",
                                     **k1_train["total"],
                                     per_case=k1_train["per_case"]),
                     band_forward=dict(per="one SwinUnet fullconv band "
                                       "forward, 1824 x 7200, batch 1 (12 "
                                       "launches)", **k1_band["total"],
                                       per_case=k1_band["per_case"]),
                     band_max_abs_err=k1_band_err,
                     chunk_max_abs_err=k1_chunk_err,
                     bias_cache=dict(entries=entries, mb=bias_cache_mb)),
        kernel_entry(swin_attn.BWD_KERNEL, tl["K2"], k2_err, k2_times,
                     "composite: autograd backward of F.layer_norm + "
                     "F.linear + F.scaled_dot_product_attention + F.linear",
                     f"one SwinUnet train step at p 224, batch {B_TRAIN} "
                     "(12 launches)", max_scaled_err=k2_scaled,
                     launches_by_path=dict(
                         swin_train=tl["K2"], swin_context_tps_train=il["K2"],
                         mesh_train_epoch_per_rank=mk["train"][
                             "launches_per_epoch"]["K2"],
                         mesh_swin_step_per_rank=mk["steps"][
                             "step_SwinUnet_eager"]["launches"]["K2"],
                         spatial_swin_step_per_rank=sk["steps"][
                             "step_SwinUnet_eager"]["launches"]["K2"],
                         spatial_train_epoch_per_rank=sw["train"][
                             "launches"]["K2"])),
        kernel_entry(augment.KERNEL, sum(k5_paths.values()), k5_err, k5_times,
                     "composite: torch.flip / torch.rot90 per draw group, "
                     "then the contrast and normalisation ops",
                     f"one training chunk of {B_CHUNK} patches 224x224x3 "
                     "(1 launch)", launches_by_path=k5_paths,
                     old_ms=k5_times["old_ms"],
                     device_ms=k5_times["device_ms"],
                     old_device_ms=k5_times["old_device_ms"],
                     split=k5_times["split"], preset=k5_times["preset"],
                     gid15_chunk=k5_times["gid15_chunk"]),
        kernel_entry(fused_ce.KERNEL, sum(ce_paths["K3"].values()),
                     ce_err["k3_err"], k3_times,
                     "F.cross_entropy(NCHW logits, weight, ignore_index=0) "
                     "forward",
                     f"one Unetv2 train step at p 224, batch {B_TRAIN} (1 "
                     "launch), and one per validation batch",
                     launches_by_path=ce_paths["K3"],
                     device_ms=k3_times["device_ms"]),
        kernel_entry(fused_ce.BWD_KERNEL, sum(ce_paths["K4"].values()),
                     ce_err["k4_err"],
                     k4_times, "autograd backward of F.cross_entropy(NCHW "
                     "logits, weight, ignore_index=0)",
                     f"one Unetv2 train step at p 224, batch {B_TRAIN} (1 "
                     "launch)", launches_by_path=ce_paths["K4"],
                     max_scaled_err=ce_err["k4_rel"],
                     device_ms=k4_times["device_ms"],
                     old_ms=k4_times["old_ms"],
                     old_device_ms=k4_times["old_device_ms"],
                     split=k4_times["split"])],
        "scene_tiles_per_s": result["scene_tiles_per_s"],
        "serve_rasters_per_s": result["serve_rasters_per_s"],
        "serve_launches": result["serve_launches"],
        "forward": result["forward"],
        "f32_label_agreement": result["f32_agreement"],
        "bf16_forward_error": result["bf16_forward_error"],
        "train": result["train"],
        "train_correctness": result["correctness"],
        "unet_scene_tiles_per_s": result["unet_scene_tiles_per_s"],
        "unet_forward": result["unet_forward"],
        "unet_train": result["unet_train"],
        "unet_correctness": result["unet_correctness"],
        "segformer_scene": result["segformer_scene"],
        "segformer_train": result["segformer_train"],
        "segformer_correctness": result["segformer_correctness"],
        "deeplab_scene": result["deeplab_scene"],
        "deeplab_train": result["deeplab_train"],
        "deeplab_correctness": result["deeplab_correctness"],
        "ensemble": result["ensemble"],
        "swin_bands": result["swin_bands"],
        "other_bands": result["other_bands"],
        "retrieval": result["retrieval"],
        "trace_train": result["trace_train"],
        "interop": result["interop"],
        "mesh": result["mesh"],
        "spatial": result["spatial"],
        "host_tier": result["host_tier"],
        "seconds": time.perf_counter() - t_start}
    log(f"chip_smoke: {line['seconds']:.1f} s from start to the result")
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase7"]:
        sys.exit(phase7(sys.argv[2]))
    if sys.argv[1:2] == ["--trace-train"]:
        sys.exit(trace_train(sys.argv[2]))
    if sys.argv[1:2] == ["--phase9"]:
        sys.exit(phase9_alone())
    if sys.argv[1:2] == ["--phase10"]:
        sys.exit(phase10_alone())
    if sys.argv[1:2] == ["--phase11"]:
        sys.exit(phase11_alone())
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5]))
    sys.exit(main())
