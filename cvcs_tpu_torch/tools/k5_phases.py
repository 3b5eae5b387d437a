"""Where K5's time goes: variants of ``csrc/augment.cu`` with one phase
taken out each, built and timed beside the kernel on one card.

    python -m cvcs_tpu_torch.tools.k5_phases

Each variant is the kernel's source with a textual edit; it computes a
wrong result on purpose and serves only to time what is left:

* ``no_stage``: no staging copies (the band reads whatever shared memory
  holds);
* ``no_gray``: no grayscale sum over the staged bytes;
* ``no_table``: no output table built;
* ``no_fetch``: no staged byte read per element (the table lookup stays);
* ``no_cluster``: one CTA per cluster, no exchange of partial sums;
* ``store_only``: ``no_cluster`` without staging, sum or table: the store
  loop alone.

Times are CUDA events, mean of 10 after 2 warm-up calls, on a 160-patch
chunk and on a 1,920-patch chunk of 224 x 224 x 3 uint8 patches, beside
torch's own uint8 -> f32 copy and an f32 fill of the same output. The
last line printed is a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from cvcs_tpu_torch.ops import _build, augment

NO_CLUSTER = [
    ("  cluster_arrive();\n  cluster_wait();", "  __syncthreads();"),
    ("t += *cluster.map_shared_rank(&part, r);", "t += part;"),
    ("  cluster_arrive();   // this CTA", "  // this CTA"),
    ("  cluster_wait();", ""),
    ("attr[0].val.clusterDim.x = plan.cluster;",
     "attr[0].val.clusterDim.x = 1;"),
]
NO_STAGE = [("      if (win < seg + len) cp_async16(sdst, win);",
             "      if (win == nullptr) cp_async16(sdst, win);")]
NO_GRAY = [("        gsum += gray_floor(row + t * C, c1, c2);",
            "        gsum += t;")]
NO_TABLE = [("  for (int e = tid; e < (lut ? C : 1) * 256; e += kThreads) {",
             "  for (int e = tid; e < 0; e += kThreads) {")]
NO_FETCH = [("    const uint8_t byte = staged ? stage[at + ch] : "
             "__ldg(src + at + ch);",
             "    const uint8_t byte = (uint8_t)(at + ch);")]
VARIANTS = {
    "kernel": [], "no_stage": NO_STAGE, "no_gray": NO_GRAY,
    "no_table": NO_TABLE, "no_fetch": NO_FETCH, "no_cluster": NO_CLUSTER,
    "store_only": NO_CLUSTER + NO_STAGE + NO_GRAY + NO_TABLE,
}


def build_variants(out_dir: Path) -> dict:
    """Write and compile every variant, one nvcc each, all at once;
    returns {name: the loaded C entry point}."""
    source = (_build.CSRC / "augment.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the edit no longer applies: "
                                   f"{old.strip()[:60]}")
            text = text.replace(old, new)
        cu = out_dir / f"augment_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libaugment_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(str(lib)).cvcs_fused_augment
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fns[name] = fn
    return fns


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k5_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    fns = build_variants(_build.BUILD_DIR / "k5_phases")
    result = {}
    for b in (160, 1920):
        g = torch.Generator(device="cuda").manual_seed(0)
        img = torch.randint(0, 256, (b, 224, 224, 3), generator=g,
                            device="cuda", dtype=torch.uint8)
        flips, rots, factors = augment.draw_dihedral(b, 0.6, g)
        mean = torch.linspace(60.0, 120.0, 3, device="cuda")
        std = torch.linspace(30.0, 70.0, 3, device="cuda")
        out = torch.empty(img.shape, dtype=torch.float32, device="cuda")
        want = augment.fused_augment_plain(img, flips, rots, factors, mean,
                                           std)
        times = {}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(img.data_ptr(), flips.data_ptr(), rots.data_ptr(),
                        factors.data_ptr(), mean.data_ptr(), std.data_ptr(),
                        out.data_ptr(), b, 224, 3,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times[name] = cuda_ms(call)
            if name == "kernel" and not torch.equal(out, want):
                raise AssertionError("the kernel disagrees with its plain "
                                     "version")
        times["torch_copy_u8_to_f32"] = cuda_ms(lambda: out.copy_(img))
        times["torch_fill_f32"] = cuda_ms(lambda: out.fill_(1.0))
        times["bound"] = b * 224 * 224 * 3 * 5 / 3.35e12 * 1e3
        print(f"B={b}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      times.items()) + " ms", flush=True)
        result[b] = times
        del img, out, want
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
