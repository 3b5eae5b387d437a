"""The DeepLab ASPP's atrous convolutions (2048 -> 256 channels, 3 x 3,
rates 12/24/36, bf16) on one card: cuDNN's dilated convolution against
the dense convolution over the rate's phase maps
(``models/deeplab.py`` ``phase_conv``, which the ASPP runs for a batch
of one).

    python -m cvcs_tpu_torch.tools.aspp_probe

Maps: the window path's batch of 128 windows at output stride 8 (32 x
32), a fullconv band's stage-4 map (228 x 900, batch 1), its tail's (172
x 900), a square 228 x 228 and two smaller batch-1 maps; a batch of 32
blocks of 60 x 116 (a block grid). Times are CUDA events, mean of 3
after one warm-up call; where cuDNN's first call takes more than 3 s,
that one call's time. The two results are compared: max absolute
difference, the same taps summed in other orders. The last line printed is a JSON object of
the times.
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch import nn

from cvcs_tpu_torch.models.blocks import conv_nhwc
from cvcs_tpu_torch.models.deeplab import phase_conv

SHAPES = [(128, 32, 32), (1, 60, 116), (1, 116, 228), (1, 228, 228),
          (1, 228, 900), (1, 172, 900), (32, 60, 116)]
RATES = (12, 24, 36)


def timed(fn, iters: int = 3, warm: bool = True):
    """(output of the last call, mean ms over ``iters`` calls)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        y = fn()
    end.record()
    torch.cuda.synchronize()
    return y, start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("aspp_probe: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with torch.inference_mode():
        for shape in SHAPES:
            x = torch.randn(*shape, 2048, device="cuda", generator=g,
                            dtype=torch.bfloat16)
            for r in RATES:
                conv = nn.Conv2d(2048, 256, 3, padding=r, dilation=r,
                                 bias=False).cuda()
                row = dict(shape=shape, rate=r)
                # one cold call first: where cuDNN takes its direct kernel
                # a call lasts seconds, and is not repeated
                ref, row["cudnn_dilated_ms"] = timed(
                    lambda: conv_nhwc(x, conv, padding=r), 1, warm=False)
                if row["cudnn_dilated_ms"] < 3000:
                    ref, row["cudnn_dilated_ms"] = timed(
                        lambda: conv_nhwc(x, conv, padding=r))
                got, row["phase_maps_ms"] = timed(
                    lambda: phase_conv(x, conv))
                row["max_abs_diff"] = float(
                    (got.float() - ref.float()).abs().max())
                print(json.dumps(row), flush=True)
                rows.append(row)
    print(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
