"""mfu.scene: the model's operations for the tiles the window completed
(a forward of one border-correction window each, counted on the plain
reference) over the window, as a share of the H100's bf16 peak. The
profiler's own start and stop are taken out of the window."""

from portbench.counts import PEAK_FLOPS


def read(r):
    window = r["window_s"] - r.get("profiler_s", 0.0)
    if not r["units"] or window <= 0:
        return None
    return r["flops_per_unit"] * r["units"] / window / PEAK_FLOPS["bf16"] * 100
