"""The yardstick's frozen counts: peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense, at the full 700 W) and the bytes and operations the
program's hand-written kernels need, from their shapes.

A bound is max(bytes / peak bytes per second, operations / peak
operations per second), each input read once and each output written
once, whatever a kernel reads again. ``k1_bound``, ``k2_bound`` and
``k5_bound`` are copies of the counts ``chip_smoke.py`` applies (its
``k1_bound``, ``k2_bound`` and K5 bound), with the batch as an argument;
the tests hold them equal. Nothing here imports the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
BYTES = {"bf16": 2, "f32": 4}


def hw(v) -> tuple[int, int]:
    """A case's map size: an int for a square map, else (rows, cols)."""
    return (v, v) if isinstance(v, int) else tuple(v)


def k1_bound(case, dtype: str, masked: bool, batch: int) -> tuple[float, float]:
    """K1 (LN, QKV, masked window attention, output projection) on a
    case (name, Hp, C, heads, win, h0, shift): (ms of its bytes at the
    memory rate, ms of its operations at the peak rate). x read and the
    output written, the four C x C weight blocks read, the f32 mask read
    when there is one; 8 N C^2 + 4 N T C operations."""
    _, hp, c, _, win, _, _ = case
    hp, wp = hw(hp)
    s = BYTES[dtype]
    n = batch * hp * wp
    t = win * win
    nwin = (hp // win) * (wp // win)
    nbytes = 2 * n * c * s + 4 * c * c * s + (nwin * t * t * 4 if masked else 0)
    flops = 8 * n * c * c + 4 * n * t * c
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def k2_bound(case, dtype: str, masked: bool, batch: int) -> tuple[float, float]:
    """K2 (K1's backward): x and the upstream gradient read, dx written,
    the weights read, the six f32 parameter gradients written, the mask
    read; 22 N C^2 + 12 N T C operations."""
    _, hp, c, _, win, _, _ = case
    hp, wp = hw(hp)
    s = BYTES[dtype]
    n = batch * hp * wp
    t = win * win
    nwin = (hp // win) * (wp // win)
    nbytes = (3 * n * c * s + (4 * c * c + 4 * c) * s + 2 * c * 4
              + (4 * c * c + 6 * c) * 4 + (nwin * t * t * 4 if masked else 0))
    flops = 22 * n * c * c + 12 * n * t * c
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def k5_bound(patches: int, p: int, c: int) -> tuple[float, float]:
    """K5 (uint8 -> f32 dihedral + contrast + normalise) on a chunk: the
    uint8 patches read and the f32 ones written; 12 f32 operations a
    value."""
    n = patches * p * p * c
    return (n * (1 + 4) / HBM_BYTES_PER_S * 1e3,
            n * 12 / PEAK_FLOPS["f32"] * 1e3)


def swin_attn_calls(cfg: dict, size: int) -> list[tuple[tuple, bool]]:
    """The window-attention op calls of one forward of the Swin
    configuration ``cfg`` on size x size inputs, in order: ((name, Hp,
    C, heads, win, h0, shift), masked) for every block whose window is
    at least 4 (the smaller ones are not the kernel's). Hp is the map
    padded to a multiple of the window; a block is masked when it is
    shifted or padded."""
    calls = []
    h0 = size // cfg["patch"]
    for s, (c, depth, heads) in enumerate(zip(cfg["dims"], cfg["depths"],
                                              cfg["heads"])):
        if s:
            h0 //= 2
        for d in range(depth):
            win = min(cfg["window"], h0)
            shift = win // 2 if d % 2 and win > 1 and h0 > win else 0
            if win < 4:
                continue
            hp = -(-h0 // win) * win
            calls.append(((f"s{s + 1}", hp, c, heads, win, h0, shift),
                          bool(shift) or hp != h0))
    return calls


def swin_attn_bound_ms(cfg: dict, size: int, batch: int) -> float:
    """The bound of one forward's window-attention calls at ``batch``."""
    return sum(max(k1_bound(case, "bf16", masked, batch))
               for case, masked in swin_attn_calls(cfg, size))
