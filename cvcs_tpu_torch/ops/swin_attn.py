"""Swin fused window attention, forward: LN -> QKV -> masked window
softmax attention -> output projection, in one CUDA kernel.

Replaces the Pallas TPU kernel ``_fwd_pallas`` / ``_make_kernel`` of
``cvcs_tpu/ops/pallas_swin.py`` (public op ``fused_window_attention``).
The kernel is ``csrc/swin_attn.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and bound with ctypes (see :mod:`._build`).

What bounds it on the H100: per call it does 8*N*C^2 + 4*N*T*C
operations (N tokens, T = 64 per window) for 2*N*C elements read and
written plus the weights. At the main path's stage 1 (C = 96) that is
~256 operations per byte, at the card's bf16 balance point (~295); the
deeper stages (C = 192..768) are bound by operations. The design keeps
every intermediate (LN output, q/k/v, the (T, T) scores) on chip, one
thread block per window, so device memory sees the input, the weights,
the output and one scratch of merged head outputs that stays in L2. Its
products run on the CUDA cores in f32, which caps it far below the
tensor-core bound; moving the three products onto ``mma``/``wgmma`` is
the next step.

:func:`swin_window_attention` launches the kernel for a CUDA tensor and
raises on any shape the kernel does not take; for a CPU tensor it runs
:func:`swin_window_attention_plain`, the same function in plain torch
with the kernel's casting points. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL = dict(
    name="swin_window_attention",
    route="cuda",
    source="cvcs_tpu_torch/csrc/swin_attn.cu",
    replaces="cvcs_tpu/ops/pallas_swin.py:176",
)

LN_EPS = 1e-6        # flax nn.LayerNorm default
MAX_TOKENS = 64      # win <= 8
MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0         # kernel launches since the caller last reset it


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWin, win*win, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_merge(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    b = x.shape[0] // ((h // win) * (w // win))
    c = x.shape[-1]
    x = x.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def layer_norm_f32(xf: torch.Tensor, scale, bias) -> torch.Tensor:
    """The TPU kernel's LayerNorm on f32 input: f32 stats, fast variance
    max(E[x^2] - mu^2, 0), eps 1e-6."""
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def swin_window_attention_plain(x, ln_s, ln_b, wqkv, bqkv, wout, bout,
                                bias=None, *, win: int, heads: int):
    """Plain torch twin of the kernel, on its casting points: LN in f32
    then cast; QKV with f32 accumulation plus the bias (cast to x.dtype)
    in f32, then cast; f32 scores times 1/sqrt(d) plus the f32 bias;
    f32 softmax, cast; P.V in f32, cast; output projection in f32 plus
    bias, cast."""
    b, hp, wp, c = x.shape
    t = win * win
    dt = x.dtype
    d = c // heads
    f32 = torch.float32
    ln = layer_norm_f32(x.to(f32), ln_s.to(f32), ln_b.to(f32)).to(dt)
    tok = window_partition(ln, win).to(f32)
    qkv = tok @ wqkv.to(dt).to(f32) + bqkv.to(dt).to(f32)
    qkv = qkv.to(dt).to(f32)
    nb = qkv.shape[0]

    def heads_of(a):   # (nb, T, C) -> (nb, heads, T, d)
        return a.reshape(nb, t, heads, d).permute(0, 2, 1, 3)

    q, k, v = (heads_of(qkv[..., :c]), heads_of(qkv[..., c:2 * c]),
               heads_of(qkv[..., 2 * c:]))
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if bias is not None:
        nwin = bias.shape[0]
        s = (s.reshape(-1, nwin, heads, t, t)
             + bias.to(f32)[None, :, None]).reshape(nb, heads, t, t)
    p = torch.softmax(s, dim=-1).to(dt).to(f32)
    o = (p @ v).to(dt).to(f32)
    o = o.permute(0, 2, 1, 3).reshape(nb, t, c)
    out = (o @ wout.to(dt).to(f32) + bout.to(dt).to(f32)).to(dt)
    return window_merge(out, win, hp, wp)


def _check(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win, heads):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Hp, Wp, C), got {tuple(x.shape)}")
    b, hp, wp, c = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"swin_attn kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not 1 <= win * win <= MAX_TOKENS or hp % win or wp % win:
        raise ValueError(f"window {win} does not tile ({hp}, {wp}) or "
                         f"exceeds {MAX_TOKENS} tokens")
    if heads < 1 or c % heads or c // heads > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {heads} heads: head dim must divide "
                         f"C and be <= {MAX_HEAD_DIM}")
    shapes = {"ln_s": (ln_s, (c,)), "ln_b": (ln_b, (c,)),
              "wqkv": (wqkv, (c, 3 * c)), "bqkv": (bqkv, (3 * c,)),
              "wout": (wout, (c, c)), "bout": (bout, (c,))}
    if bias is not None:
        t = win * win
        shapes["bias"] = (bias, ((hp // win) * (wp // win), t, t))
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


@functools.cache
def _kernel():
    """The C entry point of ``csrc/swin_attn.cu``, built at first use."""
    from cvcs_tpu_torch.ops import _build

    fn = _build.load("swin_attn").cvcs_swin_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def swin_window_attention(x, ln_s, ln_b, wqkv, bqkv, wout, bout,
                          bias=None, *, win: int, heads: int):
    """LN + QKV + masked window attention + output projection.

    Args (the TPU op's layout, ``pallas_swin.fused_window_attention``):
      x: (B, Hp, Wp, C) float32 or bfloat16, padded to window multiples
        and already rolled for shifted blocks.
      ln_s, ln_b: LayerNorm scale and bias, (C,).
      wqkv, bqkv: QKV kernel (C, 3C) and bias (3C,).
      wout, bout: output kernel (C, C) and bias (C,).
      bias: additive f32 mask (nWin, T, T), 0 = attend, -1e9 = blocked,
        or None.
    Returns (B, Hp, Wp, C) in x.dtype, pre-residual.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    global launches
    _check(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win, heads)
    if x.device.type == "cpu":
        return swin_window_attention_plain(
            x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias,
            win=win, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"no swin_attn kernel for device {x.device}")
    fn = _kernel()
    b, hp, wp, c = x.shape
    dt = x.dtype
    x = x.contiguous()
    f32 = torch.float32
    args = [ln_s.to(f32).contiguous(), ln_b.to(f32).contiguous(),
            wqkv.to(dt).contiguous(), bqkv.to(dt).contiguous(),
            wout.to(dt).contiguous(), bout.to(dt).contiguous()]
    bias = None if bias is None else bias.to(f32).contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty(x.numel(), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPES[dt], x.data_ptr(), *[a.data_ptr() for a in args],
                None if bias is None else bias.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), b, hp, wp, c, heads,
                win, 1.0 / math.sqrt(c // heads), stream)
    if rc != 0:
        raise RuntimeError(f"swin_attn kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
