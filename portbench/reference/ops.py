"""Plain PyTorch operations of the benchmark's reference models.

Everything here is written from the published descriptions of the layers
(convolution, transposed convolution, BatchNorm, LayerNorm, windowed
multi-head attention) with nothing taken from the program under test.
Tensors are float32; :func:`exact` turns TF32 off so that float32
products stay float32 on the card.

``prec="fp8"`` is the benchmark's control: every operand of a
convolution or a product is rounded to float8 (e4m3, one scale per
tensor, as fp8 inference scales it) before the float32 arithmetic, and
in a backward every gradient reaching such an operand to e5m2. It is the
reference "in the nearest precision below" the bfloat16 the
configurations state, and the correctness limits must fail it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
MASKED = -1e9          # additive score of a key a query may not see


@contextlib.contextmanager
def exact():
    """float32 products without TF32 inside the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one per-tensor scale
    that maps its largest magnitude to ``fmax``, back in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def q(x: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a product in precision ``prec`` ("f32" or "fp8")."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


# -- NCHW layers --------------------------------------------------------------
def conv(x, w, b=None, stride: int = 1, padding: int = 0, prec="f32"):
    """2-D convolution, NCHW, zero padding on every side."""
    return F.conv2d(q(x, prec), q(w, prec), b, stride, padding)


def conv_t(x, w, b=None, stride: int = 2, prec="f32"):
    """Transposed convolution (weight (in, out, k, k)), NCHW."""
    return F.conv_transpose2d(q(x, prec), q(w, prec), b, stride)


def batch_norm(x, w, b, mean, var, train: bool, eps: float = 1e-5):
    """BatchNorm over the channel axis 1: batch statistics (biased
    variance) in training, the running ones otherwise."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
            * w.view(shape) + b.view(shape))


def max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def center_crop(x, h: int, w: int):
    top = (x.shape[2] - h) // 2
    left = (x.shape[3] - w) // 2
    return x[:, :, top:top + h, left:left + w]


# -- NHWC layers --------------------------------------------------------------
def conv_nhwc(x, w, b=None, stride: int = 1, padding: int = 0, prec="f32"):
    return conv(x.permute(0, 3, 1, 2), w, b, stride, padding,
                prec).permute(0, 2, 3, 1)


def conv_t_nhwc(x, w, b=None, stride: int = 2, prec="f32"):
    return conv_t(x.permute(0, 3, 1, 2), w, b, stride,
                  prec).permute(0, 2, 3, 1)


def batch_norm_nhwc(x, w, b, mean, var, train: bool, eps: float = 1e-5):
    return batch_norm(x.permute(0, 3, 1, 2), w, b, mean, var, train,
                      eps).permute(0, 2, 3, 1)


def layer_norm(x, w, b, eps: float):
    """LayerNorm over the last axis (biased variance)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def linear(x, w, b=None, prec="f32"):
    """x @ w.T + b with ``w`` stored (out, in)."""
    y = q(x, prec) @ q(w, prec).t()
    return y if b is None else y + b


def window_attention(x, mask, wqkv, bqkv, wout, bout, heads: int,
                     prec="f32"):
    """Multi-head self-attention inside each window: ``x`` (nW*B, T, C)
    tokens, ``mask`` (nW, T, T) bool (True: may attend) or None; scores
    scaled by 1/sqrt(C / heads), masked keys at -1e9 before the
    softmax."""
    nb, t, c = x.shape
    d = c // heads
    qkv = linear(x, wqkv, bqkv, prec)

    def split(a):           # (nb, T, C) -> (nb, heads, T, d)
        return a.reshape(nb, t, heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = split(qkv[..., :c]), split(qkv[..., c:2 * c]), \
        split(qkv[..., 2 * c:])
    s = (q(qh, prec) @ q(kh, prec).transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        nw = mask.shape[0]
        add = torch.where(mask, 0.0, MASKED).to(s.dtype)
        s = (s.reshape(-1, nw, heads, t, t) + add[None, :, None]).reshape(
            nb, heads, t, t)
    p = torch.softmax(s, dim=-1)
    o = (q(p, prec) @ q(vh, prec)).permute(0, 2, 1, 3).reshape(nb, t, c)
    return linear(o, wout, bout, prec)


def windows(x, win: int):
    """(B, H, W, C) -> (B * nW, win*win, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def unwindows(x, win: int, b: int, h: int, w: int):
    c = x.shape[-1]
    x = x.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shifted_window_mask(h0: int, w0: int, win: int, shift: int,
                        device) -> torch.Tensor | None:
    """Swin's attention mask on a map of h0 x w0 tokens padded up to a
    multiple of ``win`` and cyclically shifted by ``shift``: a query may
    attend a key of the same region of the shifted map (Liu et al.,
    Fig. 4) that is not a pad token. (nW, T, T) bool, or None when
    neither a shift nor a pad needs it."""
    h, w = -(-h0 // win) * win, -(-w0 // win) * win
    if shift == 0 and (h, w) == (h0, w0):
        return None
    region = torch.zeros(h, w, dtype=torch.int64, device=device)
    if shift:
        n = 0
        for hs in (slice(0, h - win), slice(h - win, h - shift),
                   slice(h - shift, h)):
            for ws in (slice(0, w - win), slice(w - win, w - shift),
                       slice(w - shift, w)):
                region[hs, ws] = n
                n += 1
    valid = torch.zeros(h, w, dtype=torch.bool, device=device)
    valid[:h0, :w0] = True
    valid = torch.roll(valid, (-shift, -shift), (0, 1))
    rid = windows(region[None, :, :, None], win)[..., 0]      # (nW, T)
    ok = windows(valid[None, :, :, None], win)[..., 0]
    return (rid[:, :, None] == rid[:, None, :]) & ok[:, None, :]
