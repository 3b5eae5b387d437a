"""Swin fused window attention: LN -> QKV -> masked window softmax
attention -> output projection, forward and backward as CUDA kernels.

Replaces the Pallas TPU kernels of ``cvcs_tpu/ops/pallas_swin.py`` (public
op ``fused_window_attention``):

* K1, the forward ``_fwd_pallas`` / ``_make_kernel``, by
  ``csrc/swin_attn.cu``;
* K2, the backward ``_bwd_pallas`` / ``_make_bwd_kernel``, by
  ``csrc/swin_attn_bwd.cu``.

Both are CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use and
bound with ctypes (see :mod:`._build`).

What bounds K1 on the H100: per call it does 8*N*C^2 + 4*N*T*C
operations (N tokens, T = 64 per window) for 2*N*C elements read and
written plus the weights. At the main path's stage 1 (C = 96) that is
~256 operations per byte, at the card's bf16 balance point (~295); the
deeper stages (C = 192..768) are bound by operations. The design keeps
every intermediate (LN output, q/k/v, the (T, T) scores) on chip, one
thread block per window, so device memory sees the input, the weights,
the output and one scratch of merged head outputs that stays in L2. Its
products run on the CUDA cores in f32, which caps it far below the
tensor-core bound; moving the three products onto ``mma``/``wgmma`` is
the next step. K2's design is described in its source.

:class:`SwinWindowAttentionFn` is the autograd op: its forward is K1 and
its backward K2 on a CUDA tensor; on a CPU tensor it runs the plain
versions :func:`swin_window_attention_plain` and
:func:`swin_window_attention_bwd_plain`, the same functions in plain
torch with the kernels' casting points. It takes the float32 parameters
and casts them inside, so their gradients come back in float32.
:func:`swin_window_attention` goes through it and raises on any shape
the kernels do not take. ``launches`` counts K1 launches,
``bwd_launches`` K2 launches.
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
BWD_KERNEL = dict(
    name="swin_window_attention_bwd",
    route="cuda",
    source="cvcs_tpu_torch/csrc/swin_attn_bwd.cu",
    replaces="cvcs_tpu/ops/pallas_swin.py:436",
)

LN_EPS = 1e-6        # flax nn.LayerNorm default
MAX_TOKENS = 64      # win <= 8
MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0         # K1 launches since the caller last reset it
bwd_launches = 0     # K2 launches since the caller last reset it


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


def swin_window_attention_bwd_plain(x, ln_s, ln_b, wqkv, bqkv, wout, bout,
                                    bias, g, *, win: int, heads: int):
    """Plain torch twin of K2 (``_make_bwd_kernel``), on its casting
    points: LN and QKV recomputed as in the forward (LN output and qkv
    rounded to x.dtype); da = g wout^T rounded; per head the probabilities
    p rounded while p32 stays f32 for ds, the recomputed head output o
    rounded (it feeds dwout); ds rounded; the merged dq/dk/dv rounded (the
    kernel's dqkv scratch is in x.dtype); every product accumulates in
    f32; dbout = sum g and dbqkv = sum dq2 in f32; dlns = sum dln * xhat,
    dlnb = sum dln; dx in f32, then cast.

    Returns (dx in x.dtype, then the f32 grads of ln_s, ln_b, wqkv, bqkv,
    wout, bout)."""
    b, hp, wp, c = x.shape
    t = win * win
    dt = x.dtype
    d = c // heads
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)

    def cast(a):                     # round to the compute dtype, keep f32
        return a.to(dt).to(f32)

    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rs = torch.rsqrt(var + LN_EPS)
    xhat = (xf - mu) * rs
    lns = ln_s.to(f32)
    tok = cast(window_partition(xhat * lns + ln_b.to(f32), win))  # (nb, T, C)
    w_qkv = cast(wqkv)
    qkv = cast(tok @ w_qkv + cast(bqkv))
    gw = cast(window_partition(g, win))
    da = cast(gw @ cast(wout).t())
    nb = qkv.shape[0]

    def heads_of(a):   # (nb, T, C) -> (nb, heads, T, d)
        return a.reshape(nb, t, heads, d).permute(0, 2, 1, 3)

    def merge(a):      # (nb, heads, T, d) -> (nb, T, C)
        return a.permute(0, 2, 1, 3).reshape(nb, t, c)

    q, k, v = (heads_of(qkv[..., :c]), heads_of(qkv[..., c:2 * c]),
               heads_of(qkv[..., 2 * c:]))
    do = heads_of(da)
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        nwin = bias.shape[0]
        s = (s.reshape(-1, nwin, heads, t, t)
             + bias.to(f32)[None, :, None]).reshape(nb, heads, t, t)
    p32 = torch.softmax(s, dim=-1)
    p = cast(p32)
    o = cast(p @ v)
    dp = do @ v.transpose(-1, -2)
    dv = p.transpose(-1, -2) @ do
    ds = cast(p32 * (dp - (dp * p32).sum(-1, keepdim=True)) * scale)
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dq2 = cast(torch.cat([merge(dq), merge(dk), merge(dv)], -1)).reshape(-1, 3 * c)
    a2 = merge(o).reshape(-1, c)
    g2 = gw.reshape(-1, c)
    dwout = a2.t() @ g2
    dbout = g2.sum(0)
    dbqkv = dq2.sum(0)
    dwqkv = tok.reshape(-1, c).t() @ dq2
    dln = window_merge((dq2 @ w_qkv.t()).reshape(nb, t, c), win, hp, wp)
    dlns = (dln * xhat).sum((0, 1, 2))
    dlnb = dln.sum((0, 1, 2))
    dxh = dln * lns
    dx = rs * (dxh - dxh.mean(-1, keepdim=True)
               - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dx.to(dt), dlns, dlnb, dwqkv, dbqkv, dwout, dbout


@functools.cache
def _kernel():
    """The C entry point of ``csrc/swin_attn.cu``, built at first use."""
    from cvcs_tpu_torch.ops import _build

    fn = _build.load("swin_attn").cvcs_swin_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def _bwd_kernel():
    """The C entry points of ``csrc/swin_attn_bwd.cu`` (launch, workspace
    size), built at first use."""
    from cvcs_tpu_torch.ops import _build

    lib = _build.load("swin_attn_bwd")
    fn = lib.cvcs_swin_attn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    ws = lib.cvcs_swin_attn_bwd_workspace
    ws.restype = ctypes.c_size_t
    ws.argtypes = [ctypes.c_int] * 6
    return fn, ws


def _on_device(x, plain, kernel):
    """The no-fallback rule: a CPU tensor runs the plain version, a CUDA
    tensor the kernel, anything else raises."""
    if x.device.type == "cpu":
        return plain
    if x.device.type != "cuda":
        raise ValueError(f"no swin_attn kernel for device {x.device}")
    return kernel


def _fwd_kernel(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, *, win, heads):
    """Launch K1 (the caller has checked the shapes)."""
    global launches
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


def _bwd_kernel_launch(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, g, *,
                       win, heads):
    """Launch K2 (the caller has checked the shapes). Returns dx in
    x.dtype and the six parameter grads in f32."""
    global bwd_launches
    fn, ws_bytes = _bwd_kernel()
    b, hp, wp, c = x.shape
    dt = x.dtype
    dev = x.device
    f32 = torch.float32
    x = x.contiguous()
    ins = [ln_s.to(f32).contiguous(), ln_b.to(f32).contiguous(),
           wqkv.to(dt).contiguous(), bqkv.to(dt).contiguous(),
           wout.to(dt).contiguous()]
    bias = None if bias is None else bias.to(f32).contiguous()
    g = g.to(dt).contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=f32, device=dev) for shape in
             ((c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,))]
    ws = torch.empty(ws_bytes(_DTYPES[dt], b, hp, wp, c, heads),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_DTYPES[dt], x.data_ptr(), *[a.data_ptr() for a in ins],
                None if bias is None else bias.data_ptr(), g.data_ptr(),
                dx.data_ptr(), *[a.data_ptr() for a in grads], ws.data_ptr(),
                b, hp, wp, c, heads, win, 1.0 / math.sqrt(c // heads), stream)
    if rc != 0:
        raise RuntimeError(
            f"swin_attn_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    return (dx, *grads)


class SwinWindowAttentionFn(torch.autograd.Function):
    """K1 forward and K2 backward as one autograd op.

    Takes the float32 parameters and casts them to x.dtype inside, as the
    JAX op's custom VJP does, so every parameter gradient comes back in
    f32 (cast to its parameter's dtype); dx comes back in x.dtype. The
    additive mask ``bias`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win,
                heads):
        ctx.win, ctx.heads = win, heads
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias)
        run = _on_device(x, swin_window_attention_plain, _fwd_kernel)
        return run(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias,
                   win=win, heads=heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias = ctx.saved_tensors
        run = _on_device(x, swin_window_attention_bwd_plain,
                         _bwd_kernel_launch)
        dx, *grads = run(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, g,
                         win=ctx.win, heads=ctx.heads)
        params = (ln_s, ln_b, wqkv, bqkv, wout, bout)
        return (dx, *[gr.to(p.dtype) for gr, p in zip(grads, params)],
                None, None, None)


def swin_window_attention(x, ln_s, ln_b, wqkv, bqkv, wout, bout,
                          bias=None, *, win: int, heads: int):
    """LN + QKV + masked window attention + output projection, with its
    backward.

    Args (the TPU op's layout, ``pallas_swin.fused_window_attention``):
      x: (B, Hp, Wp, C) float32 or bfloat16, padded to window multiples
        and already rolled for shifted blocks.
      ln_s, ln_b: LayerNorm scale and bias, (C,).
      wqkv, bqkv: QKV kernel (C, 3C) and bias (3C,).
      wout, bout: output kernel (C, C) and bias (C,).
      bias: additive f32 mask (nWin, T, T), 0 = attend, -1e9 = blocked,
        or None.
    Returns (B, Hp, Wp, C) in x.dtype, pre-residual.

    A CUDA tensor launches the kernels (or raises); a CPU tensor runs the
    plain versions."""
    _check(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, win, heads)
    return SwinWindowAttentionFn.apply(x, ln_s, ln_b, wqkv, bqkv, wout, bout,
                                       bias, win, heads)
