"""Layer helpers with flax numerics on NHWC tensors, and the convolutional
blocks of ``cvcs_tpu/models/blocks.py``: ``ConvBNAct`` (:108-140), the
UNet ``DecodeBlock`` arithmetic (:162-188), ``UpscaleBlock`` (:143-159),
``center_crop`` (:231-242), with BatchNorm in eval and train mode
(:35-102). The JAX ``ConvTranspose`` (:191-228) is ``nn.ConvTranspose2d``
run by :func:`conv_transpose_nhwc` on the exporter's flipped kernel.
flax's ``nn.Dropout`` is :class:`SeededDropout`, seeded per train step
by :func:`seed_dropout`.

Parameters live in ``nn.Conv2d`` / ``nn.LayerNorm`` / ``nn.BatchNorm2d``
holders, so state-dict names are torch's; the arithmetic is written out
here to follow the JAX package: activations stay NHWC and in the compute
dtype of their input, weights are cast to it at use, and normalisations
take f32 statistics and cast back.

On row strips (``core/mesh.py`` ``spatial_parallel``) the same helpers
compute each rank's rows of the single-device result. A convolution
takes a halo of the rows its window reaches beyond the strip, with the
``SAME`` pads of the *global* map (so only the first rank pads the top
and only the last the bottom); a strided one needs each strip to start
on a stride multiple, and otherwise, like a halo wider than a strip,
gathers the map, convolves it whole and keeps the rank's rows. The 2x2/2
max pool and transposed conv are local on even strips; a wider
transposed conv takes a halo too. BatchNorm sums over every rank, the
seeded dropout keeps the rank's rows of the global mask, and
``center_crop`` crops in global rows.

Under ``parallel/tp.py`` ``tensor_parallel`` a holder that
``shard_params`` cut to its slice of output channels computes that
slice; a consumer that needs every input channel gathers them first, and
BatchNorm runs on the slice (``tp.conv_input``, ``tp.full_channels``,
``tp.channel_slice``).
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.ops.resize import upsample_bilinear
from cvcs_tpu_torch.parallel import halo, tp


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, conv: nn.Conv2d, padding="same_flax") -> torch.Tensor:
    """``conv`` (its stride, dilation and groups) on an NHWC tensor in
    x.dtype. ``padding="same_flax"`` pads like flax's default ``SAME``
    (zero for a stride that divides the map); an int pads
    symmetrically. On row strips, each rank's rows of the whole map's
    result (:func:`_strip_conv`)."""
    x, weight, groups = tp.conv_input(x, conv)
    sp = mesh_lib.strip_mesh()
    if sp is not None:
        return _strip_conv(x, conv, padding, sp, weight, groups)
    return _conv(x, conv, padding, weight, groups)


def _conv(x, conv, padding, weight, groups) -> torch.Tensor:
    """The conv on a whole map."""
    if padding == "same_flax":
        (kh, kw), (dh, dw) = conv.kernel_size, conv.dilation
        sh, sw = conv.stride
        top, bottom = _same_pads(x.shape[1], (kh - 1) * dh + 1, sh)
        left, right = _same_pads(x.shape[2], (kw - 1) * dw + 1, sw)
        return _conv2d(x, conv, weight, groups, (left, right, top, bottom))
    return _conv2d(x, conv, weight, groups, padding=padding)


def _conv2d(x, conv, weight, groups, pads=(0, 0, 0, 0),
            padding=0) -> torch.Tensor:
    """``F.conv2d`` in x.dtype on the NCHW view of NHWC ``x`` (channels-last
    strides), zero-padded by ``pads`` (left, right, top, bottom) first and
    by ``padding`` in the conv."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2)
    if any(pads):
        y = F.pad(y, pads)
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv2d(y, weight.to(dt), bias, conv.stride, padding,
                 conv.dilation, groups)
    return y.permute(0, 2, 3, 1)


def _strip_conv(x, conv, padding, sp, weight, groups) -> torch.Tensor:
    """The conv on this rank's strip of rows: [halo above | strip | halo
    below] convolved with no row padding, the halos taken from the
    neighbours (zeros past the global map's edges, which are its pads).
    Each strip's outputs start at its first row / stride, so the strip
    must hold a whole number of strides of outputs; otherwise, or when a
    halo is wider than a strip, the map is gathered, convolved whole and
    split."""
    n = sp.shape[mesh_lib.SPATIAL_AXIS]
    h = x.shape[1]
    rows = h * n
    kh, sh, dh = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    k = (kh - 1) * dh + 1
    if padding == "same_flax":
        top, bottom = _same_pads(rows, k, sh)
        left, right = _same_pads(x.shape[2], (conv.kernel_size[1] - 1)
                                 * conv.dilation[1] + 1, conv.stride[1])
    else:
        top = bottom = left = right = int(padding)
    out = (rows + top + bottom - k) // sh + 1
    below = max(k - sh - top, 0)
    if out % n or out // n * sh != h or not halo.halo_fits(
            [h] * n, [top] * n, [below] * n):
        what = f"conv {tuple(conv.kernel_size)}/{sh} on {rows} rows"
        whole = halo.gather_rows(x, sp, what, "strips not aligned to the "
                                 "stride or halo wider than a strip")
        with mesh_lib.whole_rows():
            y = _conv(whole, conv, padding, weight, groups)
        if y.shape[1] % n:
            raise ValueError(f"{what}: {y.shape[1]} output rows do not "
                             f"split over {n} ranks")
        return halo.split_rows(y, sp)
    ext = halo.row_halo(x, sp, top, below)
    if k - sh - top < 0:               # rows no output of the strip reads
        ext = ext[:, :ext.shape[1] + (k - sh - top)]
    return _conv2d(ext, conv, weight, groups, (left, right, 0, 0))


def conv_transpose_nhwc(x, conv: nn.ConvTranspose2d,
                        padding: int = 0) -> torch.Tensor:
    """Transposed conv (flax ``nn.ConvTranspose`` with the exporter's
    flipped kernel) on an NHWC tensor in x.dtype. ``padding`` is torch's:
    flax's explicit padding k - 1 - p on each side. On row strips (where
    the output has stride x the input's rows), the rows of the inputs
    that reach the strip's outputs come as a halo and the output rows of
    the strip are kept."""
    x, weight, _ = tp.conv_input(x, conv)
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    sp = mesh_lib.strip_mesh()
    k, st = conv.kernel_size[0], conv.stride[0]
    above = below = 0
    if sp is not None:
        if k - 2 * padding != st:
            raise ValueError(f"transposed conv {k}/{st} padding {padding} "
                             "does not scale the rows by its stride")
        above, below = (k - 1 - padding) // st, (padding - 1) // st + 1
        x = halo.row_halo(x, sp, above, below)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(dt), bias,
                           conv.stride, padding)
    if above or below:
        h = x.shape[1] - above - below
        y = y[:, :, st * above:st * (above + h)]
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) rounded to ``dtype``, as the JAX models take an attention
    scale (``jnp.sqrt(jnp.asarray(n, dtype))``)."""
    return float(torch.tensor(float(n), dtype=dtype).sqrt())


def linear(x, layer: nn.Linear) -> torch.Tensor:
    x = tp.full_channels(x, layer.weight.shape[1])
    dt = x.dtype
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x, layer.weight.to(dt), bias)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 if it is f64: the dtype flax takes
    statistics in (``promote_types(dtype, float32)``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _affine(xf, mean, var, scale, bias, eps, dt):
    """flax ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias
    in xf's dtype (f32, or f64), cast to dt."""
    mul = torch.rsqrt(var + eps) * scale.to(xf.dtype)
    return ((xf - mean) * mul + bias.to(xf.dtype)).to(dt)


def layer_norm(x, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 fast-variance stats over the last axis
    (every channel: a channel-sharded input is gathered first)."""
    x = tp.full_channels(x, norm.normalized_shape[0])
    xf = at_least_f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return _affine(xf, mu, var, norm.weight, norm.bias, norm.eps, x.dtype)


def batch_norm_eval(x, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on running statistics over the last (channel) axis (the
    rank's channels of a channel-sharded input)."""
    mean, var, w, b = tp.channel_slice(
        x, (bn.running_mean, bn.running_var, bn.weight, bn.bias))
    return _affine(at_least_f32(x), mean, var, w, b, bn.eps, x.dtype)


def batch_stats(x):
    """f32 (or f64) batch statistics over every axis but the last, with
    flax's fast variance max(E[x^2] - E[x]^2, 0): (x in f32, mean,
    biased var, sample count).

    Under :func:`cvcs_tpu_torch.core.mesh.data_parallel` the statistics
    span the global batch, as JAX's do under a sharded ``jit``: the
    per-channel sums of x and x^2 and the count are summed over the data
    group, differentiably (the backward sums each rank's upstream
    gradient of the statistics, so every rank's share sees the global
    ones), and the count is the global count. On row strips the sums
    span every rank of the mesh; in a whole region the data group."""
    xf = at_least_f32(x)
    axes = tuple(range(x.dim() - 1))
    n = xf.numel() // xf.shape[-1]
    if mesh_lib.dp_size() == 1:
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        return xf, mean, var, n
    c = xf.shape[-1]
    sums = mesh_lib.dp_sum(torch.cat([
        xf.sum(axes), (xf * xf).sum(axes),
        xf.new_full((1,), float(n))]))
    count = sums[-1]
    mean = sums[:c] / count
    var = torch.clamp(sums[c:2 * c] / count - mean * mean, min=0.0)
    # the ranks' shares are equal, so the global count is known on the
    # host without reading ``count`` back
    return xf, mean, var, n * mesh_lib.dp_size()


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean, var, n: int) -> None:
    """The running-stats EMA with the holder's momentum in torch's terms
    (``bn.momentum``: 0.1 by default, MobileNet's 0.01), written as flax
    writes it, running = m * running + (1 - m) * batch with m = 1 -
    momentum; the running variance from the UNBIASED variance (factor n /
    (n - 1), ``n`` the samples the statistics span: every rank's under
    data parallelism), as torch does."""
    m = 1.0 - bn.momentum
    correction = n / max(n - 1, 1)
    bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
    bn.running_var.copy_(m * bn.running_var + (1 - m) * var * correction)


def batch_norm_train(x, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on batch statistics over the last (channel) axis, the
    JAX package's ``BatchNorm`` in train mode: f32 statistics
    (:func:`batch_stats`), normalisation with the biased variance (eps
    from ``bn``: 1e-5, or MobileNet's and GoogLeNet's 1e-3), and the
    running statistics updated with ``bn``'s momentum
    (:func:`update_running_stats`)."""
    xf, mean, var, n = batch_stats(x)
    update_running_stats(bn, mean, var, n)
    return _affine(xf, mean, var, bn.weight, bn.bias, bn.eps, x.dtype)


def batch_norm(x, bn: nn.BatchNorm2d) -> torch.Tensor:
    """:func:`batch_norm_train` or :func:`batch_norm_eval`, as the
    holder's mode (``bn.training``, set by the model's ``train()`` and
    ``eval()``) says."""
    return (batch_norm_train if bn.training else batch_norm_eval)(x, bn)


class SeededDropout(nn.Module):
    """flax ``nn.Dropout``: in training, keep each element with
    probability 1 - rate and scale it by 1 / (1 - rate) (the keep
    probability rounded to x.dtype, as JAX rounds a weak-typed scalar);
    the identity in eval mode, which draws nothing.

    The noise comes from the module's own ``torch.Generator`` on the
    input's device, never the global RNG: :func:`seed_dropout` seeds it
    from a (seed, step) pair before each train step. Under
    :func:`cvcs_tpu_torch.core.mesh.data_parallel` each rank draws the
    global batch's mask and keeps its own samples (and on row strips its
    rows). ``keep_mask`` (a boolean tensor of the global batch's shape),
    when set, is used instead of a draw, so tests can feed both
    frameworks one mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.keep_mask: torch.Tensor | None = None
        self._seed: int | None = None
        self._gen: torch.Generator | None = None

    def reseed(self, seed: int) -> None:
        self._seed, self._gen = seed, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        # under data parallelism: the global batch's mask, this rank's
        # samples of it (and on row strips its rows), so every rank draws
        # what one process draws for the whole batch
        n, i = mesh_lib.data_ranks(), mesh_lib.dp_index()
        sp = mesh_lib.strip_mesh()
        r, j = ((1, 0) if sp is None else
                (sp.shape[mesh_lib.SPATIAL_AXIS], sp.spatial_index))
        b, h = x.shape[:2]
        if self.keep_mask is not None:
            full = self.keep_mask.to(x.device)
        else:
            if self._seed is None:
                raise RuntimeError("dropout drawn before seed_dropout seeded "
                                   "its generator")
            if self._gen is None or self._gen.device != x.device:
                self._gen = torch.Generator(device=x.device)
                self._gen.manual_seed(self._seed)
            full = torch.rand((b * n, h * r) + tuple(x.shape[2:]),
                              generator=self._gen, device=x.device) < keep
        mask = full[i * b:(i + 1) * b, j * h:(j + 1) * h]
        return torch.where(mask, x / x.new_tensor(keep), x.new_zeros(()))


def seed_dropout(model: nn.Module, seed: int, step: int = 0) -> None:
    """Seed every :class:`SeededDropout` of ``model`` from ``(seed,
    step)``, the port of the JAX step's ``fold_in(dropout_key, step)``:
    each step's noise depends on the seed and the step only, so a resumed
    run draws what the first run drew. Micro-batches of one step draw in
    turn from the one seeded generator. The pair is hashed (splitmix64)
    because the CPU generator keeps only a seed's low 32 bits."""
    mask = (1 << 64) - 1
    z = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    mixed = z ^ (z >> 31)
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.reseed(mixed)


def max_pool_nhwc(x: torch.Tensor, k: int = 2, stride: int | None = None,
                  padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """k x k max pool on an NHWC tensor, flax ``nn.max_pool`` with
    ``padding`` on every side filled with -inf (the default: 2x2, stride
    2, VALID). ``ceil_mode`` pads the bottom and right edges with -inf
    until the last window fits, as torch's ``MaxPool2d(ceil_mode=True)``
    and the JAX GoogLeNet's ``_ceil_maxpool`` do. On row strips only
    the local case runs: k = stride, no padding, strips of whole
    windows."""
    if mesh_lib.strip_mesh() is not None and (
            stride not in (None, k) or padding or ceil_mode or x.shape[1] % k):
        raise ValueError(f"a {k}x{k} max pool on strips of {x.shape[1]} "
                         "rows is not local: gather the map first")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride or k, padding,
                     ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def decode(x, pairs) -> torch.Tensor:
    """The UNet ``DecodeBlock`` arithmetic: for each (conv, bn) pair,
    conv3x3 -> ReLU -> BN (the reference's swapped ReLU/BN order), BN on
    batch statistics (updating the running ones) in training, on the
    running statistics otherwise (:func:`batch_norm`)."""
    for conv, bn in pairs:
        x = batch_norm(torch.relu(conv_nhwc(x, conv, padding=1)), bn)
    return x


class DecodeBlock(nn.Module):
    """2 x [conv3x3 -> ReLU -> BN], eps 1e-5, under SwinUNet's names
    (``conv1``, ``bn1``, ``conv2``, ``bn2``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return decode(x, ((self.conv1, self.bn1), (self.conv2, self.bn2)))

    forward = decode


class ConvBNAct(nn.Module):
    """conv3x3 -> BN -> ReLU, the reference's
    ``UnetEncodeLayer`` under its names (``layer.0`` conv, ``layer.1``
    BN).

    ``remat=True`` recomputes the block's internals (conv output, BN
    normalisation) in the backward instead of keeping them
    (``torch.utils.checkpoint``). The recomputation writes no buffer: the
    checkpointed function returns the batch statistics and the running
    ones are updated once, outside it, as flax's ``nn.remat`` does."""

    def __init__(self, cin: int, features: int, remat: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([nn.Conv2d(cin, features, 3, padding=1),
                                    nn.BatchNorm2d(features)])
        self.remat = remat

    def _train_block(self, x):
        conv, bn = self.layer
        y = conv_nhwc(x, conv, padding=1)
        yf, mean, var, n = batch_stats(y)
        y = _affine(yf, mean, var, bn.weight, bn.bias, bn.eps, y.dtype)
        return torch.relu(y), mean, var, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.layer
        if not self.training:
            y = torch.relu(batch_norm_eval(conv_nhwc(x, conv, padding=1), bn))
        else:
            if self.remat and torch.is_grad_enabled():
                # the recomputation runs in the backward, outside the
                # step's parallel contexts: it re-enters the forward's
                state = mesh_lib.mesh_state()
                y, mean, var, n = checkpoint(
                    self._train_block, x, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        mesh_lib.restore_state(state)))
            else:
                y, mean, var, n = self._train_block(x)
            update_running_stats(bn, mean.detach(), var.detach(), n)
        return y


class UpscaleBlock(nn.Module):
    """2x bilinear upsample -> conv3x3 halving channels, the reference's
    ``UnetUpscaleLayer`` under its names (``layer.1`` conv; ``layer.0``
    is the parameterless upsample)."""

    def __init__(self, cin: int):
        super().__init__()
        self.layer = nn.ModuleList([
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(cin, cin // 2, 3, padding=1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(upsample_bilinear(x, 2), self.layer[1], padding=1)


def center_crop(x: torch.Tensor, size) -> torch.Tensor:
    """Center-crop the spatial dims of an NHWC tensor to ``size``, an int
    (square) or an ``(out_h, out_w)`` pair (torchvision's rule). On row
    strips ``size`` is the strip's: rows equal to the strip's are the
    identity, others are cropped from the gathered map in global rows and
    split again."""
    out_h, out_w = (size, size) if isinstance(size, int) else size
    sp = mesh_lib.strip_mesh()
    if sp is not None and out_h != x.shape[1]:
        n = sp.shape[mesh_lib.SPATIAL_AXIS]
        whole = halo.gather_rows(x, sp, f"center crop of {x.shape[1] * n} "
                                 "rows", "a crop in global rows")
        with mesh_lib.whole_rows():
            y = center_crop(whole, (out_h * n, out_w))
        return halo.split_rows(y, sp)
    top = (x.shape[1] - out_h) // 2
    left = (x.shape[2] - out_w) // 2
    return x[:, top:top + out_h, left:left + out_w, :]


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init with the JAX models' scheme: lecun-normal
    kernels (std sqrt(1/fan_in)), zero biases, LN/BN at identity. Draws
    come from a CPU ``torch.Generator`` so a seed gives the same weights
    on every device."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen)
                    * math.sqrt(1.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
