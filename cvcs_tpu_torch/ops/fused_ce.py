"""Fused weighted softmax cross-entropy, forward and backward as CUDA
kernels (port of ``cvcs_tpu/ops/pallas_ce.py``).

Replaces the Pallas TPU kernels launched by ``_grid_call``
(``pallas_ce.py:134``):

* K3, the forward sums ``_ce_fwd_kernel``: sum of w[label] * (lse -
  logit[label]) and sum of w[label] over all pixels, the loss their ratio;
* K4, the backward ``_ce_bwd_kernel``: (softmax - onehot) * w[label] * g /
  max(sum w, 1e-12).

Both are in ``csrc/fused_ce.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and bound with ctypes (see :mod:`._build`). The
source says how they read the NHWC logits in place, how the forward sums
in a fixed order without atomics, what bounds them (memory), and K4's
design for Hopper (a group of lanes per pixel, labels read ahead, a grid
sized from the SM count). A K3 op call issues two CUDA kernels
(``ce_fwd_partials``, ``ce_fwd_finish``), a K4 op call one
(``ce_bwd_groups``).

Semantics are ``losses.cross_entropy``'s (torch ``nn.CrossEntropyLoss``
with class weights and ``ignore_index``): a label outside [0, C) has
weight 0, as has ``ignore_index`` when it lies in [0, C); the weights get
no gradient. :class:`FusedCrossEntropyFn` is the autograd op, its forward
K3 and its backward K4 on a CUDA tensor; on a CPU tensor it runs the plain
versions :func:`ce_sums_plain` and :func:`ce_grad_plain`.
:func:`build_fused_ce` is the drop-in loss for a train step or a
``Trainer``. ``launches`` counts K3 launches, ``bwd_launches`` K4
launches.

Under :func:`cvcs_tpu_torch.core.mesh.data_parallel` the forward sums
K3's two sums over the data group before their ratio (the loss of the
global batch), and K4 divides by the global sum w, so each rank gets the
gradient of the global loss for its own logits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.core.device import resolve_device

KERNEL = dict(
    name="fused_ce_fwd",
    route="cuda",
    source="cvcs_tpu_torch/csrc/fused_ce.cu",
    replaces="cvcs_tpu/ops/pallas_ce.py:134",
)
BWD_KERNEL = dict(
    name="fused_ce_bwd",
    route="cuda",
    source="cvcs_tpu_torch/csrc/fused_ce.cu",
    replaces="cvcs_tpu/ops/pallas_ce.py:134",
)

MAX_CLASSES = 32     # the kernels hold a pixel's row in registers

launches = 0         # K3 launches since the caller last reset it
bwd_launches = 0     # K4 launches since the caller last reset it


def _label_weights(labels, weights):
    """w[label] per pixel, 0 for a label outside [0, C)."""
    c = weights.shape[0]
    lab = labels.to(torch.int64)
    valid = (lab >= 0) & (lab < c)
    return torch.where(valid, weights[lab.clamp(0, c - 1)], 0.0), lab, valid


def ce_sums_plain(logits, labels, weights):
    """Plain torch twin of K3 on (N, C) logits, (N,) labels and the
    effective (C,) weights: (sum of w[label] * ce, sum of w[label]), f32."""
    x = logits.to(torch.float32)
    w, lab, valid = _label_weights(labels, weights)
    m = x.max(-1).values
    lse = torch.log(torch.exp(x - m[:, None]).sum(-1)) + m
    picked = x.gather(1, lab.clamp(0, x.shape[1] - 1)[:, None])[:, 0]
    true = torch.where(valid, picked, 0.0)
    return ((lse - true) * w).sum(), w.sum()


def ce_grad_plain(logits, labels, weights, scale):
    """Plain torch twin of K4: (softmax - onehot) * w[label] * scale, in
    the logits' dtype (``scale`` = g / max(sum w, 1e-12), a 0-d tensor)."""
    x = logits.to(torch.float32)
    w, lab, _ = _label_weights(labels, weights)
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    probs = e / e.sum(-1, keepdim=True)
    onehot = (lab[:, None] == torch.arange(x.shape[1], device=x.device))
    return ((probs - onehot.to(torch.float32))
            * (w * scale)[:, None]).to(logits.dtype)


@functools.cache
def _kernels():
    """The C entry points of ``csrc/fused_ce.cu`` (K3, K4, K3's workspace
    size), built at first use."""
    from cvcs_tpu_torch.ops import _build

    lib = _build.load("fused_ce")
    fwd = lib.cvcs_ce_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 7
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    bwd = lib.cvcs_ce_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_void_p] * 6
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    ws = lib.cvcs_ce_workspace
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_longlong]
    return fwd, bwd, ws


def _fwd_launch(logits, labels, weights):
    """Launch K3; returns 0-d f32 device tensors (loss_sum, wsum, loss)."""
    global launches
    fwd, _, ws_bytes = _kernels()
    n, c = logits.shape
    dev = logits.device
    sums = [torch.empty((), dtype=torch.float32, device=dev) for _ in range(3)]
    ws = torch.empty(ws_bytes(n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
                 ws.data_ptr(), *[s.data_ptr() for s in sums], n, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ce forward kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return tuple(sums)


def _bwd_launch(logits, labels, weights, g, wsum):
    """Launch K4; returns (N, C) f32 dlogits. The autograd backward calls
    it once a step, so it converts ``g`` and switches the current device
    only where it has to."""
    global bwd_launches
    _, bwd, _ = _kernels()
    n, c = logits.shape
    dev = logits.device
    if g.dtype != torch.float32:
        g = g.to(torch.float32)
    dlogits = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0:
        return dlogits
    args = (logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
            g.data_ptr(), wsum.data_ptr(), dlogits.data_ptr(), n, c)
    if dev.index == torch.cuda.current_device():
        rc = bwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = bwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ce backward kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dlogits


def _on_card(x) -> bool:
    """The no-fallback rule: a CPU tensor runs the plain versions, a CUDA
    tensor the kernels, anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_ce kernel for device {x.device}")
    return x.device.type == "cuda"


class FusedCrossEntropyFn(torch.autograd.Function):
    """K3 forward and K4 backward as one autograd op on (N, C) f32 logits,
    (N,) int32 labels and the effective (C,) f32 weights. Saves the
    logits, labels, weights and the device scalar sum w for the
    backward; the weights get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, weights):
        if _on_card(logits):
            loss_sum, wsum, loss = _fwd_launch(logits, labels, weights)
        else:
            loss_sum, wsum = ce_sums_plain(logits, labels, weights)
            loss = loss_sum / torch.clamp(wsum, min=1e-12)
        dp = mesh_lib.active_data_mesh()
        if dp is not None:
            # the global batch's sums, before their ratio; K4 then scales
            # this rank's gradient by the global sum w
            sums = mesh_lib.all_reduce_sum(torch.stack([loss_sum, wsum]),
                                           dp.data_group)
            wsum = sums[1].clone()
            loss = sums[0] / torch.clamp(wsum, min=1e-12)
        ctx.save_for_backward(logits, labels, weights, wsum)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, labels, weights, wsum = ctx.saved_tensors
        if _on_card(logits):
            dlogits = _bwd_launch(logits, labels, weights, g, wsum)
        else:
            dlogits = ce_grad_plain(logits, labels, weights,
                                    g / torch.clamp(wsum, min=1e-12))
        return dlogits, None, None


def effective_weights(weights, num_classes: int, ignore_index=None,
                      device=None) -> torch.Tensor:
    """(C,) f32 class weights (ones when ``weights`` is None) on
    ``device``, with ``ignore_index`` zeroed when it lies in [0, C)."""
    w = (torch.ones(num_classes, dtype=torch.float32, device=device)
         if weights is None else
         torch.as_tensor(weights, dtype=torch.float32, device=device).clone())
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        w[ignore_index] = 0.0
    return w


def _fused_ce(logits, labels, w):
    """Check, flatten to (N, C) / (N,) int32, and run the autograd op with
    the effective weights ``w``."""
    if logits.dim() < 1 or not logits.is_floating_point():
        raise ValueError(f"logits must be (..., C) floating point, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    c = logits.shape[-1]
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"fused_ce takes 1..{MAX_CLASSES} classes, got {c}")
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"labels must be {tuple(logits.shape[:-1])}, got "
                         f"{tuple(labels.shape)}")
    if labels.is_floating_point():
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    if tuple(w.shape) != (c,):
        raise ValueError(f"weights must be ({c},), got {tuple(w.shape)}")
    for name, a in (("labels", labels), ("weights", w)):
        if a.device != logits.device:
            raise ValueError(f"{name} is on {a.device}, logits on "
                             f"{logits.device}")
    x = logits.to(torch.float32).contiguous().reshape(-1, c)
    lab = labels.to(torch.int32).contiguous().reshape(-1)
    return FusedCrossEntropyFn.apply(x, lab, w)


def fused_cross_entropy(logits, labels, weights=None, ignore_index=None):
    """Weighted mean softmax cross-entropy of (..., C) logits against
    integer labels, the fused kernels' way (a CUDA tensor launches them or
    raises; a CPU tensor runs the plain versions). Returns a 0-d f32
    tensor on the logits' device; the backward returns dlogits in the
    logits' dtype."""
    c = logits.shape[-1]
    return _fused_ce(logits, labels,
                     effective_weights(weights, c, ignore_index,
                                       logits.device))


def build_fused_ce(weights=None, ignore_background: bool = False,
                   device=None):
    """Drop-in replacement for ``losses.build_loss("CEL" / "wCEL")``
    through the fused kernels: ``fn(logits, labels) -> loss``. Class 0 is
    ignored under ``ignore_background``. ``weights`` (C,) are placed once
    on ``device``, the card unless the CPU is asked for."""
    ignore_index = 0 if ignore_background else None
    if weights is None:
        return lambda logits, labels: fused_cross_entropy(
            logits, labels, None, ignore_index)
    w = effective_weights(weights, len(weights), ignore_index,
                          resolve_device(device))
    return lambda logits, labels: _fused_ce(logits, labels, w)
