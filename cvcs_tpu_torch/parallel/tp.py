"""Tensor parallelism: channel-sharded compute for the largest backbones
(port of ``cvcs_tpu/parallel/tp.py``).

The JAX package places every large conv/dense kernel with its output
channels split over a mesh axis and pins the bottleneck activations
channel-sharded (``constrain``), and XLA's SPMD partitioner inserts the
collectives. The port has no partitioner, so the rule is written out,
one process per rank of the axis (the mesh's ``spatial`` group by
default, as in JAX):

* :func:`channel_shardings` names, for every conv, transposed conv or
  linear holder, the weight's output-channel dimension when it has at
  least ``min_channels`` output channels that split over the axis (None:
  replicated), JAX's rule on the same kernels;
* :func:`shard_params` leaves each rank only its slice of those output
  channels (weight and bias), so the per-rank bytes of a sharded kernel
  are 1 / n of the whole; run it on the carried weights
  (``weights.load_jax_variables``) after they are loaded;
* under :func:`tensor_parallel` a sharded holder computes its slice of
  output channels. Per-channel ops run on the slice (BatchNorm takes the
  slice of its parameters, :func:`channel_slice`; activations, pools and
  resizes are per channel; a depthwise conv takes the slice of its input,
  :func:`conv_input`). A consumer that needs every input channel (a
  dense conv or linear, a LayerNorm, a concatenation or a residual
  sum with a whole map) all-gathers them first (:func:`full_channels`).
  A channel-sharded map is told from a whole one by its width: it holds
  1 / n of the channels its consumer's weight takes;
* :func:`constrain` is the models' hook at the JAX sites (UNet's
  bottleneck, ResNet's stage 4, SegFormer's stage 4): under
  :func:`tensor_parallel` it keeps the rank's channels of a whole map
  that is at least ``min_channels`` wide.

This is the forward only, as in JAX, which trains nothing under it: the
gathers carry no gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from cvcs_tpu_torch.core.mesh import DATA_AXIS, Mesh, all_gather_cat

_HOLDERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@dataclasses.dataclass(frozen=True)
class _Axis:
    ranks: int
    index: int
    group: object
    min_channels: int


_state: _Axis | None = None


def _axis(mesh: Mesh, axis: str, min_channels: int) -> _Axis:
    if axis == DATA_AXIS:
        return _Axis(mesh.shape[axis], mesh.data_index, mesh.data_group,
                     min_channels)
    return _Axis(mesh.shape[axis], mesh.spatial_index, mesh.spatial_group,
                 min_channels)


def _out_dim(holder: nn.Module) -> int:
    """The weight dimension of a holder's output channels."""
    return 1 if isinstance(holder, nn.ConvTranspose2d) else 0


def channel_shardings(model: nn.Module, mesh: Mesh, axis: str = "spatial",
                      min_channels: int = 512) -> dict:
    """``{weight name: output-channel dimension}`` for the kernels sharded
    over ``axis`` (at least ``min_channels`` output channels, a multiple
    of the axis size), ``None`` for every other parameter."""
    n = mesh.shape[axis]
    rule = {}
    for prefix, holder in model.named_modules():
        if isinstance(holder, _HOLDERS):
            dim = _out_dim(holder)
            out = holder.weight.shape[dim]
            rule[f"{prefix}.weight"] = (
                dim if out >= min_channels and out % n == 0 else None)
    return {name: rule.get(name) for name, _ in model.named_parameters()}


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, axis: str = "spatial",
                 min_channels: int = 512) -> nn.Module:
    """Keep on this rank only its slice of output channels of every
    kernel :func:`channel_shardings` shards (and of its bias), in place;
    a depthwise conv keeps as many groups as it keeps channels. Returns
    ``model``."""
    ax = _axis(mesh, axis, min_channels)
    rule = channel_shardings(model, mesh, axis, min_channels)
    for prefix, holder in model.named_modules():
        dim = rule.get(f"{prefix}.weight") if isinstance(holder, _HOLDERS) \
            else None
        if dim is None:
            continue
        w = holder.weight
        c = w.shape[dim] // ax.ranks
        lo = ax.index * c
        holder.weight = nn.Parameter(w.narrow(dim, lo, c).clone(),
                                     requires_grad=w.requires_grad)
        if holder.bias is not None:
            holder.bias = nn.Parameter(holder.bias[lo:lo + c].clone(),
                                       requires_grad=holder.bias.requires_grad)
        if isinstance(holder, nn.Conv2d):
            if holder.groups > 1 and holder.groups == holder.out_channels:
                holder.groups = c
                holder.in_channels = c
            holder.out_channels = c
        elif isinstance(holder, nn.ConvTranspose2d):
            holder.out_channels = c
        else:
            holder.out_features = c
    return model


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh, axis: str = "spatial",
                    min_channels: int = 512):
    """Within the block, the models compute on the channel slices that
    :func:`shard_params` left over ``axis`` (same mesh, axis and
    ``min_channels``)."""
    global _state
    prev = _state
    _state = _axis(mesh, axis, min_channels)
    try:
        yield
    finally:
        _state = prev


def _gather(x: torch.Tensor) -> torch.Tensor:
    return all_gather_cat(x.detach(), _state.group, dim=x.dim() - 1)


def full_channels(x: torch.Tensor, channels: int) -> torch.Tensor:
    """``x`` with all ``channels`` channels: gathered over the axis when it
    holds this rank's slice of them, else as it is."""
    if _state is None or x.shape[-1] == channels:
        return x
    if x.shape[-1] * _state.ranks == channels:
        return _gather(x)
    return x


def _own(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1] // _state.ranks
    return x.narrow(-1, _state.index * c, c)


def conv_input(x: torch.Tensor, conv: nn.Module):
    """(input, weight, groups) of a conv holder: a dense consumer of a
    channel-sharded map gets the gathered map; a depthwise conv cut by
    :func:`shard_params` gets the rank's channels of a whole map."""
    w, groups = conv.weight, getattr(conv, "groups", 1)
    if _state is None:
        return x, w, groups
    cin = (w.shape[0] if isinstance(conv, nn.ConvTranspose2d)
           else w.shape[1] * groups)
    c = x.shape[-1]
    if c * _state.ranks == cin:
        return _gather(x), w, groups
    if groups > 1 and c == cin * _state.ranks:
        return _own(x), w, groups
    return x, w, groups


def channel_slice(x: torch.Tensor, params):
    """``params`` (per-channel tensors of a whole map's width), cut to the
    rank's slice when ``x`` holds only this rank's channels."""
    if _state is None or x.shape[-1] == params[0].shape[0]:
        return params
    c = x.shape[-1]
    lo = _state.index * c
    return tuple(p[lo:lo + c] for p in params)


def constrain(x: torch.Tensor, channels: int) -> torch.Tensor:
    """The models' TP hook: under :func:`tensor_parallel`, the rank's
    channels of a whole map of ``channels`` channels (at least
    ``min_channels``, a multiple of the axis size); a map already sharded,
    and any map outside the context, as it is."""
    ax = _state
    if (ax is None or channels < ax.min_channels or channels % ax.ranks
            or x.shape[-1] != channels):
        return x
    return _own(x)
