"""Carry JAX SwinUNet variables into the port.

:func:`swin_state_dict` turns the JAX parameter tree plus ``batch_stats``
(nested dicts of numpy arrays, flax module names) into the port's
``state_dict`` under the torch twin's names — the same names and values
that ``cvcs_tpu.utils.torch_export.export_swin`` writes, so either source
loads with ``strict=True``:

* conv kernels HWIO -> OIHW;
* Dense kernels transposed ((in, out) -> (out, in));
* flax ConvTranspose kernels transposed (kh, kw, in, out) ->
  (in, out, kh, kw) AND spatially flipped (flax does not flip);
* BatchNorm running mean / var from ``batch_stats``.

``.npz`` checkpoints hold the JAX variables flattened to '/'-joined paths
(``params/Conv_0/kernel``, ``batch_stats/DecodeBlock_0/BatchNorm_0/mean``);
:func:`unflatten_npz` rebuilds the tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _node(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def swin_state_dict(variables: dict, depths=(2, 2, 6, 2)) -> dict:
    """JAX SwinUNet ``{"params", "batch_stats"}`` -> port state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    def conv(path, name):
        leaf = _node(params, path)
        sd[f"{name}.weight"] = _f32(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in leaf:
            sd[f"{name}.bias"] = _f32(leaf["bias"])

    def convt(path, name):
        leaf = _node(params, path)
        k = np.asarray(leaf["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"{name}.weight"] = _f32(k)
        sd[f"{name}.bias"] = _f32(leaf["bias"])

    def dense(path, name):
        leaf = _node(params, path)
        sd[f"{name}.weight"] = _f32(np.asarray(leaf["kernel"]).T)
        sd[f"{name}.bias"] = _f32(leaf["bias"])

    def ln(path, name):
        leaf = _node(params, path)
        sd[f"{name}.weight"] = _f32(leaf["scale"])
        sd[f"{name}.bias"] = _f32(leaf["bias"])

    def bn(path, name):
        ln(path, name)
        st = _node(stats, path)
        sd[f"{name}.running_mean"] = _f32(st["mean"])
        sd[f"{name}.running_var"] = _f32(st["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    conv(("Conv_0",), "patch_embed.proj")
    ln(("LayerNorm_0",), "patch_embed.norm")
    blk_idx = 0
    for s in range(4):
        if s > 0:
            conv((f"Conv_{s}",), f"layers.{s}.downsample.proj")
            ln((f"LayerNorm_{s}",), f"layers.{s}.downsample.norm")
        for d in range(depths[s]):
            base = f"layers.{s}.blocks.{d}"
            blk = (f"SwinBlock_{blk_idx}",)
            ln(blk + ("LayerNorm_0",), f"{base}.norm1")
            att = blk + ("WindowAttention_0",)
            dense(att + ("Dense_0",), f"{base}.attn.qkv")
            dense(att + ("Dense_1",), f"{base}.attn.proj")
            ln(blk + ("LayerNorm_1",), f"{base}.norm2")
            dense(blk + ("Dense_0",), f"{base}.mlp.fc1")
            dense(blk + ("Dense_1",), f"{base}.mlp.fc2")
            blk_idx += 1
    for i in range(3):
        convt((f"ConvTranspose_{i}",), f"decoder.{i}.up")
        dec = (f"DecodeBlock_{i}",)
        conv(dec + ("Conv_0",), f"decoder.{i}.conv1")
        bn(dec + ("BatchNorm_0",), f"decoder.{i}.bn1")
        conv(dec + ("Conv_1",), f"decoder.{i}.conv2")
        bn(dec + ("BatchNorm_1",), f"decoder.{i}.bn2")
    convt(("ConvTranspose_3",), "head.up1")
    convt(("ConvTranspose_4",), "head.up2")
    conv(("Conv_4",), "head.out")
    return sd


def load_jax_variables(model, variables: dict):
    """Load JAX SwinUNet variables into a port ``SwinUNet`` (strict)."""
    model.load_state_dict(swin_state_dict(variables, model.depths),
                          strict=True)
    return model


def flatten_variables(variables: dict) -> dict:
    """JAX variables tree -> {'/'-joined path: numpy array} (the ``.npz``
    checkpoint layout)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = np.asarray(node)

    walk(variables, "")
    return flat


def unflatten_npz(arrays) -> dict:
    """Inverse of :func:`flatten_variables`."""
    tree: dict = {}
    for key in arrays.keys():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arrays[key])
    return tree
