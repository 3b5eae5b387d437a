"""Carry JAX SwinUNet, UNet and SegFormer variables into the port.

:func:`swin_state_dict`, :func:`unet_state_dict` and
:func:`segformer_state_dict` turn the JAX parameter tree plus
``batch_stats`` (nested dicts of numpy arrays, flax module names) into the
port's ``state_dict`` under the torch names — the same names and values
that ``cvcs_tpu.utils.torch_export.export_swin``, ``export_unet`` and
``export_segformer`` write, so either source loads with ``strict=True``:

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


class _Writer:
    """flax variable paths -> torch state-dict keys."""

    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    def conv(self, path, name):
        leaf = _node(self.params, path)
        self.sd[f"{name}.weight"] = _f32(
            np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in leaf:
            self.sd[f"{name}.bias"] = _f32(leaf["bias"])

    def convt(self, path, name):
        leaf = _node(self.params, path)
        k = np.asarray(leaf["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        self.sd[f"{name}.weight"] = _f32(k)
        self.sd[f"{name}.bias"] = _f32(leaf["bias"])

    def dense(self, path, name):
        leaf = _node(self.params, path)
        self.sd[f"{name}.weight"] = _f32(np.asarray(leaf["kernel"]).T)
        self.sd[f"{name}.bias"] = _f32(leaf["bias"])

    def ln(self, path, name):
        leaf = _node(self.params, path)
        self.sd[f"{name}.weight"] = _f32(leaf["scale"])
        self.sd[f"{name}.bias"] = _f32(leaf["bias"])

    def bn(self, path, name):
        self.ln(path, name)
        st = _node(self.stats, path)
        self.sd[f"{name}.running_mean"] = _f32(st["mean"])
        self.sd[f"{name}.running_var"] = _f32(st["var"])
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)


def swin_state_dict(variables: dict, depths=(2, 2, 6, 2)) -> dict:
    """JAX SwinUNet ``{"params", "batch_stats"}`` -> port state dict."""
    w = _Writer(variables)
    conv, convt, dense, ln, bn = w.conv, w.convt, w.dense, w.ln, w.bn
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
    return w.sd


def unet_state_dict(variables: dict, upsample: str = "transpose") -> dict:
    """JAX UNet ``{"params", "batch_stats"}`` -> port state dict under the
    reference's names, the names and values ``export_unet`` writes:
    ``upsample="transpose"`` for "Unetv2" (and "Unetv2S2D"),
    ``"bilinear"`` for "Unet"."""
    w = _Writer(variables)
    enc = ("_Encoder_0",)
    for level in range(5):
        # encode1 holds its convs at 0, 1; encode2..5 at 1, 2 (pool at 0)
        offs = (0, 1) if level == 0 else (1, 2)
        for j, off in enumerate(offs):
            cba = enc + (f"ConvBNAct_{2 * level + j}",)
            w.conv(cba + ("Conv_0",), f"encode{level + 1}.{off}.layer.0")
            w.bn(cba + ("BatchNorm_0",), f"encode{level + 1}.{off}.layer.1")
    for j in range(4):
        if upsample == "transpose":
            w.convt((f"ConvTranspose_{j}",), f"upscale{j + 1}.0")
        else:
            w.conv((f"UpscaleBlock_{j}", "Conv_0"),
                   f"upscale{j + 1}.0.layer.1")
        dec = f"decode_forward{j + 1}.0.layer"
        blk = (f"DecodeBlock_{j}",)
        w.conv(blk + ("Conv_0",), f"{dec}.0")
        w.bn(blk + ("BatchNorm_0",), f"{dec}.2")
        w.conv(blk + ("Conv_1",), f"{dec}.3")
        w.bn(blk + ("BatchNorm_1",), f"{dec}.5")
    w.conv(("Conv_0",), "decode_forward4.1")
    return w.sd


def segformer_state_dict(variables: dict, depths=(3, 4, 18, 3),
                         sr_ratios=(8, 4, 2, 1)) -> dict:
    """JAX SegFormer ``{"params", "batch_stats"}`` -> port state dict under
    Hugging Face's names plus the reference's ``seq`` tail, the names and
    values ``export_segformer`` writes."""
    w = _Writer(variables)
    enc = ("MiTEncoder_0",)
    blk_idx = 0
    for s in range(4):
        pe = f"segformer.encoder.patch_embeddings.{s}"
        w.conv(enc + (f"Conv_{s}",), f"{pe}.proj")
        w.ln(enc + (f"LayerNorm_{2 * s}",), f"{pe}.layer_norm")
        for d in range(depths[s]):
            base = f"segformer.encoder.block.{s}.{d}"
            blk = enc + (f"MiTBlock_{blk_idx}",)
            att = blk + ("EfficientAttention_0",)
            ffn = blk + ("MixFFN_0",)
            w.ln(blk + ("LayerNorm_0",), f"{base}.layer_norm_1")
            w.dense(att + ("Dense_0",), f"{base}.attention.self.query")
            if sr_ratios[s] > 1:
                w.conv(att + ("Conv_0",), f"{base}.attention.self.sr")
                w.ln(att + ("LayerNorm_0",),
                     f"{base}.attention.self.layer_norm")
            w.dense(att + ("Dense_1",), f"{base}.attention.self.key")
            w.dense(att + ("Dense_2",), f"{base}.attention.self.value")
            w.dense(att + ("Dense_3",), f"{base}.attention.output.dense")
            w.ln(blk + ("LayerNorm_1",), f"{base}.layer_norm_2")
            w.dense(ffn + ("Dense_0",), f"{base}.mlp.dense1")
            w.conv(ffn + ("Conv_0",), f"{base}.mlp.dwconv.dwconv")
            w.dense(ffn + ("Dense_1",), f"{base}.mlp.dense2")
            blk_idx += 1
        w.ln(enc + (f"LayerNorm_{2 * s + 1}",),
             f"segformer.encoder.layer_norm.{s}")
    head = ("SegFormerHead_0",)
    for s in range(4):
        w.dense(head + (f"Dense_{s}",), f"decode_head.linear_c.{s}.proj")
    w.conv(head + ("Conv_0",), "decode_head.linear_fuse")
    w.bn(head + ("BatchNorm_0",), "decode_head.batch_norm")
    w.conv(head + ("Conv_1",), "decode_head.classifier")
    w.convt(("ConvTranspose_0",), "seq.0")
    w.convt(("ConvTranspose_1",), "seq.2")
    w.conv(("Conv_0",), "seq.4")
    return w.sd


def load_jax_variables(model, variables: dict):
    """Load JAX variables into a port ``SwinUNet``, ``UNet`` or
    ``SegFormer`` (strict)."""
    from cvcs_tpu_torch.models.segformer import SegFormer
    from cvcs_tpu_torch.models.swin import SwinUNet
    from cvcs_tpu_torch.models.unet import UNet

    if isinstance(model, SwinUNet):
        sd = swin_state_dict(variables, model.depths)
    elif isinstance(model, SegFormer):
        sd = segformer_state_dict(variables, model.config.depths,
                                  model.config.sr_ratios)
    elif isinstance(model, UNet):
        sd = unet_state_dict(variables, model.upsample)
    else:
        raise TypeError(f"no JAX weight bridge for {type(model).__name__}")
    model.load_state_dict(sd, strict=True)
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
