"""Carry JAX SwinUNet, UNet, DeepLabV3, SegFormer and ViT variables into
the port, and load DINO checkpoints.

:func:`swin_state_dict`, :func:`unet_state_dict`,
:func:`deeplab_state_dict`, :func:`segformer_state_dict` and
:func:`vit_state_dict` turn the JAX parameter tree plus ``batch_stats``
(nested dicts of numpy arrays, flax module names) into the port's
``state_dict`` under the torch names — the same names and values that
``cvcs_tpu.utils.torch_export.export_swin``, ``export_unet``,
``export_deeplab``, ``export_segformer`` and ``export_vit`` write, so
either source loads with ``strict=True``:

* conv kernels HWIO -> OIHW (a depthwise (kh, kw, 1, C) -> (C, 1, kh,
  kw));
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

    def wbn(self, path, name):
        """A BatchNorm inside a JAX ``_BN`` wrapper (``BatchNorm_0``)."""
        self.bn(path + ("BatchNorm_0",), name)

    def has(self, path) -> bool:
        try:
            _node(self.params, path)
        except KeyError:
            return False
        return True


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


_RESNET_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                  "resnet18": (2, 2, 2, 2)}


def _resnet(w: _Writer, root: tuple, arch: str) -> None:
    """torchvision ``resnet*`` names under ``backbone.``."""
    w.conv(root + ("Conv_0",), "backbone.conv1")
    w.wbn(root + ("_BN_0",), "backbone.bn1")
    block, n_convs = (("BasicBlock", 2) if arch == "resnet18"
                      else ("Bottleneck", 3))
    idx = 0
    for stage, n_blocks in enumerate(_RESNET_STAGES[arch]):
        for b in range(n_blocks):
            base = f"backbone.layer{stage + 1}.{b}"
            path = root + (f"{block}_{idx}",)
            for c in range(n_convs):
                w.conv(path + (f"Conv_{c}",), f"{base}.conv{c + 1}")
                w.wbn(path + (f"_BN_{c}",), f"{base}.bn{c + 1}")
            if w.has(path + (f"Conv_{n_convs}",)):   # projection shortcut
                w.conv(path + (f"Conv_{n_convs}",), f"{base}.downsample.0")
                w.wbn(path + (f"_BN_{n_convs}",), f"{base}.downsample.1")
            idx += 1


def _mobilenet(w: _Writer, root: tuple) -> None:
    """torchvision MobileNetV3-Large ``features`` names under
    ``backbone.``."""
    from cvcs_tpu_torch.models.mobilenet import LARGE_DILATED

    w.conv(root + ("Conv_0",), "backbone.0.0")
    w.wbn(root + ("_BN_0",), "backbone.0.1")
    for i, cfg in enumerate(LARGE_DILATED):
        base = f"backbone.{i + 1}.block"
        path = root + (f"InvertedResidual_{i}",)
        k = c = 0        # the torch layer index, the flax Conv_/_BN_ index
        for _ in range(1 if i == 0 else 2):         # [expand,] depthwise
            w.conv(path + (f"Conv_{c}",), f"{base}.{k}.0")
            w.wbn(path + (f"_BN_{c}",), f"{base}.{k}.1")
            k, c = k + 1, c + 1
        if cfg.use_se:
            se = path + ("SqueezeExcite_0",)
            w.conv(se + ("Conv_0",), f"{base}.{k}.fc1")
            w.conv(se + ("Conv_1",), f"{base}.{k}.fc2")
            k += 1
        w.conv(path + (f"Conv_{c}",), f"{base}.{k}.0")
        w.wbn(path + (f"_BN_{c}",), f"{base}.{k}.1")
    w.conv(root + ("Conv_1",), "backbone.16.0")
    w.wbn(root + ("_BN_1",), "backbone.16.1")


_GOOGLENET_BLOCKS = ("inception3a", "inception3b", "inception4a",
                     "inception4b", "inception4c", "inception4d",
                     "inception4e")
_GOOGLENET_BRANCHES = ("branch1", "branch2.0", "branch2.1", "branch3.0",
                       "branch3.1", "branch4.1")


def _googlenet(w: _Writer, root: tuple) -> None:
    """torchvision ``googlenet`` names (``export_googlenet``'s) and the
    reference's ``out_layer``/``aux_layer``, under ``backbone.``."""

    def basic(path, name):
        w.conv(path + ("Conv_0",), f"backbone.{name}.conv")
        w.bn(path + ("BatchNorm_0",), f"backbone.{name}.bn")

    for i in range(3):
        basic(root + (f"BasicConv2d_{i}",), f"conv{i + 1}")
    for i, blk in enumerate(_GOOGLENET_BLOCKS):
        for j, branch in enumerate(_GOOGLENET_BRANCHES):
            basic(root + (f"Inception_{i}", f"BasicConv2d_{j}"),
                  f"{blk}.{branch}")
    w.conv(root + ("Conv_0",), "backbone.out_layer")
    w.conv(root + ("Conv_1",), "backbone.aux_layer")


def deeplab_state_dict(variables: dict, backbone: str = "resnet101") -> dict:
    """JAX DeepLabV3 ``{"params", "batch_stats"}`` -> port state dict under
    torchvision's ``deeplabv3_*`` names: for ``resnet101``, ``resnet50``
    and ``mobilenet`` the names and values ``export_deeplab`` writes; for
    ``googlenet`` the trunk under ``export_googlenet``'s names plus
    ``backbone.out_layer``/``backbone.aux_layer``; for ``resnet18`` the
    trunk under torchvision's ``resnet18`` names plus the adapter's
    ``backbone.upsample`` (the transposed conv), ``backbone.out_layer``
    and ``backbone.aux_layer``."""
    w = _Writer(variables)
    if backbone in ("resnet101", "resnet50"):
        _resnet(w, ("ResNet_0",), backbone)
    elif backbone == "mobilenet":
        _mobilenet(w, ("MobileNetV3Backbone_0",))
    elif backbone == "googlenet":
        _googlenet(w, ("GoogLeNetBackbone_0",))
    elif backbone == "resnet18":
        root = ("_ResNet18Adapter_0",)
        _resnet(w, root + ("ResNet_0",), "resnet18")
        w.convt(root + ("ConvTranspose_0",), "backbone.upsample")
        w.conv(root + ("Conv_0",), "backbone.out_layer")
        w.conv(root + ("Conv_1",), "backbone.aux_layer")
    else:
        raise ValueError(f"unknown DeepLab backbone {backbone!r}")
    head = ("DeepLabHead_0",)
    w.sd.update(aspp_state_dict(variables, head + ("ASPP_0",),
                                "classifier.0."))
    w.conv(head + ("Conv_0",), "classifier.1")
    w.wbn(head + ("_BN_0",), "classifier.2")
    w.conv(head + ("Conv_1",), "classifier.4")
    return w.sd


def aspp_state_dict(variables: dict, path: tuple = (),
                    prefix: str = "") -> dict:
    """The JAX ``ASPP`` at ``path`` of ``variables`` (the root: an ASPP
    alone) -> torchvision's ``ASPP`` names after ``prefix``."""
    w = _Writer(variables)
    for i in range(4):
        w.conv(path + (f"Conv_{i}",), f"{prefix}convs.{i}.0")
        w.wbn(path + (f"_BN_{i}",), f"{prefix}convs.{i}.1")
    w.conv(path + ("Conv_4",), f"{prefix}convs.4.1")
    w.wbn(path + ("_BN_4",), f"{prefix}convs.4.2")
    w.conv(path + ("Conv_5",), f"{prefix}project.0")
    w.wbn(path + ("_BN_5",), f"{prefix}project.1")
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


def vit_state_dict(variables: dict, depth: int = 12) -> dict:
    """JAX ViT ``{"params"}`` -> port state dict under DINO's names, the
    names and values ``export_vit`` writes."""
    w = _Writer(variables)
    w.sd["cls_token"] = _f32(w.params["cls_token"])
    w.sd["pos_embed"] = _f32(w.params["pos_embed"])
    w.conv(("Conv_0",), "patch_embed.proj")
    for i in range(depth):
        base, blk = f"blocks.{i}", (f"ViTBlock_{i}",)
        w.ln(blk + ("LayerNorm_0",), f"{base}.norm1")
        w.dense(blk + ("Dense_0",), f"{base}.attn.qkv")
        w.dense(blk + ("Dense_1",), f"{base}.attn.proj")
        w.ln(blk + ("LayerNorm_1",), f"{base}.norm2")
        w.dense(blk + ("Dense_2",), f"{base}.mlp.fc1")
        w.dense(blk + ("Dense_3",), f"{base}.mlp.fc2")
    w.ln(("LayerNorm_0",), "norm")
    return w.sd


def load_dino(model, path):
    """Load a DINO torch.hub checkpoint (a ``.pth`` state dict, or one
    wrapped under ``"state_dict"``) into a port ``ViT`` (strict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(sd, strict=True)
    return model


def jax_state_dict(model, variables: dict) -> dict:
    """JAX variables -> the state dict of a port ``SwinUNet``, ``UNet``,
    ``DeepLabV3``, ``SegFormer`` or ``ViT`` (the bridge for the model's
    class)."""
    from cvcs_tpu_torch.models.deeplab import DeepLabV3
    from cvcs_tpu_torch.models.segformer import SegFormer
    from cvcs_tpu_torch.models.swin import SwinUNet
    from cvcs_tpu_torch.models.unet import UNet
    from cvcs_tpu_torch.models.vit import ViT

    if isinstance(model, ViT):
        return vit_state_dict(variables, model.depth)
    if isinstance(model, SwinUNet):
        return swin_state_dict(variables, model.depths)
    if isinstance(model, SegFormer):
        return segformer_state_dict(variables, model.config.depths,
                                    model.config.sr_ratios)
    if isinstance(model, UNet):
        return unet_state_dict(variables, model.upsample)
    if isinstance(model, DeepLabV3):
        return deeplab_state_dict(variables, model.backbone_name)
    raise TypeError(f"no JAX weight bridge for {type(model).__name__}")


def load_jax_variables(model, variables: dict):
    """Load JAX variables into a port model (strict)."""
    model.load_state_dict(jax_state_dict(model, variables), strict=True)
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
