"""Model registry (port of ``cvcs_tpu/models/registry.py``): config names
-> model constructors, with the typed model protocol. Every name of the
JAX registry is ported: the Swin, UNet, DeepLab and SegFormer families.
"Ensemble" is assembled from member checkpoints by
``cli/common.py`` ``build_ensemble``, not built here."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from cvcs_tpu_torch.core.device import resolve_device
from cvcs_tpu_torch.models.blocks import init_weights
from cvcs_tpu_torch.models.deeplab import DeepLabV3
from cvcs_tpu_torch.models.segformer import MIT_B0, MIT_B1, MIT_B3, SegFormer
from cvcs_tpu_torch.models.swin import SwinUNet
from cvcs_tpu_torch.models.unet import unet, unet_v2


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., torch.nn.Module]
    requires_context: bool = False
    returns_logits: bool = True
    # reference checkpoints of this net were saved through a wrapper whose
    # keys carry a "module."/"model." prefix (metadata: the importer,
    # utils/torch_import.py, rewrites them by net name, as the JAX
    # package's does)
    wrapper: bool = False
    # full-convolution divisibility: input H/W must be multiples of this
    # for the forward to return an input-aligned label map
    stride_product: int = 1


MODEL_REGISTRY: dict[str, ModelSpec] = {
    "SwinUnet": ModelSpec(
        "SwinUnet",
        lambda num_classes, **kw: SwinUNet(num_classes=num_classes, **kw),
        stride_product=32),
    "SwinUnetTiny": ModelSpec(
        "SwinUnetTiny",
        lambda num_classes, **kw: SwinUNet(
            num_classes=num_classes, dims=(32, 64, 128, 256),
            depths=(1, 1, 2, 1), heads=(1, 2, 4, 8), **kw),
        stride_product=32),
    "Unet": ModelSpec(
        "Unet", lambda num_classes, **kw: unet(num_classes, **kw),
        stride_product=16),
    "Unetv2": ModelSpec(
        "Unetv2", lambda num_classes, **kw: unet_v2(num_classes, **kw),
        stride_product=16),
    "Unetv2S2D": ModelSpec(
        "Unetv2S2D",
        lambda num_classes, **kw: unet_v2(num_classes, stem="s2d", **kw),
        stride_product=32),
    "Resnet101": ModelSpec(
        "Resnet101",
        lambda num_classes, **kw: DeepLabV3(num_classes, "resnet101", **kw),
        wrapper=True),
    "Resnet50": ModelSpec(
        "Resnet50",
        lambda num_classes, **kw: DeepLabV3(num_classes, "resnet50", **kw),
        wrapper=True),
    "MobileNet": ModelSpec(
        "MobileNet",
        lambda num_classes, **kw: DeepLabV3(num_classes, "mobilenet", **kw),
        wrapper=True),
    "MobileNetGoogle": ModelSpec(
        "MobileNetGoogle",
        lambda num_classes, **kw: DeepLabV3(num_classes, "googlenet", **kw),
        wrapper=True),
    "MobileNetResnet18": ModelSpec(
        "MobileNetResnet18",
        lambda num_classes, **kw: DeepLabV3(num_classes, "resnet18", **kw),
        wrapper=True),
    "SegformerMod": ModelSpec(
        "SegformerMod",
        lambda num_classes, **kw: SegFormer(num_classes, MIT_B3, **kw),
        wrapper=True, stride_product=4),
    "SegformerB0": ModelSpec(
        "SegformerB0",
        lambda num_classes, **kw: SegFormer(num_classes, MIT_B0, **kw),
        wrapper=True, stride_product=4),
    "SegformerB1": ModelSpec(
        "SegformerB1",
        lambda num_classes, **kw: SegFormer(num_classes, MIT_B1, **kw),
        wrapper=True, stride_product=4),
}


def build_model(name: str, num_classes: int, *, device=None, seed: int = 0,
                **kw: Any) -> tuple[torch.nn.Module, ModelSpec]:
    """Build a zoo model by config name, seeded-initialised, in eval mode,
    on ``device`` (the card unless the CPU is asked for). Like the JAX
    registry, ``num_classes`` counts the background class."""
    if name == "Ensemble":
        raise ValueError(
            "Ensemble is assembled from member checkpoints; use "
            "cvcs_tpu_torch.cli.common.build_ensemble (net: Ensemble with "
            "ensemble_config in an evaluate, predict or serve config)")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown net {name!r}; available: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[name]
    model = init_weights(spec.build(num_classes, **kw), seed)
    return model.to(dev).eval(), spec
