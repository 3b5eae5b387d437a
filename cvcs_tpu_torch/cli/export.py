"""``python -m cvcs_tpu_torch.cli.export <config.yaml>`` (port of
``cvcs_tpu/cli/export.py``): a checkpoint to a torch state-dict file in
the model family's native naming (the reference's ``nets.py`` for the
U-Nets, torchvision's for DeepLab, Hugging Face's for SegFormer, the
twin's for SwinUnet).

The port's models carry those names already, so the export is the
restored model's ``state_dict`` on the CPU: the keys, shapes and values
that ``cvcs_tpu.utils.torch_export.export_*`` writes for the same
weights. Torch is always present here, so the file is always a ``.pt``
(the JAX package's ``.npz`` fallback for a host without torch is not
carried over). Config keys (``config.loader.EXPORT_KEYS``)::

    net: Unetv2                    # one of EXPORTABLE
    load_checkpoint: ckpts/checkpoint50
    num_classes: 15
    output: unetv2_export.pt
    device: cpu                    # else the card

``patch_size`` is accepted and unused (the JAX package initialises its
model at that size before restoring).
"""

from __future__ import annotations

import sys

import torch

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import EXPORT_KEYS, validate_keys

# the nets with a torch exporter in the JAX package (its ``_EXPORTERS``)
EXPORTABLE = ("Unet", "Unetv2", "Resnet101", "Resnet50", "MobileNet",
              "SegformerMod", "SwinUnet", "SwinUnetTiny")


def export(config: dict) -> str:
    validate_keys(config, EXPORT_KEYS,
                  {"net", "load_checkpoint", "output"}, "export")
    net = config["net"]
    if net not in EXPORTABLE:
        raise ValueError(f"no torch exporter for net {net!r}; available: "
                         f"{sorted(EXPORTABLE)}")
    model, _, _ = common.build_net(config, common.device_context(config))
    common.restore_variables(config, model)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out = config["output"]
    torch.save(sd, out)
    print(f"Exported {net} ({len(sd)} tensors) -> {out}", flush=True)
    return out


def main(argv=None) -> int:
    export(common.resolve_config_arg(argv or sys.argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
