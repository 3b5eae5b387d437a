"""``python -m cvcs_tpu_torch.cli.esa <config.yaml>`` — a trained net on
arbitrary-size external imagery, with no ground truth (port of
``cvcs_tpu/cli/esa.py``; the reference's example is an ESA raster at
patch 512): the raster's whole tiles are segmented by the window engine
and written as one stitched color map.

Config keys (``config.loader.ESA_KEYS``): ``image`` (one path or a list),
``net``, ``load_checkpoint``, ``ensemble_config``, ``patch_size``
(default 512), ``border_correction``, ``batch_tiles``, ``tta``,
``out_image`` (default ``output_esa.png``; with several images
``<stem>_<i><suffix>``), ``output`` (a directory for per-patch PNGs),
``num_classes``, ``precision``, ``in_channels`` and ``device``. ``mesh``
is not ported yet and raises.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import ESA_KEYS, validate_keys
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter


def run(config: dict) -> None:
    from PIL import Image

    validate_keys(config, ESA_KEYS, {"image", "net"}, "esa")
    common.reject_unported(config)
    device = common.device_context(config)
    Image.MAX_IMAGE_PIXELS = None
    paths = config["image"]
    if not isinstance(paths, (list, tuple)):
        paths = [paths]
    rasters = [np.asarray(Image.open(f).convert("RGB")) for f in paths]
    p = int(config.get("patch_size", 512))

    model, spec, num_classes = common.build_apply(config, device)
    seg = SceneSegmenter(
        model,
        InferenceConfig(
            patch_size=p,
            border_correction=config.get("border_correction"),
            batch_tiles=int(config.get("batch_tiles", 128)),
            num_classes=num_classes,
            tta=bool(config.get("tta"))),
        returns_logits=spec.returns_logits,
        requires_context=spec.requires_context,
        stride_product=spec.stride_product, device=device)

    out_image = config.get("out_image", "output_esa.png")

    def out_path(i: int) -> str:
        if len(rasters) == 1:
            return out_image
        stem = Path(out_image)
        return str(stem.with_name(f"{stem.stem}_{i}{stem.suffix}"))

    per_scene = common.fetch_labels(common.segment_rasters(seg, rasters))
    for i, labels in enumerate(per_scene):
        if config.get("output"):
            out_dir = (config["output"] if len(per_scene) == 1
                       else str(Path(config["output"]) / str(i)))
            seg.export_patches(labels, out_dir)
        seg.export_map(labels, out_path(i))
        print(f"Wrote {out_path(i)}", flush=True)


def main(argv=None) -> int:
    run(common.resolve_config_arg(argv or sys.argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
