"""``python -m cvcs_tpu_torch.cli.predict <config.yaml>`` — whole-scene
sliding-window segmentation with border correction (port of
``cvcs_tpu/cli/predict.py``): per-patch color-mask PNGs or 3-panel
figures in ``output/`` and an optional stitched ``out_image``.

``net: Ensemble`` with ``ensemble_config`` segments with the members'
majority vote (``tta`` is refused for it: a vote has no logits).
``range: [lb, ub]`` selects global patch indices (scene = index //
tiles_per_scene); when a range covers at most a quarter of a scene and no
stitched map is asked for, only the selected tiles are computed.

Whole scenes take one of three paths: the window path by default;
``stream_rows: N`` runs it in bands of N tile rows (device memory
O(band)); ``fullconv_bands: N`` forwards each band of N tile rows as one
full convolution (no window overlap, no tile seams inside a band), and
with ``fullconv_chunks: [r, k]`` each band as a batch of r x k-tile
blocks of a scene kept on the device.

``mesh: {spatial: N}`` (a launch of N ranks, ``torchrun --nproc-per-node
N -m cvcs_tpu_torch.cli.predict cfg.yaml``) spreads each scene's tile
rows over the ranks with a halo exchange (``predict_scene_sharded``, or
``predict_scene_fullconv_sharded`` with ``fullconv_bands``); adding
``data: M`` runs groups of M scenes scene-parallel
(``predict_scenes_sharded``) and the remainder one by one. Under a mesh
the few-patch economy and ``stream_rows`` are not used, as in the JAX
package, and rank 0 alone writes the PNGs and figures.
"""

from __future__ import annotations

import sys
from pathlib import Path

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import INFER_KEYS, validate_keys
from cvcs_tpu_torch.core.mesh import DATA_AXIS
from cvcs_tpu_torch.data.geometry import TileGrid
from cvcs_tpu_torch.data.reader import SceneDataset
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter


def predict(config: dict) -> None:
    validate_keys(config, INFER_KEYS,
                  {"dataset", "net", "patch_size"}, "inference")
    device = common.device_context(config)
    mesh = common.mesh_from_config(config, device)
    if mesh is not None:
        device = mesh.device
    lead = common.is_lead(mesh)
    p = int(config["patch_size"])
    dataset = SceneDataset(config["dataset"])
    grid = TileGrid(dataset.image_shape, p)
    tpi = grid.tiles_per_image

    model, spec, num_classes = common.build_apply(config, device)
    infer_cfg = InferenceConfig(
        patch_size=p,
        border_correction=config.get("border_correction"),
        batch_tiles=int(config.get("batch_tiles", 128)),
        num_classes=num_classes,
        bug_parity=bool(config.get("bug_parity")),
        mask_only=bool(config.get("mask_only", False)),
        tta=bool(config.get("tta")))
    seg = SceneSegmenter(model, infer_cfg, returns_logits=spec.returns_logits,
                         requires_context=spec.requires_context,
                         stride_product=spec.stride_product, device=device)

    if config.get("range"):
        lb, ub = config["range"]
    else:
        lb, ub = 0, len(dataset) * tpi
    scenes = list(range(lb // tpi, -(-ub // tpi))) if ub > lb else []
    out_dir = Path(config.get("output", "output"))

    # scene-parallel groups: with a data axis, full groups of n_data
    # scenes run as one sharded pass; the rest fall through to the
    # per-scene spatial path
    scene_groups: dict[int, list[int]] = {}
    pending_group: dict[int, tuple] = {}
    if (mesh is not None and not config.get("fullconv_bands")
            and not config.get("stream_rows")):
        n_data = mesh.shape[DATA_AXIS]
        if n_data > 1:
            full = len(scenes) - len(scenes) % n_data
            for i in range(0, full, n_data):
                scene_groups[scenes[i]] = scenes[i:i + n_data]

    def load_gt(s, h, w):
        """Index mask for 3-panel figures, when annotations exist."""
        try:
            return dataset.load_index_mask(s)[:h, :w]
        except FileNotFoundError:
            return None

    for s in scenes:
        sel = [i - s * tpi for i in range(max(lb, s * tpi),
                                          min(ub, (s + 1) * tpi))]
        if mesh is not None:
            if s in scene_groups:
                group = scene_groups[s]
                raws = [dataset.load_image(g) for g in group]
                stack = seg.predict_scenes_sharded(raws, mesh)
                for j, g in enumerate(group):
                    pending_group[g] = (stack[j], raws[j])
            if s in pending_group:
                labels, raw = pending_group.pop(s)
            else:
                raw = dataset.load_image(s)
                labels = sharded_scene_labels(seg, raw, config, mesh)
            if lead:
                export(seg, labels, raw, s, scenes, config, lb, ub,
                       load_gt)
                print(f"Scene {s}: {tpi} patches -> {out_dir}", flush=True)
            continue
        raw = dataset.load_image(s)
        if len(sel) * 4 <= tpi and not config.get("out_image"):
            # few-patch economics: forward only the selected patches
            tiles = seg.predict_tiles(raw, sel)
            global_ids = [s * tpi + t for t in sel]
            if infer_cfg.mask_only:
                seg.export_tile_patches(tiles, global_ids, out_dir)
            else:
                gt = load_gt(s, grid.rows * p, grid.cols * p)
                seg.export_tile_figures(tiles, global_ids, sel, raw,
                                        grid.cols, out_dir, gt_mask=gt)
            print(f"Scene {s}: {len(sel)} patches -> {out_dir}", flush=True)
            continue

        labels = scene_labels(seg, raw, config)
        export(seg, labels, raw, s, scenes, config, lb, ub, load_gt)
        print(f"Scene {s}: {tpi} patches -> {out_dir}", flush=True)


def export(seg: SceneSegmenter, labels, raw, s: int, scenes: list,
           config: dict, lb: int, ub: int, load_gt) -> None:
    """Scene ``s``'s per-patch PNGs (or 3-panel figures) of the global
    indices in [lb, ub), and its stitched map when ``out_image`` asks."""
    p = seg.cfg.patch_size
    out_dir = Path(config.get("output", "output"))
    tpi = (labels.shape[0] // p) * (labels.shape[1] // p)
    if seg.cfg.mask_only:
        seg.export_patches(labels, out_dir, start_index=s * tpi,
                           keep=range(lb, ub))
    else:
        gt = load_gt(s, labels.shape[0], labels.shape[1])
        seg.export_figures(labels, raw, out_dir, gt_mask=gt,
                           start_index=s * tpi, keep=range(lb, ub))
    if config.get("out_image"):
        out_path = config["out_image"]
        if len(scenes) > 1:
            stem = Path(out_path)
            out_path = stem.with_name(f"{stem.stem}_{s}{stem.suffix}")
        seg.export_map(labels, out_path)


def sharded_scene_labels(seg: SceneSegmenter, raw, config: dict, mesh):
    """One whole scene's labels over the mesh: the fullconv strips with
    ``fullconv_bands`` (``fullconv_chunks: [r, k]`` as blocks of r x k
    tiles), else the window path's strips."""
    if config.get("fullconv_bands"):
        chunks = config.get("fullconv_chunks") or (None, None)
        return seg.predict_scene_fullconv_sharded(
            raw, mesh, col_tiles=chunks[1] and int(chunks[1]),
            row_tiles=chunks[0] and int(chunks[0]))
    return seg.predict_scene_sharded(raw, mesh)


def scene_labels(seg: SceneSegmenter, raw, config: dict):
    """One whole scene's labels by the path the config selects (a device
    map from the window and chunked fullconv paths, a host uint8 map from
    the banded ones; the exports take either)."""
    if config.get("fullconv_bands"):
        band_rows = int(config["fullconv_bands"])
        chunks = config.get("fullconv_chunks")
        if chunks:
            padded, rows, cols, halo = seg.pad_scene_fullconv(raw)
            return seg.predict_padded_fullconv(
                padded, rows, cols, halo, band_rows=band_rows,
                row_tiles=int(chunks[0]), col_tiles=int(chunks[1]))
        return seg.predict_scene_fullconv(raw, band_rows=band_rows)
    if config.get("stream_rows"):
        return seg.predict_scene_streamed(
            raw, band_rows=int(config["stream_rows"]))
    return seg.predict_scene(raw)


def main(argv=None) -> int:
    predict(common.resolve_config_arg(argv or sys.argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
