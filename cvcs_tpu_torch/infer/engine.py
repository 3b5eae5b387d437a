"""Sliding-window whole-scene segmentation engine (port of the window path
of ``cvcs_tpu/infer/engine.py``).

A scene is tiled row-major into p x p patches; each patch is forwarded
inside a bc x bc border-correction window (centered by default,
bottom-right anchored under ``bug_parity`` like the reference), the label
window is center-cropped back to p, and the tiles are stitched into a
label canvas. The scene goes to the device once as uint8, padded by
bc - p on every side; windows are gathered, cast (uint8 -> f32 -> the
model's compute dtype), forwarded, argmaxed and stitched on the device,
and the canvas is uint8, so a scene comes back in one uint8 transfer.
Batches of ``batch_tiles`` windows run in order; the last batch is ragged
(its labels are those of the wrapped tail batch of the JAX engine).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from cvcs_tpu_torch.core.device import resolve_device
from cvcs_tpu_torch.data.geometry import TileGrid
from cvcs_tpu_torch.data.palette import GID15Palette


def labels_to_host(labels) -> np.ndarray:
    """A label map (device tensor or array) as host uint8."""
    if isinstance(labels, torch.Tensor):
        return labels.to(torch.uint8).cpu().numpy()
    return np.asarray(labels).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    patch_size: int = 224
    border_correction: int | None = 256   # None -> raw p x p forwards
    batch_tiles: int = 128                # windows per forward
    num_classes: int = 16
    bug_parity: bool = False              # reference's anchored windows
    mask_only: bool = False               # bare PNG vs 3-panel figure
    tta: bool = False                     # dihedral-flip logit averaging


class SceneSegmenter:
    """Whole-scene segmentation for one model.

    ``model`` maps NHWC float32 windows to NHWC logits (or, with
    ``returns_logits=False``, to labels) on ``device`` — the card unless
    ``device="cpu"`` is passed."""

    def __init__(self, model: Callable, config: InferenceConfig,
                 returns_logits: bool = True, requires_context: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = config
        self.returns_logits = returns_logits
        if config.tta and not returns_logits:
            raise ValueError(
                "tta averages logits over the dihedral flips — a "
                "label-output net has no logits to average; drop 'tta'")
        if requires_context:
            raise ValueError(
                "the scene engine does not extract per-window contexts; "
                "requires_context models are unsupported here")
        bc = config.border_correction
        if bc is not None and bc < config.patch_size:
            raise ValueError(
                f"border_correction={bc} must be >= "
                f"patch_size={config.patch_size} (the window is a "
                "superset of the tile)")
        if config.num_classes > 256:
            raise ValueError("the label canvas is uint8: num_classes must "
                             "be <= 256")
        self.palette = GID15Palette()

    # -- geometry ------------------------------------------------------------
    def _window(self) -> tuple[int, int]:
        """(window size, offset of window top-left relative to tile)."""
        p = self.cfg.patch_size
        bc = self.cfg.border_correction or p
        margin = bc - p
        off = margin if self.cfg.bug_parity else margin // 2
        return bc, off

    # -- window-batch forward --------------------------------------------------
    def _forward_labels(self, wins: torch.Tensor) -> torch.Tensor:
        """(B, bc, bc, C) f32 windows -> (B, p, p) labels: forward (with
        optional dihedral-flip TTA), argmax, center-crop to the tile."""
        p = self.cfg.patch_size
        bc, _ = self._window()
        fwd = self.model
        if self.cfg.tta:
            out = fwd(wins)
            out = out + fwd(wins.flip(2)).flip(2)
            out = out + fwd(wins.flip(1)).flip(1)
            out = out + fwd(wins.flip((1, 2))).flip((1, 2))
            out = out / 4.0
        else:
            out = fwd(wins)
        lab = out.argmax(-1) if self.returns_logits else out
        crop0 = (bc - p) // 2
        return lab[:, crop0:crop0 + p, crop0:crop0 + p]

    def _labels_for_windows(self, stack, s, wy, wx) -> torch.Tensor:
        """Gather bc-windows of scenes ``s`` at padded coords (wy, wx) of
        the (S, Hp, Wp, C) uint8 stack and run :meth:`_forward_labels`."""
        bc, _ = self._window()
        ar = torch.arange(bc, device=stack.device)
        rows = (wy[:, None] + ar)[:, :, None]
        cols = (wx[:, None] + ar)[:, None, :]
        wins = stack[s[:, None, None], rows, cols].to(torch.float32)
        return self._forward_labels(wins)

    @torch.inference_mode()
    def _run(self, stack: torch.Tensor, rows: int, cols: int,
             tile_ids: torch.Tensor | None = None) -> torch.Tensor:
        """Labels of a padded scene stack: the (S, rows*p, cols*p) uint8
        canvas, or, given ``tile_ids`` (row-major ids in scene 0), the
        (n, p, p) labels of just those tiles."""
        p = self.cfg.patch_size
        bc, off = self._window()
        pad = bc - p
        tpi = rows * cols
        if tile_ids is None:
            ids = torch.arange(stack.shape[0] * tpi, device=stack.device)
            canvas = torch.zeros((stack.shape[0], rows, cols, p, p),
                                 dtype=torch.uint8, device=stack.device)
        else:
            ids = tile_ids.to(stack.device)
            tiles = torch.empty((ids.numel(), p, p), dtype=torch.uint8,
                                device=stack.device)
        bt = min(self.cfg.batch_tiles, ids.numel())
        for start in range(0, ids.numel(), bt):
            idx = ids[start:start + bt]
            s, t = idx // tpi, idx % tpi
            r, c = t // cols, t % cols
            lab = self._labels_for_windows(
                stack, s, r * p + pad - off, c * p + pad - off)
            lab = lab.to(torch.uint8)
            if tile_ids is None:
                canvas[s, r, c] = lab
            else:
                tiles[start:start + bt] = lab
        if tile_ids is not None:
            return tiles
        return canvas.permute(0, 1, 3, 2, 4).reshape(
            stack.shape[0], rows * p, cols * p)

    # -- scene upload ------------------------------------------------------
    def pad_scenes(self, scenes):
        """Upload + zero-pad a same-shape scene stack once (uint8); returns
        (stack, rows, cols)."""
        if isinstance(scenes, (list, tuple)):
            scenes = np.stack([np.asarray(s) for s in scenes])
        scenes = torch.as_tensor(np.asarray(scenes))
        if scenes.dim() == 3:
            scenes = scenes[..., None]
        p = self.cfg.patch_size
        bc, _ = self._window()
        pad = bc - p
        n, h, w, c = scenes.shape
        grid = TileGrid((h, w), p)
        if grid.rows == 0 or grid.cols == 0:
            raise ValueError(
                f"scene {(h, w)} is smaller than one {p}x{p} patch — "
                "nothing to segment")
        stack = torch.zeros((n, h + 2 * pad, w + 2 * pad, c),
                            dtype=scenes.dtype, device=self.device)
        stack[:, pad:pad + h, pad:pad + w] = scenes.to(self.device)
        return stack, grid.rows, grid.cols

    def pad_scene(self, scene):
        """Upload + zero-pad one (H, W, C) scene; returns (scene_pad, rows,
        cols) for :meth:`predict_padded`."""
        stack, rows, cols = self.pad_scenes(np.asarray(scene)[None])
        return stack[0], rows, cols

    # -- prediction ----------------------------------------------------------
    def predict_padded(self, scene_pad, rows: int, cols: int) -> torch.Tensor:
        return self._run(scene_pad[None], rows, cols)[0]

    def predict_scene(self, scene) -> torch.Tensor:
        """(H, W, C) uint8 scene -> on-device (H', W') uint8 label map, H'/W'
        the largest tile-aligned dims (partial tiles are dropped)."""
        return self.predict_padded(*self.pad_scene(scene))

    def predict_scenes_padded(self, stack, rows: int,
                              cols: int) -> torch.Tensor:
        return self._run(stack, rows, cols)

    def predict_scenes(self, scenes) -> torch.Tensor:
        """Same-shape scenes (list or (S, H, W, C) stack) -> (S, H', W')
        labels; batches span scene boundaries."""
        return self.predict_scenes_padded(*self.pad_scenes(scenes))

    def predict_tiles(self, scene, tile_ids) -> torch.Tensor:
        """Labels of the listed row-major tiles of one scene only:
        (len(tile_ids), p, p), computing just those windows."""
        ids = torch.as_tensor(np.asarray(tile_ids, np.int64))
        if ids.numel() == 0:
            p = self.cfg.patch_size
            return torch.zeros((0, p, p), dtype=torch.uint8,
                               device=self.device)
        scene_pad, rows, cols = self.pad_scene(scene)
        return self._run(scene_pad[None], rows, cols, tile_ids=ids)

    # -- exports ---------------------------------------------------------------
    def export_patches(self, labels, out_dir, start_index: int = 0,
                       keep=None) -> list:
        """Per-tile color-mask PNGs ``{i}.png`` in row-major order; ``keep``
        filters global patch indices."""
        from PIL import Image

        p = self.cfg.patch_size
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        rgb = self.palette.decode_u8_host(labels_to_host(labels))
        rows, cols = rgb.shape[0] // p, rgb.shape[1] // p
        paths = []
        for r in range(rows):
            for c in range(cols):
                i = start_index + r * cols + c
                if keep is not None and i not in keep:
                    continue
                path = out_dir / f"{i}.png"
                Image.fromarray(rgb[r * p:(r + 1) * p, c * p:(c + 1) * p]
                                ).save(path)
                paths.append(path)
        return paths

    def export_map(self, labels, path) -> None:
        """Stitched full-scene color map, one PNG."""
        from PIL import Image

        Image.fromarray(
            self.palette.decode_u8_host(labels_to_host(labels))).save(path)

    def export_tile_patches(self, tiles, global_ids, out_dir) -> list:
        """Color-mask PNGs for :meth:`predict_tiles` output, named by the
        global patch indices."""
        from PIL import Image

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        rgb = self.palette.decode_u8_host(labels_to_host(tiles))
        paths = []
        for k, i in enumerate(global_ids):
            path = out_dir / f"{i}.png"
            Image.fromarray(rgb[k]).save(path)
            paths.append(path)
        return paths

    def _write_figure(self, path, image_tile, pred_rgb_tile, gt_rgb_tile):
        """One 3-panel (image / [ground truth] / prediction) figure."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        panels = [("patch", image_tile[..., :3].astype(np.uint8))]
        if gt_rgb_tile is not None:
            panels.append(("ground truth", gt_rgb_tile))
        panels.append(("prediction", pred_rgb_tile))
        fig, axes = plt.subplots(1, len(panels),
                                 figsize=(4 * len(panels), 4))
        for ax, (title, img) in zip(np.atleast_1d(axes), panels):
            ax.imshow(img)
            ax.set_title(title)
            ax.axis("off")
        fig.savefig(path, bbox_inches="tight", dpi=80)
        plt.close(fig)

    def export_figures(self, labels, scene, out_dir, gt_mask=None,
                       start_index: int = 0, keep=None) -> list:
        """Per-tile 3-panel figures from a full-scene label canvas."""
        p = self.cfg.patch_size
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        pred_rgb = self.palette.decode_u8_host(labels_to_host(labels))
        gt_rgb = (None if gt_mask is None
                  else self.palette.decode_u8_host(labels_to_host(gt_mask)))
        scene = np.asarray(scene)
        rows, cols = pred_rgb.shape[0] // p, pred_rgb.shape[1] // p
        paths = []
        for r in range(rows):
            for c in range(cols):
                i = start_index + r * cols + c
                if keep is not None and i not in keep:
                    continue
                sl = (slice(r * p, (r + 1) * p), slice(c * p, (c + 1) * p))
                path = out_dir / f"{i}.png"
                self._write_figure(path, scene[sl], pred_rgb[sl],
                                   None if gt_rgb is None else gt_rgb[sl])
                paths.append(path)
        return paths

    def export_tile_figures(self, tiles, global_ids, local_ids, scene,
                            cols: int, out_dir, gt_mask=None) -> list:
        """3-panel figures for :meth:`predict_tiles` output."""
        p = self.cfg.patch_size
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        pred_rgb = self.palette.decode_u8_host(labels_to_host(tiles))
        scene = np.asarray(scene)
        gt_rgb = (None if gt_mask is None
                  else self.palette.decode_u8_host(labels_to_host(gt_mask)))
        paths = []
        for k, (gi, li) in enumerate(zip(global_ids, local_ids)):
            r, c = divmod(int(li), cols)
            sl = (slice(r * p, (r + 1) * p), slice(c * p, (c + 1) * p))
            path = out_dir / f"{gi}.png"
            self._write_figure(path, scene[sl], pred_rgb[k],
                               None if gt_rgb is None else gt_rgb[sl])
            paths.append(path)
        return paths
