"""Whole-scene segmentation engine (port of the single-device paths of
``cvcs_tpu/infer/engine.py``).

The window path: a scene is tiled row-major into p x p patches; each
patch is forwarded inside a bc x bc border-correction window (centered by
default, bottom-right anchored under ``bug_parity`` like the reference),
the label window is center-cropped back to p, and the tiles are stitched
into a label canvas. The scene goes to the device once as uint8, padded
by bc - p on every side; windows are gathered, cast (uint8 -> f32 -> the
model's compute dtype), forwarded, argmaxed and stitched on the device,
and the canvas is uint8, so a scene comes back in one uint8 transfer.
Batches of ``batch_tiles`` windows run in order; the last batch is ragged
(its labels are those of the wrapped tail batch of the JAX engine).

The band paths: :meth:`SceneSegmenter.predict_scene_streamed` runs the
window path band by band (device memory O(band), not O(scene));
:meth:`SceneSegmenter.predict_scene_fullconv` forwards each band of tile
rows as one full convolution over the halo-padded band, and
:meth:`SceneSegmenter.predict_padded_fullconv` does so on a scene kept on
the device, optionally as a batch of halo-overlapped blocks. The two
host-banded paths bring each band's labels back one band late, on a copy
stream, so that the copy and the host's preparation of the next band
overlap the next band's compute.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterable

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
                 stride_product: int = 1, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = config
        self.returns_logits = returns_logits
        # the model's fullconv divisibility constraint (ModelSpec
        # .stride_product); 1 = unconstrained
        self.stride_product = stride_product
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
        self._copy_stream = None   # device -> host label copies (cuda)

    def _reject_tta_fullconv(self) -> None:
        """The fullconv paths do not apply the window path's dihedral TTA
        averaging; refuse the combination rather than return non-TTA
        labels for a TTA run."""
        if self.cfg.tta:
            raise ValueError(
                "tta composes with the window path only; the fullconv "
                "paths don't apply the dihedral averaging — drop 'tta' "
                "or drop 'fullconv_bands'/'fullconv_chunks'")

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
    def _grid(self, shape) -> TileGrid:
        """The tile grid of an (H, W, ...) scene; raises when it holds no
        whole tile."""
        p = self.cfg.patch_size
        grid = TileGrid((shape[0], shape[1]), p)
        if grid.rows == 0 or grid.cols == 0:
            raise ValueError(
                f"scene {tuple(shape[:2])} is smaller than one {p}x{p} "
                "patch — nothing to segment")
        return grid

    def _upload_padded(self, arr, top: int, bottom: int, left: int,
                       right: int, pinned: bool = False) -> torch.Tensor:
        """A host (..., H, W, C) array on the device, zero-padded on its
        two spatial dims. ``pinned`` (the band paths): on the card the
        copy goes asynchronously from pinned memory, so the host goes on
        while the bands queued before it compute."""
        arr = np.asarray(arr)
        if pinned and self.device.type == "cuda":
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            t = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            t.numpy()[...] = arr            # one host copy, into pinned
        else:
            pinned = False
            t = torch.from_numpy(np.ascontiguousarray(arr))
        *lead, h, w, c = t.shape
        out = torch.zeros((*lead, top + h + bottom, left + w + right, c),
                          dtype=t.dtype, device=self.device)
        out[..., top:top + h, left:left + w, :].copy_(t, non_blocking=pinned)
        return out

    def pad_scenes(self, scenes):
        """Upload + zero-pad a same-shape scene stack once (uint8); returns
        (stack, rows, cols)."""
        if isinstance(scenes, (list, tuple)):
            scenes = np.stack([np.asarray(s) for s in scenes])
        scenes = np.asarray(scenes)
        if scenes.ndim == 3:
            scenes = scenes[..., None]
        bc, _ = self._window()
        pad = bc - self.cfg.patch_size
        grid = self._grid(scenes.shape[1:])
        stack = self._upload_padded(scenes, pad, pad, pad, pad)
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

    # -- band paths: labels come back to the host one band late -----------
    def _to_host_late(self, bands: Iterable[torch.Tensor]) -> np.ndarray:
        """Concatenate the uint8 label bands that ``bands`` yields, as host
        rows. Each band's copy is issued only after the next band was
        launched (the generator launches it when asked for it), on a copy
        stream that waits for that band's own work alone, so the copy and
        the host's preparation of the next band overlap its compute."""
        host, prev = [], None
        for lab in bands:
            done = None
            if lab.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(lab.device))
            if prev is not None:
                host.append(self._fetch(*prev))
            prev = (lab, done)
        host.append(self._fetch(*prev))
        return np.concatenate(host, axis=0)

    def _fetch(self, lab: torch.Tensor, done) -> np.ndarray:
        """One label band to the host: on the card, copied on the copy
        stream after the event ``done`` (the band's own work)."""
        if done is None:
            return lab.numpy()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=lab.device)
        stream = self._copy_stream
        stream.wait_event(done)
        with torch.cuda.stream(stream):
            out = torch.empty(lab.shape, dtype=lab.dtype, pin_memory=True)
            out.copy_(lab, non_blocking=True)
        lab.record_stream(stream)
        stream.synchronize()
        return out.numpy()

    def predict_scene_streamed(self, scene, band_rows: int = 8) -> np.ndarray:
        """Band-pipelined whole-scene window inference, for rasters too
        tall to stage on the device whole: bands of ``band_rows`` tile
        rows plus the border-correction halo are sliced from the real
        scene (zero-padded only at the scene's edges) and run through the
        window path, so at most a band of imagery and two label bands are
        device-resident. Returns a host uint8 (H', W') array with the
        labels of :meth:`predict_scene`."""
        bc, _ = self._window()
        pad = bc - self.cfg.patch_size
        scene = np.asarray(scene)
        cols = self._grid(scene.shape).cols
        return self._to_host_late(
            self._run(band[None], br, cols)[0]
            for br, band in self._bands(scene, band_rows, pad,
                                        scene.shape[1], pad, pad))

    def _bands(self, scene: np.ndarray, band_rows: int, halo: int,
               right: int, left_pad: int, right_pad: int):
        """(tile rows, device band) for each band of ``band_rows`` tile
        rows of the scene's grid: its rows plus ``halo`` above and below
        taken from the real scene (columns up to ``right``) and
        zero-padded only past the scene's edges, and ``left_pad`` /
        ``right_pad`` zero columns."""
        p = self.cfg.patch_size
        rows = self._grid(scene.shape).rows
        for r0 in range(0, rows, band_rows):
            br = min(band_rows, rows - r0)
            y0, y1 = r0 * p, (r0 + br) * p
            top = max(0, y0 - halo)
            bot = min(scene.shape[0], y1 + halo)
            yield br, self._upload_padded(
                scene[top:bot, :right], halo - (y0 - top),
                max(0, halo - (bot - y1)), left_pad, right_pad, pinned=True)

    # -- full-convolution band paths (opt-in, beyond the reference) --------
    def _check_fullconv_divisible(self, halo: int, band_heights,
                                  width: int) -> None:
        """Every halo-padded band (or block) the model forwards must be a
        multiple of the model's stride product, or the forward fails deep
        in the decoder or misaligns; raise an error naming the knobs."""
        s = self.stride_product
        if s <= 1:
            return
        bad = sorted({d for d in set(band_heights) | {width} if d % s})
        if bad:
            p = self.cfg.patch_size
            raise ValueError(
                f"fullconv band shape(s) {bad} are not divisible by the "
                f"model's stride product {s}: with patch_size={p} and "
                f"halo={halo}, each band is (fullconv_bands*{p} + "
                f"2*{halo}) rows (the tail band may be shorter) x "
                f"(cols*{p} + 2*{halo}) columns — pick fullconv_bands / "
                f"border_correction (halo = (border_correction - "
                f"patch_size)/2) so both are multiples of {s}, or crop "
                f"the scene's tile grid")

    @staticmethod
    def _fullconv_band_heights(rows: int, band_rows: int, p: int,
                               halo: int) -> list[int]:
        """Padded heights of the full bands and the (shorter) tail."""
        return [min(band_rows, rows - r0) * p + 2 * halo
                for r0 in range(0, rows, band_rows)]

    def _fullconv_halo(self, halo: int | None) -> int:
        return (self._window()[0] - self.cfg.patch_size) // 2 \
            if halo is None else halo

    @torch.inference_mode()
    def _fullconv_forward(self, x: torch.Tensor, out_h: int, out_w: int,
                          halo: int) -> torch.Tensor:
        """(N, Hb, Wb, C) uint8 halo-padded bands or blocks -> (N, out_h,
        out_w) uint8 labels of one forward, the halo cropped off."""
        out = self.model(x.to(torch.float32))
        lab = out.argmax(-1) if self.returns_logits else out
        return lab[:, halo:halo + out_h, halo:halo + out_w].to(torch.uint8)

    def predict_scene_fullconv(self, scene, band_rows: int = 8,
                               halo: int | None = None) -> np.ndarray:
        """Seamless full-convolution inference (opt-in; not the reference's
        per-window semantics). Each band of ``band_rows`` tile rows runs
        as one forward at batch 1 over the band padded by ``halo`` (default
        (bc - p) // 2) real or, at the scene's edges, zero pixels: about
        (1 + 2 halo / band_h)(1 + 2 halo / W) of the scene's pixels against
        the window path's bc² / p², no per-tile gather and no tile seams
        inside a band. Band shapes must be multiples of the model's stride
        product. Bands stream through the device as in
        :meth:`predict_scene_streamed`. Returns host uint8 (H', W')."""
        self._reject_tta_fullconv()
        p = self.cfg.patch_size
        halo = self._fullconv_halo(halo)
        scene = np.asarray(scene)
        grid = self._grid(scene.shape)
        rows, cols = grid.rows, grid.cols
        w = cols * p
        self._check_fullconv_divisible(
            halo, self._fullconv_band_heights(rows, band_rows, p, halo),
            w + 2 * halo)
        right = min(scene.shape[1], w + halo)   # real pixels where present
        return self._to_host_late(
            self._fullconv_forward(band[None], br * p, w, halo)[0]
            for br, band in self._bands(scene, band_rows, halo, right, halo,
                                        halo - (right - w)))

    def pad_scene_fullconv(self, scene, halo: int | None = None):
        """Upload + halo-pad a scene once for
        :meth:`predict_padded_fullconv`: real pixels fill the bottom and
        right halo where the raster extends past the tile grid, zeros
        elsewhere. Returns ``(padded (H' + 2h, W' + 2h, C) uint8 on the
        device, rows, cols, halo)``."""
        self._reject_tta_fullconv()
        p = self.cfg.patch_size
        halo = self._fullconv_halo(halo)
        scene = np.asarray(scene)
        grid = self._grid(scene.shape)
        h, w = grid.rows * p, grid.cols * p
        bot = min(scene.shape[0], h + halo)
        right = min(scene.shape[1], w + halo)
        padded = self._upload_padded(scene[:bot, :right], halo,
                                     h + halo - bot, halo, w + halo - right)
        return padded, grid.rows, grid.cols, halo

    def _fullconv_band(self, padded, r0: int, band_h: int, out_h: int,
                       out_w: int, halo: int) -> torch.Tensor:
        """One halo-overlapped band of the device-resident padded scene,
        forwarded whole."""
        return self._fullconv_forward(padded[None, r0:r0 + band_h], out_h,
                                      out_w, halo)[0]

    def _fullconv_band_chunked(self, padded, r0: int, chunk_h: int,
                               chunk_w: int, n_rows: int, n_cols: int,
                               chunk_out_h: int, chunk_out_w: int,
                               halo: int) -> torch.Tensor:
        """A band as a batch of an ``n_rows x n_cols`` grid of
        halo-overlapped blocks, forwarded together (squarer batched shapes
        than one full-width band; seams every block, each healed by
        ``halo`` px of real context)."""
        blocks = torch.stack([
            padded[r0 + i * chunk_out_h:r0 + i * chunk_out_h + chunk_h,
                   j * chunk_out_w:j * chunk_out_w + chunk_w]
            for i in range(n_rows) for j in range(n_cols)])
        labs = self._fullconv_forward(blocks, chunk_out_h, chunk_out_w, halo)
        return (labs.reshape(n_rows, n_cols, chunk_out_h, chunk_out_w)
                .permute(0, 2, 1, 3)
                .reshape(n_rows * chunk_out_h, n_cols * chunk_out_w))

    def predict_padded_fullconv(self, padded, rows: int, cols: int,
                                halo: int, band_rows: int = 8,
                                col_tiles: int | None = None,
                                row_tiles: int | None = None
                                ) -> torch.Tensor:
        """Full-convolution inference over a scene padded by
        :meth:`pad_scene_fullconv`, with no host round trip between bands:
        returns the stitched (rows*p, cols*p) uint8 label map on the
        device. The labels of :meth:`predict_scene_fullconv` when
        ``col_tiles`` is None; with ``col_tiles=k`` each band runs as a
        batch of halo-overlapped blocks k tiles wide and ``row_tiles``
        (default ``band_rows``) tiles tall. ``col_tiles`` must divide
        ``cols``; a band that ``row_tiles`` does not divide (the tail)
        falls back to band-tall blocks."""
        p = self.cfg.patch_size
        w = cols * p
        if col_tiles is not None and (col_tiles < 1 or cols % col_tiles):
            raise ValueError(
                f"col_tiles={col_tiles} must be a positive divisor of "
                f"the scene's {cols} tile columns")
        heights = self._fullconv_band_heights(rows, band_rows, p, halo)
        if col_tiles is None:
            self._check_fullconv_divisible(halo, heights, w + 2 * halo)
        else:
            rt0 = row_tiles or band_rows
            self._check_fullconv_divisible(
                halo, [rt0 * p + 2 * halo] + [
                    bh for bh in heights if (bh - 2 * halo) // p % rt0],
                col_tiles * p + 2 * halo)
        bands = []
        for r0 in range(0, rows, band_rows):
            br = min(band_rows, rows - r0)
            if col_tiles is None:
                bands.append(self._fullconv_band(
                    padded, r0 * p, br * p + 2 * halo, br * p, w, halo))
            else:
                rt = row_tiles or br
                if br % rt:
                    rt = br
                bands.append(self._fullconv_band_chunked(
                    padded, r0 * p, rt * p + 2 * halo,
                    col_tiles * p + 2 * halo, br // rt, cols // col_tiles,
                    rt * p, col_tiles * p, halo))
        return torch.cat(bands, dim=0)

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
