"""Debug plots (port of ``cvcs_tpu/utils/debug.py``): the reference's
``debug_plot``, the first sample of a batch as image, colour mask and
context, and the retrieval notebook's activation grid.

matplotlib is imported inside the functions with the headless Agg
backend (``metrics.plots.pyplot``), never when this module is imported.
Tensors on any device are taken to the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cvcs_tpu_torch.data.palette import GID15Palette
from cvcs_tpu_torch.metrics.plots import pyplot


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def debug_plot(out_dir, epoch: int, chunk: int, batch_index: int,
               image, mask, context=None) -> Path:
    """Write ``debug_e{epoch}_c{chunk}_b{batch}.png`` showing sample 0."""
    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    img = _host(image[0])[..., :3].astype(np.uint8)
    color = GID15Palette().decode_u8_host(_host(mask[0]))
    panels = [("patch", img), ("mask", color)]
    if context is not None:
        panels.append(("context", _host(context[0])[..., :3].astype(np.uint8)))
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    for ax, (title, data) in zip(np.atleast_1d(axes), panels):
        ax.imshow(data)
        ax.set_title(title)
        ax.axis("off")
    path = out_dir / f"debug_e{epoch}_c{chunk}_b{batch_index}.png"
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def plot_activations(features, path, max_channels: int = 64,
                     title: str = "") -> Path:
    """Activation-map grid of one tapped feature map (H, W, C), or the
    first of a batch (the notebook's ``visualize_activations``); use with
    :func:`cvcs_tpu_torch.retrieval.features.extract_features`."""
    plt = pyplot()
    feats = _host(features)
    if feats.ndim == 4:
        feats = feats[0]
    c = min(feats.shape[-1], max_channels)
    cols = 8
    rows = -(-c // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    for i, ax in enumerate(np.asarray(axes).ravel()):
        ax.axis("off")
        if i < c:
            ax.imshow(feats[..., i], cmap="viridis")
    if title:
        fig.suptitle(f"{title} {feats.shape}")
    path = Path(path)
    fig.savefig(path, bbox_inches="tight", dpi=70)
    plt.close(fig)
    return path
