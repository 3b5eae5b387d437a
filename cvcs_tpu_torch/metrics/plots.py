"""Evaluation plots (port of ``cvcs_tpu/metrics/plots.py``): the
row-normalised confusion heatmap and the class-prior bars.

matplotlib (and seaborn, where present) are imported inside the functions
with the headless Agg backend, never when this module is imported: a
machine without them runs everything but these two functions. Both write
to a path.
"""

from __future__ import annotations

import numpy as np

from cvcs_tpu_torch.data.palette import LABELS, PALETTE, SHORT_LABELS


def pyplot():
    """matplotlib's pyplot on the headless Agg backend, imported now."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion(normalized, path: str) -> None:
    """Heatmap of the row-normalised confusion matrix, short class labels
    on both axes (seaborn's heatmap where seaborn and pandas import, as
    the reference draws it; matplotlib's ``imshow`` otherwise)."""
    plt = pyplot()
    normalized = np.asarray(normalized)
    try:
        import pandas as pd
        import seaborn as sn

        df = pd.DataFrame(normalized, SHORT_LABELS[: normalized.shape[0]],
                          SHORT_LABELS[: normalized.shape[1]])
        plt.figure(figsize=(10, 8))
        # the reference's settings, quirks included: sn.set is global and
        # annot_kws / fmt come without annot=True (no cell numbers)
        sn.set(font_scale=2.3)
        hm = sn.heatmap(
            df, annot_kws={"size": 20},
            cmap=sn.color_palette("ch:s=.25,rot=-.25", as_cmap=True),
            fmt=".1f")
        hm_ax = hm.figure.axes[-1]
        hm.set_yticklabels(hm.get_yticklabels(), rotation=0)
        hm_ax.tick_params(labelsize=20, labelrotation=0)
    except ImportError:
        plt.figure(figsize=(10, 8))
        plt.imshow(normalized, cmap="viridis")
        plt.colorbar()
        plt.xticks(range(normalized.shape[1]),
                   SHORT_LABELS[: normalized.shape[1]], rotation=90)
        plt.yticks(range(normalized.shape[0]),
                   SHORT_LABELS[: normalized.shape[0]])
    plt.savefig(path, bbox_inches="tight", dpi=100)
    plt.close("all")


def plot_priors(conf, path: str, sort: bool = True) -> None:
    """Class-share horizontal bars from the confusion rows' supports,
    palette-coloured, each labelled with its pixels in millions."""
    plt = pyplot()
    conf = np.asarray(conf, np.float64)
    support = conf.sum(axis=1)
    total = support.sum()
    entries = [(i, s / total if total else 0.0, s)
               for i, s in enumerate(support)]
    if sort:
        entries.sort(key=lambda e: e[1])

    fig, ax = plt.subplots()
    fig.set_size_inches(18.5, 10.5)
    y = np.arange(len(entries))
    colors = [tuple(PALETTE[i] / 255.0) for i, _, _ in entries]
    ax.barh(y, [share for _, share, _ in entries], align="center",
            color=colors)
    ax.set_yticks(y, labels=[LABELS[i] for i, _, _ in entries])
    ax.set_xlabel("Class prior")
    ax.set_title("Pixels per class")
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    for rect, (_, _, pixels) in zip(ax.patches, entries):
        ax.annotate(
            "{:,.2f}M".format(pixels / 1e6),
            (rect.get_width(), rect.get_y() + rect.get_height() / 2),
            xytext=(3, 0), textcoords="offset points",
            va="center", ha="left", color="black")
    plt.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
