"""Mask-similarity retrieval scores (port of ``cvcs_tpu/retrieval/scores.py``).

Given a target index mask and a stack of query masks:

* ``miou``   mean IoU over the foreground classes, classes absent from
  both masks left out of the mean;
* ``wiou``   IoU weighted by each class's share of the target's
  foreground pixels;
* ``pprec``  pixel precision ``sum(q == t & t != 0) / nnz(t)``;
* ``emd``    earth mover's distance between the masks' foreground class
  histograms (classes 1..n-1, ``torch.histc(bins=n-1, min=1, max=n)``
  bins), by the cumsum-L1 identity.

Plain tensor functions, batched over the queries, on the masks' device.
Every count is an integer tensor and each ratio of counts is one f32
division, correctly rounded; sums and prefix sums over the class axis
add in class order, one f32 add at a time, as XLA's CPU reduction and
cumsum add them. So the scores are the same bits on the CPU and on the
card, and the JAX package's on the CPU, and tied candidates rank alike.
The rankings (:func:`rank_candidates`) and the agreement benchmark
(:func:`scores_evaluation`) run on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

SCORE_NAMES = ("miou", "wiou", "pprec", "emd")


def _flat(target, queries) -> tuple[torch.Tensor, torch.Tensor]:
    t = torch.as_tensor(target)
    q = torch.as_tensor(queries, device=t.device)
    return t.reshape(-1), q.reshape(q.shape[0], -1)


def _class_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, K) -> (B,): f32 adds in class order."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _class_cumsum(x: torch.Tensor) -> torch.Tensor:
    """(B, K) prefix sums, f32 adds in class order (torch's own cumsum
    adds in f64 on the CPU and in parallel on the card)."""
    out = [x[:, 0]]
    for i in range(1, x.shape[1]):
        out.append(out[-1] + x[:, i])
    return torch.stack(out, dim=1)


def class_hist(mask, nclasses: int) -> torch.Tensor:
    """Per-class pixel share, background included."""
    m = torch.as_tensor(mask).reshape(-1).long()
    return torch.bincount(m, minlength=nclasses)[:nclasses] / m.numel()


def _count(m: torch.Tensor) -> torch.Tensor:
    """Per-row count of a (B, N) boolean tensor, in int32: summed as bytes,
    without the int64 copy a boolean sum makes."""
    return m.view(torch.uint8).sum(-1, dtype=torch.int32)


def _hist(counts: torch.Tensor) -> torch.Tensor:
    """(B, n - 1) foreground class counts -> shares of the foreground (all
    zero for an all-background mask)."""
    total = counts.sum(-1, keepdim=True)          # an integer sum: exact
    return torch.where(total > 0, counts / total.clamp(min=1),
                       torch.zeros((), device=counts.device))


def _fg_counts(masks: torch.Tensor, nclasses: int) -> torch.Tensor:
    """(B, N) masks -> (B, nclasses - 1) counts of classes 1..n-1."""
    return torch.stack([_count(masks == c) for c in range(1, nclasses)],
                       dim=-1)


def _class_counts(t: torch.Tensor, q: torch.Tensor, num_classes: int):
    """Per foreground class: the intersection counts and the queries'
    class counts (B, C-1), and the target's (C-1,), in int32. A loop over
    the classes keeps every temporary at (B, N): a (B, C-1, N) one-hot of
    a 1,920-patch pool at p 224 would be 1.4 GB of booleans. A union is
    ``qcount + tcount - inter``, the same integer as counting ``q | t``."""
    inters, qcounts, tcounts = [], [], []
    for c in range(1, num_classes):
        tm = t == c
        qm = q == c
        inters.append(_count(qm & tm))
        qcounts.append(_count(qm))
        tcounts.append(_count(tm[None])[0])
    return (torch.stack(inters, dim=1), torch.stack(qcounts, dim=1),
            torch.stack(tcounts))


def _class_inter_union(t: torch.Tensor, q: torch.Tensor, num_classes: int):
    """Per foreground class: intersection and union counts (B, C-1) and
    the target's support (C-1,)."""
    inter, qcount, support = _class_counts(t, q, num_classes)
    return inter, qcount + support - inter, support


def _iou(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    return torch.where(union > 0, inter / union.clamp(min=1),
                       torch.zeros((), device=inter.device))


def _miou(inter, union) -> torch.Tensor:
    present = (union > 0).sum(1)
    return _class_sum(_iou(inter, union)) / present.clamp(min=1)


def _wiou(inter, union, support) -> torch.Tensor:
    weights = support / support.sum().clamp(min=1)
    return _class_sum(_iou(inter, union) * weights[None, :])


def per_image_miou(target, queries, num_classes: int) -> torch.Tensor:
    """Per-query mean IoU over the foreground classes present in either
    mask (torchmetrics ``mean_iou(include_background=False)``)."""
    inter, union, _ = _class_inter_union(*_flat(target, queries), num_classes)
    return _miou(inter, union)


def per_image_wiou(target, queries, num_classes: int) -> torch.Tensor:
    """Support-weighted Jaccard, background ignored
    (``multiclass_jaccard_index(..., 'weighted', ignore_index=0)``)."""
    inter, union, support = _class_inter_union(*_flat(target, queries),
                                               num_classes)
    return _wiou(inter, union, support)


def pixel_precision(target, queries) -> torch.Tensor:
    """``sum(q == t & t != 0) / nnz(t)``."""
    t, q = _flat(target, queries)
    fg = t != 0
    return _count((q == t) & fg) / _count(fg[None]).clamp(min=1)


def _emd(t_counts: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    return _class_sum((_class_cumsum(_hist(t_counts))
                       - _class_cumsum(_hist(q_counts))).abs())


def per_image_emd(target, queries, nbins: int) -> torch.Tensor:
    """Cumsum-L1 EMD between the foreground class histograms."""
    t, q = _flat(target, queries)
    return _emd(_fg_counts(t[None], nbins), _fg_counts(q, nbins))


def compute_scores(target, queries, num_classes: int) -> dict:
    """All four scores of ``queries`` (B, H, W) against ``target`` (H, W),
    each (B,) f32 on the masks' device. One pass of class counts serves
    mIoU, wIoU and EMD's histograms."""
    t, q = _flat(target, queries)
    inter, qcount, support = _class_counts(t, q, num_classes)
    union = qcount + support - inter
    return {
        "miou": _miou(inter, union),
        "wiou": _wiou(inter, union, support),
        "pprec": pixel_precision(t, q),
        "emd": _emd(support[None], qcount),
    }


def get_best_match_idx(selected_score: str, scores: dict) -> int:
    """Higher is better for the overlap scores, lower for EMD."""
    if selected_score in ("miou", "wiou", "pprec"):
        return int(np.argmax(_host(scores[selected_score])))
    if selected_score == "emd":
        return int(np.argmin(_host(scores[selected_score])))
    raise ValueError(f"'{selected_score}' is not a valid metric")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def scores_evaluation(emd_rankings: list, other_rankings: list,
                      silent: bool = False) -> dict:
    """Retrieval agreement of an embedding ranking with the EMD ranking
    (the notebook's benchmark): top1/top5/top10 and top5-to-K. Each
    ranking is a list, one per probe, of candidate ids best first."""
    dim = len(emd_rankings)
    agg = dict(top1=0.0, top5=0.0, top10=0.0, top5to5=0.0,
               top5to10=0.0, top5to20=0.0, top5to50=0.0)
    for emd_r, other_r in zip(emd_rankings, other_rankings):
        emd_best5 = list(emd_r[:5])
        other50 = list(other_r[:50])
        agg["top1"] += (emd_best5[0] == other50[0]) / dim
        agg["top5"] += (emd_best5[0] in other50[:5]) / dim
        agg["top10"] += (emd_best5[0] in other50[:10]) / dim
        agg["top5to5"] += sum(d in other50[:5] for d in emd_best5) / (5 * dim)
        agg["top5to10"] += sum(d in other50[:10] for d in emd_best5) / (5 * dim)
        agg["top5to20"] += sum(d in other50[:20] for d in emd_best5) / (5 * dim)
        agg["top5to50"] += sum(d in other50 for d in emd_best5) / (5 * dim)
    if not silent:
        print(" ".join(f"{k}={v:.3f}" for k, v in agg.items()), flush=True)
    return agg


def rank_candidates(score_values, higher_better: bool) -> list:
    """Candidate ids best first: numpy's ``argsort`` of the host scores."""
    order = np.argsort(_host(score_values))
    return list(order[::-1] if higher_better else order)
