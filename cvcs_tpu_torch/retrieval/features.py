"""Deep-feature embeddings for retrieval (port of
``cvcs_tpu/retrieval/features.py``).

A forward hook takes the tapped module's output, the notebook's own
idiom, and stops the forward there, so the layers after the tap do not
run (the JAX package's jitted tap drops them the same way):

* UNet family -> the deepest encoder level (x5, 1024 channels), the
  notebook's ``encode5`` tap;
* DeepLabV3   -> the backbone's ``"out"`` map (MobileNet's 960 planes);
* SegFormer   -> the last MiT stage (Hugging Face's
  ``last_hidden_state``).

Any other net (SwinUnet, the Ensemble) has no tap and raises. The tapped
map comes back NHWC in f32; an embedding is its spatial max (the
notebook's) or mean.
"""

from __future__ import annotations

import numpy as np
import torch


class _Tapped(Exception):
    """Raised by the tap's hook to end the forward at the tap."""


def _tap(model):
    """(module whose output is tapped, picks the map from that output)."""
    name = type(model).__name__
    if name == "UNet":
        return model.encode5[-1], lambda out: out
    if name == "DeepLabV3":
        return model.backbone, lambda out: out["out"]
    if name == "SegFormer":
        return model.segformer.encoder, lambda out: out[-1]
    raise ValueError(f"no retrieval tap registered for {name}")


def extract_features(model, images: torch.Tensor) -> torch.Tensor:
    """The tapped feature map (B, h, w, C) f32 of a batch of NHWC images
    (any dtype, 0-255 values), computed in eval mode without gradients."""
    module, pick = _tap(model)
    taken = []

    def hook(_module, _inputs, out):
        taken.append(pick(out))
        raise _Tapped

    handle = module.register_forward_hook(hook)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(images.float())
    except _Tapped:
        pass
    finally:
        handle.remove()
        model.train(was_training)
    return taken[0].float()


def extract_embedding(model, images: torch.Tensor,
                      pool: str = "max") -> torch.Tensor:
    """(B, C) f32 embedding: the tapped planes pooled over space."""
    feats = extract_features(model, images)
    if pool == "max":
        return feats.amax(dim=(1, 2))
    if pool == "mean":
        return feats.mean(dim=(1, 2))
    raise ValueError(f"unknown pool {pool!r}")


def rank_by_distance(probe, candidates, metric: str = "l2") -> list:
    """Candidate indices best first by embedding distance (L2, L1 or
    cosine), on the host in numpy: the embeddings are small (B, C)
    vectors and the caller ranks once per probe."""
    p = np.asarray(probe, np.float32)
    c = np.asarray(candidates, np.float32)
    if metric == "l2":
        d = np.linalg.norm(c - p[None], axis=-1)
    elif metric == "l1":
        d = np.sum(np.abs(c - p[None]), axis=-1)
    elif metric == "cosine":
        pn = p / max(np.linalg.norm(p), 1e-12)
        cn = c / np.maximum(
            np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
        d = 1.0 - cn @ pn
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return list(np.argsort(d))
