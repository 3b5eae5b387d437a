"""``python -m cvcs_tpu_torch.cli.retrieve <config.yaml>`` (port of
``cvcs_tpu/cli/retrieve.py``): the reference's retrieval notebook as a
CLI.

Every patch of a GID15-style dataset is a candidate. For a sample of
probe patches the candidates are ranked by mask similarity (mIoU, wIoU,
pixel precision, EMD) and, with a ``net``, by the distance between
deep-feature embeddings; the notebook's EMD-agreement benchmark then
compares the two rankings.

Config keys (``config.loader.RETRIEVE_KEYS``): ``dataset``,
``patch_size``, ``net`` + ``load_checkpoint`` (the embedding model;
without it the mask rankings alone), ``pool`` (max|mean), ``metric``
(l2|l1|cosine), ``num_probes``, ``topk`` (rankings kept per probe,
default 10), ``images`` (restrict scenes), ``num_classes``, ``seed``,
``batch_size`` (embedding batch, default 16), ``precision``,
``in_channels`` and ``device`` (the card unless ``cpu``).

``net`` takes the zoo's names with a tap (``retrieval.features``) or the
DINO trunks ``vits8 / vits16 / vitb8 / vitb16`` (CLS embeddings of
ImageNet-normalised patches); for those ``load_checkpoint`` may be a
DINO ``.pth`` state dict.

The candidate pool, images and masks, lives on the device. The mask
scores of a probe against the whole pool are one ``compute_scores`` call,
read back once per probe; the embeddings are computed batch by batch and
read back once. The last batch runs at its own size (the JAX package pads
it to keep one compiled shape; nothing here is compiled per shape).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import RETRIEVE_KEYS, validate_keys
from cvcs_tpu_torch.data.loader import ChunkLoader
from cvcs_tpu_torch.retrieval.features import (extract_embedding,
                                               rank_by_distance)
from cvcs_tpu_torch.retrieval.scores import (SCORE_NAMES, compute_scores,
                                             rank_candidates,
                                             scores_evaluation)

# DINO's preprocessing: the notebook normalises with the ImageNet
# statistics before the hub trunks
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def build_embedder(config: dict, device: torch.device):
    """(embed, description): ``embed`` maps a (B, p, p, C) uint8 batch on
    ``device`` to (B, D) f32 embeddings."""
    from cvcs_tpu_torch.models.vit import VIT_VARIANTS, ViT, dino_vit

    name = str(config["net"])
    variant = name.lower().removeprefix("dino_")
    if variant in VIT_VARIANTS:
        dtypes = common.model_dtypes(config)
        ckpt = config.get("load_checkpoint")
        if ckpt and Path(ckpt).is_file() and Path(ckpt).suffix != ".npz":
            # a DINO hub state dict: every parameter comes from the file
            from cvcs_tpu_torch.weights import load_dino

            model = load_dino(ViT(**VIT_VARIANTS[variant], **dtypes), ckpt)
            print(f"Loaded DINO checkpoint {ckpt}", flush=True)
        else:
            model = common.restore_variables(config,
                                             dino_vit(variant, **dtypes))
        model = model.to(device).eval()
        mean = torch.tensor(IMAGENET_MEAN, device=device)
        std = torch.tensor(IMAGENET_STD, device=device)

        def embed(imgs: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return model((imgs.float() / 255.0 - mean) / std)[0]

        return embed, f"DINO {variant} CLS"

    model, _, _ = common.build_net(config, device)
    common.restore_variables(config, model)
    pool = config.get("pool", "max")
    return (lambda imgs: extract_embedding(model, imgs, pool=pool),
            f"{name} tap")


def candidate_pool(config: dict, device: torch.device):
    """Every patch of the dataset, scene by scene in tile order, on
    ``device``: (N, p, p, C) uint8 images and (N, p, p) uint8 masks (class
    ids fit a byte, which quarters the bytes each probe's scores read)."""
    loader = ChunkLoader(config["dataset"], chunk_size=1,
                         patch_size=int(config["patch_size"]),
                         seed=int(config.get("seed", 0)), device=device)
    if config.get("images"):
        loader.specify(config["images"])
    chunks = [loader.get_chunk(c, shuffle_patches=False)
              for c in range(len(loader))]
    return (torch.cat([c.images for c in chunks]),
            torch.cat([c.masks.to(torch.uint8) for c in chunks]))


def retrieve(config: dict) -> dict:
    validate_keys(config, RETRIEVE_KEYS, {"dataset", "patch_size"},
                  "retrieve")
    device = common.device_context(config)
    t_start = time.time()
    timings: dict[str, float] = {}
    num_classes = int(config.get("num_classes", 15)) + 1
    images, masks = candidate_pool(config, device)
    n = int(images.shape[0])
    timings["load_s"] = time.time() - t_start
    print(f"candidate pool: {n} patches", flush=True)

    emb = None
    if config.get("net"):
        t0 = time.time()
        embed, desc = build_embedder(config, device)
        bs = int(config.get("batch_size", 16))
        emb = torch.cat([embed(images[s:s + bs])
                         for s in range(0, n, bs)]).cpu().numpy()
        timings["embeddings_s"] = time.time() - t0
        print(f"embeddings: {desc}, {emb.shape}", flush=True)

    t0 = time.time()
    rng = np.random.default_rng(int(config.get("seed", 0)))
    probes = rng.choice(n, size=min(int(config.get("num_probes", 10)), n),
                        replace=False)
    topk = int(config.get("topk", 10))
    emd_rankings, emb_rankings, mask_rankings = [], [], []
    for probe in probes:
        probe = int(probe)
        # the whole pool scored at once (self-matches drop out below);
        # one read back
        scores = compute_scores(masks[probe], masks, num_classes)
        values = torch.stack([scores[k] for k in SCORE_NAMES]).cpu().numpy()
        scores = dict(zip(SCORE_NAMES, values))
        ranks = {"probe": probe}
        for key, higher in (("emd", False), ("miou", True),
                            ("wiou", True), ("pprec", True)):
            order = rank_candidates(scores[key], higher_better=higher)
            ranks[key] = [int(k) for k in order if k != probe][:topk]
        mask_rankings.append(ranks)
        emd_rankings.append(
            [int(k) for k in rank_candidates(scores["emd"],
                                             higher_better=False)
             if k != probe])
        if emb is not None:
            order = rank_by_distance(emb[probe], emb,
                                     metric=config.get("metric", "l2"))
            emb_rankings.append([int(k) for k in order if k != probe])

    timings["scores_s"] = time.time() - t0
    out = {"num_probes": len(probes), "mask_rankings": mask_rankings}
    for r in mask_rankings:
        print(f"probe {r['probe']}: EMD top{topk} -> {r['emd']}",
              flush=True)
    if emb is not None:
        print("embedding-vs-EMD agreement "
              "(notebook `scores_evaluation`):", flush=True)
        out["agreement"] = scores_evaluation(emd_rankings, emb_rankings)
    timings["total_s"] = time.time() - t_start
    out["timings"] = {k: round(v, 3) for k, v in timings.items()}
    print("timings: " + "  ".join(f"{k}={v:.2f}s"
                                  for k, v in out["timings"].items()),
          flush=True)
    return out


def main(argv=None) -> int:
    retrieve(common.resolve_config_arg(argv or sys.argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
