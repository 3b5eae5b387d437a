"""YAML config loading and key validation (port of
``cvcs_tpu/config/loader.py``, and of ``EXPORT_KEYS`` from
``cvcs_tpu/cli/export.py``)."""

from __future__ import annotations

from pathlib import Path

import yaml

TRAIN_KEYS = {
    "debug", "debug_plot", "verbose", "train", "validation", "test",
    "checkpoint_directory", "load_checkpoint", "device", "net",
    "load_context", "epochs", "chunk_size", "validation_chunk_size",
    "patch_size", "batch_size", "random_shift", "augmentation",
    "random_tps", "loss", "opt", "ignore_background", "freq",
    "precision_evaluation_freq", "num_classes", "load_color_mask",
    # framework extensions
    "precision", "mesh", "seed", "in_channels", "profile_dir",
    "steps_per_call", "metrics_log", "bn_exact_stats",
    "async_checkpoints", "eval_downscale", "keep_checkpoints", "remat",
    "grad_accum",
}
EVAL_KEYS = {
    "dataset", "net", "load_checkpoint", "patch_size", "load_context",
    "load_color_mask", "num_classes", "ignore_background", "verbose",
    "confusion_matrix", "priors", "images", "device", "ensemble_config",
    "precision", "batch_size", "in_channels", "mesh",
}
INFER_KEYS = {
    "dataset", "net", "load_checkpoint", "patch_size", "border_correction",
    "range", "mask_only", "out_image", "num_classes", "device", "output",
    "precision", "bug_parity", "batch_tiles", "load_context", "verbose",
    "mesh", "tta", "in_channels", "stream_rows", "ensemble_config",
    "fullconv_bands", "fullconv_chunks",
}
SERVE_KEYS = {
    "watch_dir", "output", "net", "load_checkpoint", "ensemble_config",
    "patch_size", "border_correction", "batch_tiles", "tta", "num_classes",
    "precision", "in_channels", "mesh", "device",
    "poll_s", "settle_s", "max_batch", "max_retries", "max_polls",
}
ESA_KEYS = {
    "image", "net", "load_checkpoint", "ensemble_config", "patch_size",
    "border_correction", "batch_tiles", "tta", "out_image", "output",
    "num_classes", "precision", "in_channels", "mesh", "device",
}
RETRIEVE_KEYS = {
    "dataset", "patch_size", "net", "load_checkpoint", "pool", "metric",
    "num_probes", "topk", "images", "num_classes", "seed", "batch_size",
    "precision", "in_channels", "device",
}
EXPORT_KEYS = {
    "net", "load_checkpoint", "num_classes", "patch_size", "output",
    "in_channels", "device", "precision", "verbose",
}


def load_yaml(path: str | Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def display_configs(config: dict) -> None:
    width = max((len(str(k)) for k in config), default=0)
    for key, value in config.items():
        print(f"{str(key):>{width}} : {value}", flush=True)


def validate_keys(config: dict, allowed: set, required: set, job: str) -> None:
    missing = required - set(config)
    if missing:
        raise KeyError(f"{job} config missing required keys: {sorted(missing)}")
    unknown = set(config) - allowed
    if unknown:
        print(f"[cvcs_tpu_torch] warning: unknown {job} config keys "
              f"ignored: {sorted(unknown)}", flush=True)
