"""``python -m cvcs_tpu_torch.cli.train <config.yaml>`` (port of
``cvcs_tpu/cli/train.py``): chunked training with augmentation, the
class-balanced loss, per-epoch validation, periodic confusion-matrix
evaluation, checkpoint and resume.

Runs on the card unless the config says ``device: cpu``. ``debug_plot``
draws each chunk's first sample into ``debug/``; ``profile_dir`` writes a
torch.profiler trace of the training to ``<profile_dir>/trace.json``.
``load_context`` gives both loaders context windows, ``random_tps`` adds
multi-scale crops to the training chunks, ``async_checkpoints`` writes
the epoch checkpoints from a thread, and ``load_checkpoint`` (a path or
``auto``) resumes from a checkpoint of the port or an Orbax one of the
JAX package.

``mesh: {data: N}`` trains data-parallel over N ranks (``torchrun
--nproc-per-node N -m cvcs_tpu_torch.cli.train cfg.yaml``; see
``train/loop.py``): every rank builds the same chunks and steps on its
share of each batch, and rank 0 writes the logs and checkpoints. Each
rank runs the fused window-attention kernels on its own share (the JAX
package's ``CVCS_TPU_FUSED_ATTN_TRAIN=0`` under a mesh is a knob of the
TPU partitioner and has no counterpart). ``mesh.spatial > 1``
(spatially partitioned training) raises ``NotImplementedError`` naming
its ROADMAP item.
"""

from __future__ import annotations

import sys
import traceback

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import TRAIN_KEYS, validate_keys
from cvcs_tpu_torch.data.augment import AugmentConfig
from cvcs_tpu_torch.data.loader import ChunkLoader
from cvcs_tpu_torch.data.palette import LABELS
from cvcs_tpu_torch.ops.losses import build_loss
from cvcs_tpu_torch.train.checkpoint import latest_checkpoint
from cvcs_tpu_torch.train.loop import TrainConfig, Trainer
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState, param_count
from cvcs_tpu_torch.utils.profiling import trace
from cvcs_tpu_torch.utils.tables import get_table_cls

# train config keys of paths the port does not run yet -> the ROADMAP item
UNPORTED_TRAIN_KEYS = {
    "mesh": "spatially partitioned training (mesh spatial > 1) is not yet "
            "ported (ROADMAP.md Queue 1 item 14d)",
}


def reject_unported_train_keys(config: dict) -> None:
    if int((config.get("mesh") or {}).get("spatial", 1)) > 1:
        raise NotImplementedError(
            f"config key 'mesh': {UNPORTED_TRAIN_KEYS['mesh']}")


def build_trainer(config: dict) -> Trainer:
    validate_keys(config, TRAIN_KEYS,
                  {"train", "validation", "net", "epochs", "chunk_size",
                   "patch_size", "batch_size", "loss", "opt",
                   "checkpoint_directory"}, "train")
    device = common.device_context(config)
    reject_unported_train_keys(config)
    mesh = common.mesh_from_config(config, device)
    if mesh is not None:
        device = mesh.device
    aug_flag = config.get("augmentation")
    if aug_flag == "fused":
        augment = AugmentConfig(mode="fused")
    elif aug_flag:
        augment = AugmentConfig()
    else:
        augment = None
    seed = int(config.get("seed", 0))
    in_channels = int(config.get("in_channels", 3))
    load_context = bool(config.get("load_context"))
    loader_train = ChunkLoader(
        config["train"], config["chunk_size"],
        patch_size=config["patch_size"],
        random_shift=bool(config.get("random_shift")), augment=augment,
        load_context=load_context, in_channels=in_channels, seed=seed,
        device=device)
    loader_val = ChunkLoader(
        config["validation"],
        config.get("validation_chunk_size", config["chunk_size"]),
        patch_size=config["patch_size"], load_context=load_context,
        in_channels=in_channels, seed=seed + 1, device=device)
    if config.get("debug"):
        # debug: 2 train scenes, 1 validation scene
        loader_train.specify([0, 1])
        loader_val.specify([0])

    model, spec, num_classes = common.build_net(config, device, seed=seed)
    if spec.requires_context and not load_context:
        raise ValueError(f"net {config['net']!r} reads context windows: set "
                         "load_context: true")
    optimizer = build_optimizer(config["opt"], model.parameters(),
                                epochs=config["epochs"])
    state = TrainState(model, optimizer)
    t = get_table_cls()(["Name", "Value"])
    t.add_row(["parameters", param_count(model)])
    t.add_row(["Patch size", loader_train.patch_size])
    t.add_row(["Tpe", loader_train.tpi])
    t.add_row(["Training patches",
               len(loader_train.idxs) * loader_train.tpi])
    t.add_row(["Validation patches",
               len(loader_val.idxs) * loader_val.tpi])
    print(t, flush=True)

    weights = None
    if config["loss"] == "wCEL":
        print("Computing class weights, it might take several minutes...",
              flush=True)
        weights = loader_train.class_weights(
            num_classes, bool(config.get("ignore_background")))
        wt = get_table_cls()(["Class", "Weight"])
        for i, w in enumerate(weights):
            wt.add_row([LABELS.get(i, str(i)), float(w)])
        print(wt, flush=True)
    loss_fn = build_loss(config["loss"], weights=weights,
                         ignore_background=bool(
                             config.get("ignore_background")),
                         device=device)

    train_cfg = TrainConfig(
        epochs=config["epochs"],
        batch_size=config["batch_size"],
        checkpoint_directory=config["checkpoint_directory"],
        freq=config.get("freq", 1),
        precision_evaluation_freq=config.get("precision_evaluation_freq", 10),
        num_classes=int(config.get("num_classes", 15)),
        ignore_background=bool(config.get("ignore_background")),
        verbose=bool(config.get("verbose")),
        metrics_log=config.get("metrics_log"),
        bn_exact_stats=bool(config.get("bn_exact_stats", True)),
        eval_downscale=int(config.get("eval_downscale", 1)),
        keep_checkpoints=(int(config["keep_checkpoints"])
                          if config.get("keep_checkpoints") else None),
        grad_accum=int(config.get("grad_accum", 1)),
        debug_plot=bool(config.get("debug_plot")),
        random_tps=config.get("random_tps"),
        async_checkpoints=bool(config.get("async_checkpoints")),
        seed=seed)
    if (train_cfg.eval_downscale > 1
            and int(config["patch_size"]) % train_cfg.eval_downscale):
        raise ValueError(f"eval_downscale={train_cfg.eval_downscale} must "
                         f"divide patch_size={config['patch_size']}")
    trainer = Trainer(spec, state, loss_fn, loader_train, loader_val,
                      train_cfg, mesh=mesh)
    ckpt = config.get("load_checkpoint")
    if ckpt == "auto":
        ckpt = latest_checkpoint(config["checkpoint_directory"])
        if ckpt is None and common.is_lead(mesh):
            print("No checkpoint to resume from; starting fresh", flush=True)
    if ckpt:
        trainer.resume(ckpt)
    return trainer


def main(argv=None) -> int:
    config = common.resolve_config_arg(argv or sys.argv)
    try:
        trainer = build_trainer(config)
    except Exception:
        traceback.print_exc()
        print("Error in setting up training.")
        return 1
    trainer.install_preemption_handler()
    with trace(config.get("profile_dir")):
        trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
