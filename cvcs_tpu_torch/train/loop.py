"""Epoch / chunk / batch training loop (port of ``cvcs_tpu/train/loop.py``).

The reference's ``train.py:104-169``: a per-epoch scene reshuffle, the
chunk loop, the per-batch loss appended to the training history, the
per-epoch learning rate and validation loss, a confusion-matrix
evaluation every ``precision_evaluation_freq`` epochs, a checkpoint every
``freq`` epochs, and resume. With ``debug_plot`` the first sample of each
chunk's first batch is drawn into ``debug/`` under the working directory
(``utils/debug.py``), as the JAX trainer draws it. ``random_tps``
appends each chunk's multi-scale crops (``ChunkLoader.get_chunk``); a net
whose spec sets ``requires_context`` gets each batch's context windows.
With ``async_checkpoints`` the epoch-boundary checkpoints are written by a
thread while training goes on (``train/checkpoint.py``); the loop waits
for the write in flight before a preemption save and at the end, and
prunes again once it has landed.

Steps run one by one (the JAX trainer's ``steps_per_call``, a TPU
dispatch knob, has no counterpart; the train CLI accepts and ignores the
key). Losses stay on the device and are read once per chunk, one chunk late:
chunk c+1's host decode and upload run while chunk c's steps are still
queued on the card. A non-finite loss halts training
(``FloatingPointError``). On the preemption signal the loop finishes the
chunk in flight, writes ``checkpoint{epoch}_preempt`` and returns.

With a ``mesh`` whose data axis has more than one rank (JAX's ``_shard``,
``cvcs_tpu/train/loop.py:216-254``, on the data axis): every rank builds
the same chunk (the shuffle, ``random_shift``, ``random_tps`` and the
fused augmentation draw from generators seeded alike) and takes its share
of each batch, as the JAX multi-host branch does; the train, statistics
and validation-loss steps run data-parallel (``train/step.py``), so the
losses are the global batches'; the evaluation sums its confusion
matrices over the data group. Rank 0 alone writes the logs, the
``metrics_log``, the debug plots and the checkpoints (asynchronous ones
included), and the other ranks wait for each save at a barrier; the
preemption flag is agreed between the ranks at each chunk boundary.

With a mesh whose spatial axis has more than one rank (JAX's ``_shard``
on the spatial axis): the rank's share is also cut to its strip of
patch rows when the rows divide over the spatial ranks (otherwise the
spatial ranks compute the same share, as JAX leaves the rows
unsharded); the train, statistics, validation-loss and predict steps
run on the strips (``train/step.py`` ``rows``), the gradients and the
losses span every rank, and the evaluation counts each rank's strips
and sums the confusion matrices over every rank. A batch that does not
split over the data ranks is computed whole on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.data.loader import ChunkLoader
from cvcs_tpu_torch.metrics import confusion, scores
from cvcs_tpu_torch.train import checkpoint as ckpt_lib
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import (loss_step, predict_step, stats_step,
                                       train_step)


DEBUG_DIR = "debug"


def downscale_batch(image: torch.Tensor, mask: torch.Tensor, ds: int):
    """1/ds-resolution eval batch: box-mean of the uint8 image, rounded;
    nearest subsample of the mask."""
    b, h, w, c = image.shape
    img = image.to(torch.float32).reshape(b, h // ds, ds, w // ds, ds, c)
    img = img.mean(dim=(2, 4))
    return torch.round(img).to(torch.uint8), mask[:, ::ds, ::ds]


@dataclasses.dataclass
class TrainConfig:
    """The reference's train-config vocabulary."""

    epochs: int
    batch_size: int
    checkpoint_directory: str
    freq: int = 1                        # checkpoint every N epochs
    precision_evaluation_freq: int = 10  # confusion eval every N epochs
    num_classes: int = 15                # foreground classes (bg added)
    ignore_background: bool = False
    verbose: bool = False
    metrics_log: str | None = None       # JSONL per-epoch metrics
    # True: BN running statistics update every step (the reference);
    # False: once per chunk from its last batch (same losses and grads)
    bn_exact_stats: bool = True
    keep_checkpoints: int | None = None
    grad_accum: int = 1
    eval_downscale: int = 1
    seed: int = 0                        # dropout seed: seed ^ 0xD0
    debug_plot: bool = False             # draw each chunk's first sample
    random_tps: list | None = None       # [[crop size, share of tiles]]
    async_checkpoints: bool = False


class Trainer:
    """Drives training of one model over train/validation ChunkLoaders."""

    def __init__(self, spec, state: TrainState, loss_fn: Callable,
                 train_loader: ChunkLoader, val_loader: ChunkLoader,
                 config: TrainConfig,
                 log: Callable[[str], None] = lambda s: print(s, flush=True),
                 mesh: mesh_lib.Mesh | None = None):
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum={config.grad_accum} must be >= 1")
        if config.grad_accum > 1 and config.batch_size % config.grad_accum:
            raise ValueError(f"batch_size={config.batch_size} must be "
                             f"divisible by grad_accum={config.grad_accum}")
        self.spec = spec
        self.state = state
        self.state.dropout_seed = config.seed ^ 0xD0
        # the mesh (None: one process)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.lead = self.mesh is None or self.mesh.rank == 0
        if not self.lead:
            log = lambda s: None   # noqa: E731 - rank 0 writes the logs
        mesh_lib.replicate(state.model, self.mesh)
        self.loss_fn = loss_fn
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.log = log
        self.training_loss_values: list[float] = []
        self.validation_loss_values: list[float] = []
        self.conf_history: list[Any] = []
        self.last_epoch = 0
        # the last periodic evaluation's metric dict (None before the first)
        self.last_metrics: dict | None = None
        self._preempted = False

    def install_preemption_handler(self, signums=None) -> None:
        """On the signal (SIGTERM by default): finish the chunk in flight,
        write ``checkpoint{epoch}_preempt`` and return from :meth:`train`;
        a signal during the end-of-epoch work exits after that epoch's
        boundary checkpoint."""
        for s in (signums or (signal.SIGTERM,)):
            signal.signal(s, lambda *_: setattr(self, "_preempted", True))

    def resume(self, path: str | Path) -> None:
        """Restore the state and histories; the checkpoint's batch_size
        overrides the config (the reference's behaviour)."""
        self.state, meta = ckpt_lib.load_checkpoint(path, self.state)
        self.training_loss_values = meta.get("training_loss_values", [])
        self.validation_loss_values = meta.get("validation_loss_values", [])
        self.last_epoch = int(meta.get("epoch", -1)) + 1
        if meta.get("batch_size"):
            self.config.batch_size = int(meta["batch_size"])
            if (self.config.grad_accum > 1
                    and self.config.batch_size % self.config.grad_accum):
                self.log(f"WARNING: checkpoint batch_size "
                         f"{self.config.batch_size} is not divisible by "
                         f"grad_accum={self.config.grad_accum}; disabling "
                         "gradient accumulation")
                self.config.grad_accum = 1
        self.log(f"Resumed from {path} at epoch {self.last_epoch} "
                 f"(batch_size={self.config.batch_size})")

    def _save(self, epoch: int, tag: str = "", confusions: bool = True,
              async_save: bool = False):
        """Rank 0 writes the checkpoint (and prunes); every rank waits
        at a barrier until it has been written or, asynchronously,
        issued."""
        try:
            if self.lead:
                return self._write(epoch, tag, confusions, async_save)
        finally:
            mesh_lib.barrier(self.mesh)

    def _write(self, epoch: int, tag: str, confusions: bool,
               async_save: bool):
        cfg = self.config
        hist = self.conf_history if confusions else None
        path = ckpt_lib.save_checkpoint(
            cfg.checkpoint_directory, epoch, self.state,
            self.training_loss_values, self.validation_loss_values,
            cfg.batch_size, self.state.optimizer.name,
            conf_flat=None if hist is None else [np.asarray(m).tolist()
                                                 for m in hist],
            conf_normalized=None if hist is None else [
                confusion.normalize_rows(m).tolist() for m in hist],
            tag=tag, async_save=async_save)
        if cfg.keep_checkpoints:
            for old in ckpt_lib.prune_checkpoints(cfg.checkpoint_directory,
                                                  cfg.keep_checkpoints):
                self.log(f"Pruned {old.name}")
        return path

    def _harvest(self, losses: list[torch.Tensor], epoch: int) -> None:
        """Read a chunk's losses to the host (one synchronisation) and
        halt on a non-finite one."""
        if not losses:
            return
        flat = torch.stack(losses).cpu().numpy()
        self.training_loss_values += [float(v) for v in flat]
        if not np.isfinite(flat).all():
            i = int(np.argmax(~np.isfinite(flat)))
            step = len(self.training_loss_values) - len(flat) + i
            raise FloatingPointError(
                f"non-finite training loss ({flat[i]}) at epoch {epoch + 1}, "
                f"global step {step + 1}: training diverged (check lr/loss "
                "config); resume from the last checkpoint with a safer "
                "schedule")

    def _context(self, batch):
        """The batch's context windows for a net that reads them."""
        return batch.context if self.spec.requires_context else None

    def _share(self, batch, micro: int = 1, downscale: int = 1):
        """(image, mask, context, valid, mesh, rows) of this rank's share
        of a batch (its images and masks box- and nearest-downscaled by
        ``downscale`` first): with a mesh and a batch that splits over
        its data ranks (in ``micro`` global micro-batches), the rank's
        slices and the mesh, cut to the rank's strip of rows when they
        divide over the spatial ranks (``rows``); otherwise the whole
        batch and None."""
        ctx = self._context(batch)
        image, mask = batch.image, batch.mask
        if downscale > 1:
            image, mask = downscale_batch(image, mask, downscale)
        if self.mesh is None or mesh_lib.data_slice(
                image.shape[0], self.mesh, micro) is None:
            return image, mask, ctx, batch.valid, None, False
        image, mask, ctx, valid = mesh_lib.shard_batch(
            (image, mask, ctx, batch.valid), self.mesh, micro)
        rows = mesh_lib.rows_divide(image.shape[1], self.mesh)
        if rows:
            image, mask = mesh_lib.shard_rows((image, mask), self.mesh)
        return image, mask, ctx, valid, self.mesh, rows

    def train(self) -> TrainState:
        cfg = self.config
        bs = cfg.batch_size
        for epoch in range(self.last_epoch, cfg.epochs):
            self.log(f"Started epoch {epoch + 1}")
            t_epoch = time.time()
            lr = self.state.optimizer.set_epoch(epoch)
            self.train_loader.shuffle()
            n_patches = 0
            n_train_before = len(self.training_loss_values)
            pending = None
            for c in range(len(self.train_loader)):
                chunk = self.train_loader.get_chunk(c, cfg.random_tps)
                chunk_losses = []
                last_batch = None
                for b_idx, batch in enumerate(chunk.batches(
                        bs, drop_last=False, pad_tail=False)):
                    if cfg.debug_plot and b_idx == 0 and self.lead:
                        from cvcs_tpu_torch.utils.debug import debug_plot
                        debug_plot(DEBUG_DIR, epoch, c, b_idx,
                                   batch.image, batch.mask)
                    n = batch.image.shape[0]
                    accum = cfg.grad_accum if n % cfg.grad_accum == 0 else 1
                    image, mask, ctx, _, dp, rows = self._share(batch,
                                                                accum)
                    chunk_losses.append(train_step(
                        self.state, self.loss_fn, image, mask,
                        accum=accum, update_stats=cfg.bn_exact_stats,
                        context=ctx, mesh=self.mesh, sharded=dp is not None,
                        rows=rows))
                    n_patches += n
                    last_batch = batch
                if not cfg.bn_exact_stats and last_batch is not None:
                    image, _, ctx, _, dp, rows = self._share(last_batch)
                    stats_step(self.state, image, ctx, mesh=dp, rows=rows)
                if pending is not None:
                    self._harvest(pending, epoch)
                pending = chunk_losses
                self._preempted = mesh_lib.any_rank(self._preempted,
                                                    self.mesh)
                if self._preempted:
                    self._harvest(pending, epoch)
                    # the boundary save in flight may target this directory
                    ckpt_lib.wait_for_saves()
                    self._save(epoch - 1, tag="_preempt", confusions=False)
                    self.log(f"Preemption save: epoch {epoch + 1} interrupted"
                             f" after chunk {c + 1}; wrote checkpoint{epoch}"
                             "_preempt; resume replays this epoch")
                    return self.state
            if pending is not None:
                self._harvest(pending, epoch)
            epoch_s = time.time() - t_epoch
            if cfg.verbose and self.training_loss_values:
                self.log(f"Epoch {epoch + 1}: loss="
                         f"{self.training_loss_values[-1]:.4f} "
                         f"({n_patches / max(epoch_s, 1e-9):.1f} patches/s)")

            self.log("Running validation...")
            n_val_before = len(self.validation_loss_values)
            self.validation_loss_values += self.validation_loss()
            if cfg.metrics_log and self.lead:
                train_new = self.training_loss_values[n_train_before:]
                val_new = self.validation_loss_values[n_val_before:]
                with open(cfg.metrics_log, "a") as f:
                    f.write(json.dumps({
                        "epoch": epoch + 1, "lr": lr,
                        "train_loss": (float(np.mean(train_new))
                                       if train_new else None),
                        "val_loss": (float(np.mean(val_new))
                                     if val_new else None),
                        "patches_per_s": n_patches / max(epoch_s, 1e-9),
                        "epoch_s": epoch_s}) + "\n")

            if (epoch + 1) % cfg.precision_evaluation_freq == 0:
                self.log(f"Evaluating precision after epoch {epoch + 1}")
                host = self.evaluate(cfg.num_classes + 1,
                                     downscale=cfg.eval_downscale)
                self.last_metrics = scores.print_metrics(
                    host.total, silent=not self.lead)
                self.conf_history.append(host.total)

            saved = (epoch + 1) % cfg.freq == 0
            if saved:
                self._save(epoch, async_save=cfg.async_checkpoints)
                self.log(f"Saved checkpoint {epoch + 1}")
            self._preempted = mesh_lib.any_rank(self._preempted, self.mesh)
            if self._preempted:
                ckpt_lib.wait_for_saves()
                if not saved:
                    self._save(epoch)
                self.log(f"Preemption save: stopped after completed epoch "
                         f"{epoch + 1}; wrote checkpoint{epoch + 1}")
                return self.state

        ckpt_lib.wait_for_saves()
        if cfg.keep_checkpoints and self.lead:
            # the in-loop prunes pass an in-flight write by; now it has landed
            for old in ckpt_lib.prune_checkpoints(cfg.checkpoint_directory,
                                                  cfg.keep_checkpoints):
                self.log(f"Pruned {old.name}")
        mesh_lib.barrier(self.mesh)   # every checkpoint has landed
        self.log("Training Done!")
        if self.training_loss_values:
            self.log(f"Reached training loss: {self.training_loss_values[-1]}")
        if self.validation_loss_values:
            self.log("Reached validation loss: "
                     f"{self.validation_loss_values[-1]}")
        return self.state

    def validation_loss(self) -> list[float]:
        """Eval-mode loss of every validation batch, the final partial one
        included."""
        values = []
        for c in range(len(self.val_loader)):
            chunk = self.val_loader.get_chunk(c, shuffle_patches=False)
            for batch in chunk.batches(self.config.batch_size,
                                       drop_last=False, pad_tail=False):
                image, mask, ctx, _, dp, rows = self._share(batch)
                values.append(loss_step(self.state, self.loss_fn, image,
                                        mask, ctx, mesh=dp, rows=rows))
        return torch.stack(values).cpu().tolist() if values else []

    def evaluate(self, num_classes: int = 16, batch_size: int = 8,
                 downscale: int = 1) -> confusion.HostConfusion:
        """Confusion matrix over the validation set, accumulated on the
        device and folded to the host once per chunk. ``downscale > 1``
        evaluates 1/N-resolution patches (box-mean image, nearest mask)."""
        ignore = 0 if self.config.ignore_background else None
        host = confusion.HostConfusion(num_classes)
        for c in range(len(self.val_loader)):
            chunk = self.val_loader.get_chunk(c, shuffle_patches=False)
            conf = confusion.confusion_matrix(num_classes,
                                              chunk.images.device)
            for batch in chunk.batches(batch_size, drop_last=False):
                image, mask, ctx, valid, dp, rows = self._share(
                    batch, downscale=downscale)
                if self.mesh is not None and (
                        (dp is None and self.mesh.data_index)
                        or (not rows and self.mesh.spatial_index)):
                    # a share that other ranks hold too counts on one
                    continue
                pred = predict_step(self.state, image,
                                    self.spec.returns_logits, ctx,
                                    mesh=dp, rows=rows)
                if valid is not None:
                    # padding samples: an out-of-range target drops them
                    mask = torch.where(valid[:, None, None], mask,
                                       num_classes + 1)
                confusion.update_confusion(conf, pred, mask, num_classes,
                                           ignore)
            if self.mesh is not None:
                conf = mesh_lib.all_reduce_sum(conf, self.mesh.world_group)
            host.fold(conf)
        return host
