"""Train, validation-loss, BN-statistics and predict steps (port of
``cvcs_tpu/train/step.py``).

As in the JAX package (and the reference's ``train.py:114-126``): images
arrive uint8 and are cast to f32 inside the step, the model runs in train
mode (BatchNorm on batch statistics, updating the running ones), and the
loss sees the f32 logits.

``accum = N`` splits the batch into N micro-batches run in order, with the
JAX package's semantics (``step.py:49-60,88-115``): BatchNorm normalises
and updates its running statistics per micro-batch, the gradients of the
micro losses are summed and then divided by N (one optimizer update), and
the reported loss is the mean of the micro losses.

Every parameter is decayed and has its momentum traced at every step, as
optax does, including a parameter the loss does not reach (the DeepLab
backbones' unread ``aux_layer``): torch's SGD and Adam skip a parameter
whose ``.grad`` is None, so those get a zero gradient first.

Dropout (SegFormer's and DeepLab's heads) draws from generators seeded from
``(state.dropout_seed, state.step)`` at the start of each train step, the
port of the JAX step's ``fold_in(dropout_key, step)``; micro-batches draw
in turn. The statistics refresh draws from seed 0, as the JAX one does;
the validation-loss and predict steps run in eval mode and draw nothing.

``context`` (uint8 context windows in the patches' order, or None) reaches
the model, cast to f32 beside the image, only when given: the trainer and
the evaluation CLI give it to a net whose ``ModelSpec.requires_context``
is set, as the JAX steps do.

``mesh`` (a :class:`cvcs_tpu_torch.core.mesh.Mesh` whose data axis has
more than one rank): the batch is this rank's share of the global batch
(``mesh.shard_batch``; with ``accum = N`` its slice of each of the N
global micro-batches, in order), and the step runs under
``mesh.data_parallel``: BatchNorm statistics and the loss span the global
batch, dropout draws the global batch's mask, and the gradients are
summed over the data group before the update, so every rank makes the
single-process update of the global batch (JAX ``step.py:84-115`` under a
sharded ``jit``). A batch that does not split over the ranks is run whole
on every rank (``sharded=False``), as JAX replicates it, and its
gradients are averaged over the group so that the replicas stay equal.

``rows=True`` (a mesh whose spatial axis has more than one rank): the
batch is also cut to this rank's strip of patch rows
(``mesh.shard_rows``), and the step runs under ``mesh.spatial_parallel``:
the models compute their strips' rows of the single-device forward
(halos, gathers), BatchNorm statistics and the loss span every rank of
the mesh, and the gradients are summed over every rank (each rank's
graph holds its own rows' share). The statistics refresh, the
validation loss and the predict step take the same flag.
"""

from __future__ import annotations

import contextlib

import torch

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.models.blocks import seed_dropout
from cvcs_tpu_torch.train.state import TrainState


def zero_unused_grads(state: TrainState) -> None:
    """Give every trainable parameter that received no gradient a zero
    one. The set is taken at the state's first step (the zoo's graphs do
    not change from step to step), so later steps visit only it."""
    if state.unused is None:
        state.unused = [p for group in state.optimizer.opt.param_groups
                        for p in group["params"]
                        if p.requires_grad and p.grad is None]
    for p in state.unused:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


@contextlib.contextmanager
def frozen_bn_stats(model: torch.nn.Module, frozen: bool = True):
    """Keep the BatchNorm running statistics as they were across the
    block (``update_stats=False`` of the JAX step: BN still normalises
    with batch statistics, so losses and gradients are unchanged)."""
    saved = ([(b, b.detach().clone()) for name, b in model.named_buffers()
              if name.endswith(("running_mean", "running_var"))]
             if frozen else [])
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


def forward(model, x: torch.Tensor, context=None) -> torch.Tensor:
    """``model(x)``, or ``model(x, context)`` with the context cast to
    f32."""
    if context is None:
        return model(x)
    return model(x, context.to(torch.float32))


def _parallel(mesh, rows: bool, sharded: bool = True):
    """The step's parallel context: row strips, data parallelism or
    none."""
    if rows:
        return mesh_lib.spatial_parallel(mesh)
    return mesh_lib.data_parallel(mesh if sharded else None)


def train_step(state: TrainState, loss_fn, image, mask, *, accum: int = 1,
               update_stats: bool = True, context=None, mesh=None,
               sharded: bool = True, rows: bool = False) -> torch.Tensor:
    """One optimizer update on the batch; returns the loss (a 0-d tensor
    on the device, not synchronised; under a mesh the global batch's)."""
    model = state.model
    model.train()
    x = image.to(torch.float32)
    if x.shape[0] % accum:
        raise ValueError(f"grad_accum={accum} must divide the batch size "
                         f"{x.shape[0]}")
    opt = state.optimizer.opt
    opt.zero_grad(set_to_none=True)
    seed_dropout(model, state.dropout_seed, state.step)
    with frozen_bn_stats(model, frozen=not update_stats), \
            _parallel(mesh, rows, sharded):
        if accum == 1:
            loss = loss_fn(forward(model, x, context), mask)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
            ctxs = (context.chunk(accum) if context is not None
                    else [None] * accum)
            for xi, mi, ci in zip(x.chunk(accum), mask.chunk(accum), ctxs):
                micro = loss_fn(forward(model, xi, ci), mi)
                micro.backward()
                loss = loss + micro.detach()
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = loss / accum
    zero_unused_grads(state)
    if mesh is not None:
        mesh_lib.reduce_grads(
            [p for group in opt.param_groups for p in group["params"]
             if p.requires_grad], mesh, average=not sharded, spatial=rows)
    opt.step()
    state.step += 1
    return loss


@torch.no_grad()
def stats_step(state: TrainState, image, context=None, mesh=None,
               rows: bool = False) -> None:
    """BatchNorm running-statistics refresh: one train-mode forward whose
    only effect is the statistics update (the companion of
    ``update_stats=False``); with ``mesh``, on this rank's share of the
    batch, the statistics spanning the global one."""
    state.model.train()
    seed_dropout(state.model, 0)
    with _parallel(mesh, rows):
        forward(state.model, image.to(torch.float32), context)


@torch.inference_mode()
def loss_step(state: TrainState, loss_fn, image, mask, context=None,
              mesh=None, rows: bool = False) -> torch.Tensor:
    """Validation loss: eval-mode forward, loss on the f32 logits; with
    ``mesh``, on this rank's share of the batch, the loss the global
    batch's."""
    state.model.eval()
    with _parallel(mesh, rows):
        return loss_fn(forward(state.model, image.to(torch.float32),
                               context), mask)


@torch.inference_mode()
def predict_step(state: TrainState, image, returns_logits: bool = True,
                 context=None, mesh=None, rows: bool = False) -> torch.Tensor:
    """Eval-mode forward -> int32 label map (with ``rows``, this rank's
    strip of it)."""
    state.model.eval()
    with _parallel(mesh, rows):
        out = forward(state.model, image.to(torch.float32), context)
    if returns_logits:
        out = out.argmax(-1)
    return out.to(torch.int32)
