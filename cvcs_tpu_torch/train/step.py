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
"""

from __future__ import annotations

import contextlib

import torch

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


def train_step(state: TrainState, loss_fn, image, mask, *, accum: int = 1,
               update_stats: bool = True, context=None) -> torch.Tensor:
    """One optimizer update on the batch; returns the loss (a 0-d tensor
    on the device, not synchronised)."""
    model = state.model
    model.train()
    x = image.to(torch.float32)
    if x.shape[0] % accum:
        raise ValueError(f"grad_accum={accum} must divide the batch size "
                         f"{x.shape[0]}")
    opt = state.optimizer.opt
    opt.zero_grad(set_to_none=True)
    seed_dropout(model, state.dropout_seed, state.step)
    with frozen_bn_stats(model, frozen=not update_stats):
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
    opt.step()
    state.step += 1
    return loss


@torch.no_grad()
def stats_step(state: TrainState, image, context=None) -> None:
    """BatchNorm running-statistics refresh: one train-mode forward whose
    only effect is the statistics update (the companion of
    ``update_stats=False``)."""
    state.model.train()
    seed_dropout(state.model, 0)
    forward(state.model, image.to(torch.float32), context)


@torch.inference_mode()
def loss_step(state: TrainState, loss_fn, image, mask,
              context=None) -> torch.Tensor:
    """Validation loss: eval-mode forward, loss on the f32 logits."""
    state.model.eval()
    return loss_fn(forward(state.model, image.to(torch.float32), context),
                   mask)


@torch.inference_mode()
def predict_step(state: TrainState, image, returns_logits: bool = True,
                 context=None) -> torch.Tensor:
    """Eval-mode forward -> int32 label map."""
    state.model.eval()
    out = forward(state.model, image.to(torch.float32), context)
    if returns_logits:
        out = out.argmax(-1)
    return out.to(torch.int32)
