"""Train state (port of ``cvcs_tpu/train/state.py``): the model, whose
parameters (f32) and BatchNorm running statistics it holds, the
optimizer with its state, the step count, the dropout seed (the JAX
trainer's ``dropout_key``, ``seed ^ 0xD0``), and the parameters the loss
does not reach, which ``train/step.py`` finds at the first step.

PyTorch updates in place, so the state is a mutable holder where the JAX
package threads an immutable pytree through a donated jitted step."""

from __future__ import annotations

import dataclasses

from torch import nn

from cvcs_tpu_torch.train.optim import OptimizerBundle


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: OptimizerBundle
    step: int = 0
    dropout_seed: int = 0xD0              # seed ^ 0xD0, for seed 0
    unused: list | None = dataclasses.field(default=None, repr=False)


def param_count(model: nn.Module) -> int:
    """Total trainable parameters."""
    return sum(p.numel() for p in model.parameters())
