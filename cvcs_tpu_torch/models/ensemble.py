"""Majority-vote ensemble (port of ``cvcs_tpu/models/ensemble.py``): each
member forwards the batch, its logits become labels, and the labels are
voted pixel by pixel. ``returns_logits = False``: the forward gives
labels.

The vote stays on the device: an int32 one-hot sum (a ``scatter_add_``
of ones into per-class counts) and an argmax, which returns the first
maximum, so a tie goes to the smallest label, ``torch.mode``'s rule.
Members run in eval mode under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch


@dataclasses.dataclass
class EnsembleMember:
    """One voted member. ``apply`` maps an NHWC f32 batch to logits (or,
    with ``returns_logits=False``, to labels); with ``variables`` set it
    takes them first, ``apply(variables, image)``, and the ensemble passes
    its entry of ``member_variables`` there."""

    name: str
    apply: Callable[..., torch.Tensor]
    returns_logits: bool = True
    variables: Any = None   # None -> apply is (image)


class Ensemble:
    """Pixelwise majority vote over the members' predictions."""

    requires_context = False
    returns_logits = False
    wrapper = True

    def __init__(self, members: Sequence[EnsembleMember], num_classes: int):
        if not members:
            raise ValueError("ensemble needs at least one member")
        self.members = list(members)
        self.num_classes = num_classes

    @property
    def member_variables(self) -> list:
        return [m.variables for m in self.members]

    def vote(self, member_variables: Sequence[Any],
             image: torch.Tensor) -> torch.Tensor:
        """Member forwards and the vote -> (B, H, W) int32 labels;
        ``member_variables`` aligns with ``self.members``."""
        if len(member_variables) != len(self.members):
            raise ValueError(
                f"{len(member_variables)} variable entries for "
                f"{len(self.members)} members — a silent zip-truncation "
                "here would vote over a subset of the ensemble")
        votes = torch.zeros(image.shape[:3] + (self.num_classes,),
                            dtype=torch.int32, device=image.device)
        for m, mv in zip(self.members, member_variables):
            if m.variables is None:
                pred = m.apply(image)
            else:
                if mv is None:
                    raise ValueError(
                        f"member {m.name!r} holds variables but its "
                        "member_variables entry is None")
                pred = m.apply(mv, image)
            if m.returns_logits:
                pred = pred.argmax(-1)
            votes.scatter_add_(-1, pred.long().unsqueeze(-1),
                               torch.ones_like(votes[..., :1]))
        return votes.argmax(-1).to(torch.int32)

    @torch.inference_mode()
    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        return self.vote(self.member_variables, image)
