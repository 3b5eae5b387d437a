"""Reference ``torch.save`` checkpoints (port of
``cvcs_tpu/utils/torch_import.py``'s ``strip_prefixes`` and
``load_reference_checkpoint``: here ``reference_state_dict(load_pickle(
path), net)``, the route ``restore_variables`` takes).

The reference saves a 12-key pickle: ``epoch``, ``model_state_dict``,
``optimizer_state_dict``, ``scheduler_state_dict``, the training and
validation loss lists, ``batch_size``, the deprecated precision lists,
the flat and normalised confusion histories and the optimizer name. The
port's state dicts already carry the reference's names (the U-Nets),
torchvision's (the DeepLab nets) and Hugging Face's plus the reference's
``seq`` tail (SegformerMod), so no layout changes: the model's entry is
taken out, the wrappers' DataParallel prefixes are rewritten as each
wrapper's ``custom_load`` does (``module.`` -> '' for Resnet101/50 and
SegformerMod, ``module`` -> ``model`` for MobileNet), DeepLab's
``model.`` is stripped, and the result loads with ``strict=True``.

The loading rule: :func:`load_pickle` reads with ``weights_only=True``,
and every class or function the pickle names beyond torch's own allowed
set (numpy arrays and scalars, the confusion-metric objects, anything
else) is bound to an inert placeholder. Tensors, numbers, strings and
containers load as themselves; nothing in the file is run, and a pickle
whose metric objects come from a package this host lacks loads all the
same.
"""

from __future__ import annotations

from typing import Mapping

import torch

# the nets whose reference checkpoints the JAX package imports
REFERENCE_NETS = ("Unet", "Unetv2", "Resnet101", "Resnet50", "MobileNet",
                  "SegformerMod")
_DEEPLAB = ("Resnet101", "Resnet50", "MobileNet")


class Placeholder:
    """Stands in for an object of a class the loader does not build: it
    keeps the arguments and state the pickle gave it, and does nothing."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


def load_pickle(path) -> object:
    """``torch.load`` of ``path`` under the rule of this module's
    docstring (on the CPU)."""
    names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
    stubs = [(type(n.rsplit(".", 1)[-1], (Placeholder,), {}), n)
             for n in names]
    with torch.serialization.safe_globals(stubs):
        return torch.load(path, map_location="cpu", weights_only=True)


def strip_prefixes(sd: Mapping, net_name: str) -> dict:
    """The wrappers' ``custom_load`` prefix rewrites."""
    if net_name == "MobileNet":
        return {k.replace("module", "model", 1) if k.startswith("module")
                else k: v for k, v in sd.items()}
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def is_reference_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and "model_state_dict" in obj


def reference_state_dict(ckpt: Mapping, net_name: str) -> dict:
    """A loaded reference checkpoint (or a bare state dict) -> the port's
    state dict of ``net_name``; raises ``ValueError`` for a net the JAX
    package has no reference importer for."""
    if net_name not in REFERENCE_NETS:
        raise ValueError(f"no importer for net {net_name!r}")
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    sd = strip_prefixes(sd, net_name)
    if net_name in _DEEPLAB:
        sd = {k[len("model."):] if k.startswith("model.") else k: v
              for k, v in sd.items()}
    return sd

