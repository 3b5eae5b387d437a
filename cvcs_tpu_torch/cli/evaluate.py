"""``python -m cvcs_tpu_torch.cli.evaluate <config.yaml>`` (port of
``cvcs_tpu/cli/evaluate.py``, the reference's ``evaluation.py``): the
confusion-matrix evaluation of a checkpoint over a dataset at chunk size
1 with no shift, the metric tables, and the optional confusion-heatmap
(``confusion_matrix: <path>``) and class-prior (``priors: <path>``)
plots.

``load_checkpoint`` takes what ``cli/common.py`` ``restore_variables``
takes: a train checkpoint of the port (``checkpointN/`` or its
``state.pt``), a port state dict, an Orbax ``checkpointN/`` of the JAX
package, an ``.npz`` of JAX variables, or a reference ``torch.save``
pickle. ``load_context`` loads context windows, which reach a net whose
spec sets ``requires_context``.
``net: Ensemble`` with ``ensemble_config`` (a map of net name ->
checkpoint) evaluates the members' majority vote, whose labels are used
as they come. Runs on the card unless the config says ``device: cpu``.
``mesh`` raises, naming its ROADMAP item.
"""

from __future__ import annotations

import sys

import torch

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import EVAL_KEYS, validate_keys
from cvcs_tpu_torch.data.loader import ChunkLoader
from cvcs_tpu_torch.metrics import confusion as conf_lib
from cvcs_tpu_torch.metrics import scores
from cvcs_tpu_torch.train.step import forward


def evaluate(config: dict) -> dict:
    """Evaluate ``config``'s net over its dataset; print the tables and
    return the metric dict (``print_metrics``')."""
    validate_keys(config, EVAL_KEYS, {"dataset", "net", "patch_size"},
                  "evaluation")
    common.reject_unported(config)
    device = common.device_context(config)
    loader = ChunkLoader(
        config["dataset"], chunk_size=1, patch_size=config["patch_size"],
        load_context=bool(config.get("load_context")),
        in_channels=int(config.get("in_channels", 3)), seed=0,
        device=device)
    if config.get("images"):
        loader.specify(config["images"])

    num_classes = int(config.get("num_classes", 15)) + 1
    batch_size = int(config.get("batch_size", 8))
    ignore = 0 if config.get("ignore_background") else None
    model, spec, _ = common.build_apply(config, device)

    host = conf_lib.HostConfusion(num_classes)
    with torch.inference_mode():
        for c in range(len(loader)):
            chunk = loader.get_chunk(c, shuffle_patches=False)
            conf = conf_lib.confusion_matrix(num_classes, device)
            for batch in chunk.batches(batch_size, drop_last=False):
                ctx = batch.context if spec.requires_context else None
                pred = forward(model, batch.image.to(torch.float32), ctx)
                if spec.returns_logits:
                    pred = pred.argmax(-1)
                mask = batch.mask
                if batch.valid is not None:
                    # padding samples: an out-of-range target drops them
                    mask = torch.where(batch.valid[:, None, None], mask,
                                       num_classes + 1)
                conf_lib.update_confusion(conf, pred.to(torch.int32), mask,
                                          num_classes, ignore)
            host.fold(conf)

    metrics = scores.print_metrics(host.total)
    if config.get("confusion_matrix"):
        from cvcs_tpu_torch.metrics.plots import plot_confusion

        plot_confusion(host.normalized(), config["confusion_matrix"])
    if config.get("priors"):
        from cvcs_tpu_torch.metrics.plots import plot_priors

        plot_priors(host.total, config["priors"])
    return metrics


def main(argv=None) -> int:
    evaluate(common.resolve_config_arg(argv or sys.argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
