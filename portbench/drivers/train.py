"""The chunked-training driver: ``Trainer.train``'s inner loop, driven
from the program's own pieces in its order.

Parameters (the mix's file): ``scene`` [H, W, C] and ``scenes`` (the
synthetic GID15 scenes written at set-up into the run's temporary
directory: uncompressed TIFF images, PNG index masks of blocky regions of
every class, ``mask_block`` pixels a side), ``chunk_size``,
``patch_size``, ``batch_size``, ``augmentation`` (the recipe key:
``"fused"`` or ``true``), ``first_steps`` (the steps of set-up, which the
check follows), ``loss``, ``opt``.

The loaders, model, loss and optimizer are built by
``cvcs_tpu_torch.cli.train.build_trainer`` from the recipe's keys, and
the weights are then replaced by the benchmark's. Set-up runs the first
epoch's shuffle, ``get_chunk(0)`` and the first steps through
``train.step.train_step`` on the chunk's first batches; the window goes
on from there: each chunk is ``ChunkLoader.get_chunk`` (its next chunk
prefetched on the host tier), ``DeviceChunk.batches``, a
``train_step`` a batch, and the losses of the chunk before read by
``Trainer._harvest``; epochs cycle over the chunks, each opened by the
learning rate's epoch and a shuffle, as the Trainer does. Validation and
checkpoints are not in the window. No step starts after ``--seconds``;
the window ends on a synchronise after the last step, and the rate
counts the patches of every step in it.

The check (after the window): the reference works out the set-up
steps' patches and masks again from the raw scenes (shifted crops and
augmentation: ``image_diff``, the largest difference in levels, and
``mask_diff``, the mask pixels that differ), then runs the same steps in
float32 on its own patches, from the same weights, and compares each
step's loss (``loss_gap``, relative), the norm of each leaf's first
gradient (``grad_gap``) and of each leaf's change over the steps
(``update_gap``), each as the worst leaf's gap between the two norms
over the larger of the reference leaf's norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias ahead of a BatchNorm, which the normalisation cancels) are
left out of both: what the program gives them is rounding.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench import flops, tracing
from portbench.reference import loader as ref_loader
from portbench.reference import ops, steps as ref_steps
from portbench.weights import generator, load_into

IMAGE_DIR, MASK_DIR = "Image__8bit_NirRGB", "Annotation__index"


def make_scenes(b, root: Path) -> tuple[list, list]:
    """The training scenes, made on the device from the seed and written
    as GID15 lays them out: (images, masks) as host arrays."""
    t = b.traffic
    h, w, c = t["scene"]
    blk = t["mask_block"]
    nc = b.cfg["num_classes"]
    gen = generator(b.seed, "scenes", b.device)
    images, masks = [], []
    for _ in range(t["scenes"]):
        lab = torch.randint(0, nc, (h // blk + 1, w // blk + 1),
                            generator=gen, device=b.device, dtype=torch.uint8)
        lab = lab.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:h, :w]
        # imagery that follows the labels a little, with texture
        tone = torch.randint(0, 192, (nc, c), generator=gen, device=b.device,
                             dtype=torch.uint8)
        img = tone[lab.long()] + torch.randint(
            0, 64, (h, w, c), generator=gen, device=b.device,
            dtype=torch.uint8)
        images.append(img.cpu().numpy())
        masks.append(lab.cpu().numpy())
    (root / IMAGE_DIR).mkdir(parents=True)
    (root / MASK_DIR).mkdir()

    def write(i):
        from PIL import Image

        Image.fromarray(images[i]).save(root / IMAGE_DIR / f"s{i}.tif")
        Image.fromarray(masks[i]).save(root / MASK_DIR / f"s{i}_15label.png",
                                       compress_level=1)

    with ThreadPoolExecutor(len(images)) as pool:
        list(pool.map(write, range(len(images))))
    return images, masks


def _recipe(b, root: Path) -> dict:
    t = b.traffic
    config = {"train": str(root), "validation": str(root), "net": b.cfg["net"],
              "epochs": 1 << 30, "chunk_size": t["chunk_size"],
              "patch_size": t["patch_size"], "batch_size": t["batch_size"],
              "loss": t["loss"], "opt": t["opt"], "ignore_background": True,
              "random_shift": True, "augmentation": t["augmentation"],
              "precision": b.cfg["precision"],
              "num_classes": b.cfg["num_classes"] - 1,
              "checkpoint_directory": str(root / "checkpoints"),
              "seed": b.seed}
    if b.device.type == "cpu":
        config["device"] = "cpu"
    return config


def _step(b, state, batch):
    from cvcs_tpu_torch.train import step as step_lib

    tr = state["trainer"]
    with b.spans.timed("step"):
        return step_lib.train_step(tr.state, tr.loss_fn, batch.image,
                                   batch.mask, accum=1, update_stats=True,
                                   context=None, mesh=None, sharded=False,
                                   rows=False)


def first_grad_norms(opt, params: dict, w0: dict) -> dict:
    """Each leaf's first gradient as SGD got it, from its state after one
    step: the momentum buffer less the weight decay of the starting
    weights (no buffer: the optimizer got nothing, a norm of 0)."""
    wd = opt.param_groups[0]["weight_decay"]
    out = {}
    for k, p in params.items():
        buf = opt.state[p].get("momentum_buffer")
        out[k] = (0.0 if buf is None else
                  float(torch.linalg.vector_norm(buf - wd * w0[k])))
    return out


def setup(b):
    from cvcs_tpu_torch.cli.train import build_trainer

    t = b.traffic
    root = Path(tempfile.mkdtemp(prefix="portbench-"))
    state = {"root": root}
    try:
        state["images"], state["masks"] = make_scenes(b, root)
        tr = build_trainer(_recipe(b, root))
        state["trainer"] = tr
        w0 = b.weights()
        load_into(tr.state.model, w0)
        loader, bs = tr.train_loader, t["batch_size"]
        state.update(epoch=0, chunk=0)
        tr.state.optimizer.set_epoch(0)
        loader.shuffle()
        chunk = loader.get_chunk(0, tr.config.random_tps)
        batches = chunk.batches(bs, drop_last=False, pad_tail=False)
        losses, seen = [], []
        params = dict(tr.state.model.named_parameters())
        opt = tr.state.optimizer.opt
        for i in range(t["first_steps"]):
            batch = next(batches)
            seen.append((batch.image.cpu(), batch.mask.cpu()))
            losses.append(_step(b, state, batch))
            if i == 0:
                state["grad_norms"] = first_grad_norms(opt, params, w0)
        state["update_norms"] = {
            k: float(torch.linalg.vector_norm(p.detach() - w0[k]))
            for k, p in params.items()}
        state["first_losses"] = [float(v) for v in losses]
        state["seen"] = seen
        state["batches"], state["chunk_losses"] = batches, losses
        state["live"] = chunk
        if b.device.type == "cuda":
            torch.cuda.synchronize()
        return state
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def window(b, state) -> dict:
    from cvcs_tpu_torch.ops import augment, swin_attn

    tr = state["trainer"]
    loader = tr.train_loader
    bs = b.traffic["batch_size"]
    batches, chunk_losses = state["batches"], state["chunk_losses"]
    epoch, c = state["epoch"], state["chunk"]
    profile = tracing.Profile(b.device) if b.trace else None
    sub, pending = {}, None
    steps, failed = 0, 0
    b.spans.reset()
    t0 = time.perf_counter()
    while True:
        stop = False
        for batch in batches:
            if time.perf_counter() - t0 >= b.seconds:
                stop = True
                break
            chunk_losses.append(_step(b, state, batch))
            steps += 1
        if stop or time.perf_counter() - t0 >= b.seconds:
            break
        if pending is not None:
            with b.spans.span("harvest"):
                failed += _harvest(tr, pending, epoch)
        pending, chunk_losses = chunk_losses, []
        if "steps" not in sub and "k1_before" in sub:
            _close(b, profile, sub, steps, swin_attn, augment)
        c += 1
        if c == len(loader):
            epoch, c = epoch + 1, 0
            with b.spans.span("epoch"):
                tr.state.optimizer.set_epoch(epoch)
                loader.shuffle()
        if profile is not None and "k1_before" not in sub:
            _open(b, profile, sub, steps, swin_attn, augment)
        with b.spans.span("get_chunk"):
            chunk = loader.get_chunk(c, tr.config.random_tps)
        batches = chunk.batches(bs, drop_last=False, pad_tail=False)
    if b.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if "k1_before" in sub and "steps" not in sub:
        _close(b, profile, sub, steps, swin_attn, augment)
    for losses in (pending, chunk_losses):
        if losses:
            failed += _harvest(tr, losses, epoch)
    record = {"sub": sub, "trace": None, "profiler_s": 0.0}
    if "steps" in sub:
        record["trace"] = profile.reduce()
        record["profiler_s"] = profile.own_s
    patches = steps * bs
    return {"t0": t0, "t1": t1, "units": patches, "attempted": steps,
            "failed": failed,
            "e2e": {"train_patches_per_s": patches / (t1 - t0)},
            "record": record}


def _open(b, profile, sub, steps, swin_attn, augment) -> None:
    """Open the traced sub-window: one chunk's cycle (get_chunk, its
    steps, the harvest of the chunk before), from an idle device."""
    if b.device.type == "cuda":
        torch.cuda.synchronize()
    sub.update(k1_before=swin_attn.launches, k2_before=swin_attn.bwd_launches,
               k5_before=augment.launches, steps_before=steps)
    profile.start()


def _close(b, profile, sub, steps, swin_attn, augment) -> None:
    if b.device.type == "cuda":
        torch.cuda.synchronize()
    profile.stop()
    sub.update(steps=steps - sub["steps_before"],
               k1=swin_attn.launches - sub["k1_before"],
               k2=swin_attn.bwd_launches - sub["k2_before"],
               k5=augment.launches - sub["k5_before"])


def _harvest(tr, losses, epoch) -> int:
    """The Trainer's read of a chunk's losses; a non-finite one counts as
    a failed step instead of ending the run."""
    try:
        tr._harvest(losses, epoch)
        return 0
    except FloatingPointError:
        return sum(1 for v in torch.stack(losses).cpu().tolist()
                   if not np.isfinite(v))


def release(b, state) -> None:
    for key in ("trainer", "batches", "chunk_losses", "live"):
        state.pop(key, None)
    if b.device.type == "cuda":
        torch.cuda.empty_cache()


def flops_per_unit(b) -> float:
    t = b.traffic
    p, bs = t["patch_size"], t["batch_size"]
    return flops.count(b.ref, b.cfg, (bs, p, p, b.cfg["in_channels"]),
                       train=True) / bs


def _preset(b) -> str:
    return "fused" if b.traffic["augmentation"] == "fused" else "recipe"


def reference_run(b, state, prec: str = "f32"):
    """The reference's patches of the set-up steps and its steps on
    them: (images, masks, losses, first gradients, parameters after)."""
    t = b.traffic
    n = t["first_steps"] * t["batch_size"]
    images, masks = ref_loader.chunk_patches(
        state["images"], state["masks"], b.seed, t["patch_size"],
        t["chunk_size"], n, _preset(b), b.device)
    class_w = torch.from_numpy(ref_steps.class_weights(
        state["masks"], b.cfg["num_classes"])).to(b.device)
    bs = t["batch_size"]
    batches = [(images[i:i + bs], masks[i:i + bs]) for i in range(0, n, bs)]
    with ops.exact():
        losses, grads, after = ref_steps.train_steps(
            b.ref, b.cfg, b.weights(), batches, class_w, prec)
    return images, masks, losses, grads, after


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog norm - ref norm| over max(ref norm, the median
    leaf's ref norm), for the leaves in ``keep`` (all: None)."""
    median = float(np.median([ref[k] for k in ref]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref if keep is None or k in keep}


def reference_norms(b, ref_run):
    """(first-gradient norms, update norms, the leaves the update counts)
    of the reference's steps."""
    _, _, _, grads, after = ref_run
    w0 = b.weights()
    g_ref = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    u_ref = {k: float(torch.linalg.vector_norm(after[k] - w0[k]))
             for k in after}
    median_g = float(np.median(list(g_ref.values())))
    moved = {k for k, v in g_ref.items() if v >= 1e-3 * median_g}
    return g_ref, u_ref, moved


def compare(b, state, ref_run, detail: dict | None = None) -> dict:
    images, masks, losses, _, _ = ref_run
    g_ref, u_ref, moved = reference_norms(b, ref_run)
    grad = leaf_gaps(state["grad_norms"], g_ref, moved)
    update = leaf_gaps(state["update_norms"], u_ref, moved)
    if detail is not None:
        detail.update(grad=grad, update=update, g_ref=g_ref, u_ref=u_ref,
                      g_prog=state["grad_norms"],
                      u_prog=state["update_norms"],
                      losses=[state["first_losses"], losses])
    p_img = torch.cat([i for i, _ in state["seen"]]).to(b.device)
    p_msk = torch.cat([m for _, m in state["seen"]]).to(b.device).long()
    return {
        "image_diff": float((p_img.int() - images.int()).abs().max()),
        "mask_diff": float((p_msk != masks).sum()),
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(state["first_losses"], losses)),
        "grad_gap": max(grad.values()),
        "update_gap": max(update.values()),
    }


@torch.no_grad()
def check(b, state, rec, detail: dict | None = None) -> dict:
    try:
        with torch.enable_grad():
            return compare(b, state, reference_run(b, state), detail)
    finally:
        shutil.rmtree(state["root"], ignore_errors=True)
