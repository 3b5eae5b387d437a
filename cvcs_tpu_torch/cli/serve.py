"""``python -m cvcs_tpu_torch.cli.serve <config.yaml>`` — directory-watching
segmentation service (port of ``cvcs_tpu/cli/serve.py``).

Watches ``watch_dir`` for new rasters (png/jpg/tif), segments each with
the whole-scene engine — same-shape arrivals batch into one multi-scene
pass (``common.segment_rasters``) — and writes ``<stem>_mask.png`` into
``output`` (same-stem sources with different suffixes get suffixed mask
names instead of overwriting). Processed names and per-batch latency are
appended to ``output/manifest.jsonl``, which is also the restart journal:
listed names are never re-processed; a torn final line is skipped and
that raster runs again.

A long-lived daemon outlives bad input: sizes are probed from image
headers and decoding is bounded to ``max_batch`` rasters; a raster that
fails to decode or segment is retried on later polls, and after
``max_retries`` attempts on an UNCHANGED file (size + mtime) it is
journaled with an ``error`` entry and skipped — until the file is
replaced. A batch failure falls back to per-raster runs so one poison pill
cannot block its group. ``settle_s > 0`` ignores files modified within
the last N seconds.

Config keys: ``watch_dir``, ``net`` (``Ensemble`` with
``ensemble_config`` serves a majority vote), ``patch_size`` (default 512),
``load_checkpoint``, ``output`` (default ``<watch_dir>/output``),
``border_correction``, ``batch_tiles``, ``tta``, ``precision``,
``device``, ``poll_s`` (2.0), ``max_batch`` (8), ``max_retries`` (3),
``settle_s`` (0), ``max_polls`` (stop after N scans; default: run until
interrupted). Rasters decode with PIL; ``mesh`` raises (multi-device is
not ported yet).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.config.loader import SERVE_KEYS, validate_keys
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

RASTER_SUFFIXES = {".png", ".jpg", ".jpeg", ".tif", ".tiff"}


def _decode_rgb(f) -> np.ndarray:
    """Raster -> (H, W, 3) uint8; raises on bad input so the caller's
    retry / journal machinery engages."""
    with Image.open(f) as im:
        return np.asarray(im.convert("RGB"))


def _read_journal(manifest) -> tuple[set, dict, dict]:
    """(names already handled, mask-filename claims, error signatures)
    from the journal; repairs a torn final line so the next append does
    not garble a good entry."""
    done = set()
    claimed: dict[str, str] = {}
    error_sigs: dict[str, tuple | None] = {}
    if manifest.exists():
        data = manifest.read_bytes()
        if data and not data.endswith(b"\n"):
            with manifest.open("ab") as mf:
                mf.write(b"\n")
        for line in data.decode(errors="replace").splitlines():
            try:
                entry = json.loads(line)
                done.add(entry["name"])
                if "error" not in entry:
                    mask = entry.get(
                        "mask", f"{entry['name'].rsplit('.', 1)[0]}_mask.png")
                    claimed.setdefault(mask, entry["name"])
                    error_sigs.pop(entry["name"], None)
                else:
                    sig = entry.get("sig")
                    error_sigs[entry["name"]] = (
                        tuple(sig) if isinstance(sig, list) else None)
            except (json.JSONDecodeError, KeyError, TypeError):
                continue  # torn line: re-process that raster
    return done, claimed, error_sigs


def serve(config: dict) -> int:
    """Run the watch loop; returns the number of rasters processed."""
    validate_keys(config, SERVE_KEYS, {"watch_dir", "net"}, "serve")
    common.reject_unported(config)
    device = common.device_context(config)
    Image.MAX_IMAGE_PIXELS = None
    watch = Path(config["watch_dir"])
    out_dir = Path(config.get("output", watch / "output"))
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest = out_dir / "manifest.jsonl"
    done, claimed, error_sigs = _read_journal(manifest)

    p = int(config.get("patch_size", 512))
    model, spec, num_classes = common.build_apply(config, device)
    seg = SceneSegmenter(
        model,
        InferenceConfig(
            patch_size=p,
            border_correction=config.get("border_correction"),
            batch_tiles=int(config.get("batch_tiles", 128)),
            num_classes=num_classes,
            tta=bool(config.get("tta"))),
        returns_logits=spec.returns_logits,
        requires_context=spec.requires_context,
        stride_product=spec.stride_product, device=device)

    poll_s = float(config.get("poll_s", 2.0))
    settle_s = float(config.get("settle_s", 0.0))
    max_batch = max(1, int(config.get("max_batch", 8)))
    max_retries = max(1, int(config.get("max_retries", 3)))
    max_polls = config.get("max_polls")
    failures: dict[str, tuple[int, tuple]] = {}  # name -> (count, sig)
    n_processed = 0
    polls = 0

    def journal(entry: dict) -> None:
        with manifest.open("a") as mf:
            mf.write(json.dumps(entry) + "\n")
        done.add(entry["name"])

    def _sig(f):
        try:
            st = f.stat()
            return (st.st_size, st.st_mtime_ns)
        except OSError:
            return None

    def fail(f, err) -> None:
        # retries count only against an UNCHANGED file: a raster still
        # being copied in keeps changing (size, mtime) and resets the count
        sig = _sig(f)
        prev_n, prev_sig = failures.get(f.name, (0, None))
        if sig is None:
            sig = prev_sig   # vanished: keep the last known signature
        n = prev_n + 1 if sig == prev_sig else 1
        failures[f.name] = (n, sig)
        if n >= max_retries:
            journal({"name": f.name, "error": str(err), "attempts": n,
                     "sig": list(sig) if sig else None})
            error_sigs[f.name] = sig
            failures.pop(f.name, None)
            print(f"giving up on {f.name} after {n} attempts: {err}",
                  flush=True)
        else:
            print(f"failed {f.name} (attempt {n}/{max_retries}, will "
                  f"retry): {err}", flush=True)

    def export(batch, labels, t0) -> None:
        nonlocal n_processed
        labels = common.fetch_labels(labels)
        # write every mask first, journal after: a crash in between must
        # not leave journaled entries whose masks never landed
        masks = []
        for f, lab in zip(batch, labels):
            mask = f"{f.stem}_mask.png"
            if claimed.get(mask, f.name) != f.name:
                # a same-stem sibling (a.png vs a.tif) owns this name
                mask = f"{f.stem}{f.suffix.replace('.', '_')}_mask.png"
            claimed[mask] = f.name
            seg.export_map(lab, out_dir / mask)
            masks.append(mask)
        for f, lab, mask in zip(batch, labels, masks):
            journal({"name": f.name, "mask": mask,
                     "shape": list(lab.shape), "batch": len(batch),
                     "batch_seconds": round(time.time() - t0, 3)})
            failures.pop(f.name, None)
            error_sigs.pop(f.name, None)
            n_processed += 1
            print(f"served {f.name} -> {mask}", flush=True)

    def _settled(f, now):
        try:
            return now - f.stat().st_mtime >= settle_s
        except OSError:
            return False   # vanished between listing and stat

    def _admissible(f) -> bool:
        if f.name not in done:
            return True
        if f.name not in error_sigs:   # success entry: never re-run
            return False
        cur = _sig(f)
        if cur is not None and cur != error_sigs[f.name]:
            # the journaled error was for different content: re-admit
            done.discard(f.name)
            error_sigs.pop(f.name, None)
            print(f"re-admitting replaced {f.name} "
                  "(signature differs from journaled error)", flush=True)
            return True
        return False

    while True:
        now = time.time()
        pending = sorted(
            f for f in watch.iterdir()
            if f.suffix.lower() in RASTER_SUFFIXES and _admissible(f)
            and _settled(f, now))
        # header-only size probe: group same-shape arrivals
        groups: dict[tuple, list] = {}
        for f in pending:
            try:
                with Image.open(f) as im:
                    groups.setdefault(im.size, []).append(f)
            except Exception as err:   # mid-copy / not an image
                fail(f, err)
        for files in groups.values():
            for i in range(0, len(files), max_batch):
                batch, rasters = [], []
                for f in files[i:i + max_batch]:   # decode one batch
                    try:
                        rasters.append(_decode_rgb(f))
                        batch.append(f)
                    except Exception as err:
                        fail(f, err)
                if not batch:
                    continue
                t0 = time.time()
                try:
                    export(batch, common.segment_rasters(seg, rasters), t0)
                except Exception as err:
                    if len(batch) == 1:
                        fail(batch[0], err)
                        continue
                    # isolate the poison pill: run each raster alone
                    for f, r in zip(batch, rasters):
                        if f.name in done:   # exported before the raise
                            continue
                        t1 = time.time()
                        try:
                            export([f], common.segment_rasters(seg, [r]), t1)
                        except Exception as err2:
                            fail(f, err2)
        polls += 1
        if max_polls is not None and polls >= int(max_polls):
            return n_processed
        time.sleep(poll_s)


def main(argv=None) -> int:
    n = serve(common.resolve_config_arg(argv or sys.argv))
    print(f"served {n} rasters", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
