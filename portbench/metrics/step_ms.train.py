"""step_ms.train: mean device milliseconds of a ``train_step`` of the
window (CUDA events around each call)."""


def read(r):
    ms = r["device_ms"].get("step")
    return sum(ms) / len(ms) if ms else None
