"""forward_ms.scene: mean device milliseconds a call of the model
callable takes (CUDA events around each call of the window)."""


def read(r):
    ms = r["device_ms"].get("forward")
    return sum(ms) / len(ms) if ms else None
