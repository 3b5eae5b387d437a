"""device_idle.train: share of the traced sub-window in which no kernel,
copy or set runs on the device (one minus the union of their intervals
over the sub-window)."""


def read(r):
    t = r.get("trace")
    if t is None or not t["gpu"] or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
