"""engine_ms.scene: device milliseconds a scene spends outside the
model's forwards (upload, pad, window gather, argmax, crop, stitch,
labels back): the kernels, copies and sets of the traced scenes whose
launch was not issued inside a ``forward`` span, over the scenes."""


def read(r):
    t, sub = r.get("trace"), r["sub"]
    if t is None or not t["gpu"] or not sub.get("scenes"):
        return None
    outside = sum(s for _, s, span in t["gpu"] if span != "forward")
    return outside / sub["scenes"] * 1e3
