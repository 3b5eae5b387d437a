"""swin_attn_roofline.scene: the window-attention kernel K1's bound over
its device time in the traced scenes. The bound is the frozen
``k1_bound`` of every call of each traced forward (the Swin stages'
shapes at the forward's batch), scaled to the K1 calls the launch
counter saw; the device time is that of K1's CUDA kernels, by name."""

from portbench.counts import swin_attn_bound_ms, swin_attn_calls
from portbench.tracing import device_seconds

KERNELS = ("swin_attn_fwd_ln", "swin_attn_fwd_gemm", "swin_attn_fwd_core")


def read(r):
    t, sub = r.get("trace"), r["sub"]
    if t is None or not sub.get("forwards"):
        return None
    device = device_seconds(t, *KERNELS)
    if device <= 0:
        return None
    size = r["traffic"]["border_correction"] or r["traffic"]["patch_size"]
    calls = len(swin_attn_calls(r["cfg"], size))
    bound = sum(swin_attn_bound_ms(r["cfg"], size, b) for b in sub["forwards"])
    bound *= sub["k1"] / (calls * len(sub["forwards"]))
    return bound / (device * 1e3) * 100
