"""PyTorch / CUDA port of :mod:`cvcs_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package runs beside it and
imports neither ``jax`` nor anything of ``cvcs_tpu``. Entry points run on
``cuda`` unless the caller asks for the CPU (``device="cpu"``, or
``device: cpu`` in a config), and raise when no card is present rather
than running on the CPU unasked.

Ported so far: the whole model zoo and every single-device entry point
(``cli.train``, ``cli.evaluate``, ``cli.predict``, ``cli.serve``,
``cli.esa``, ``cli.retrieve``, ``cli.export``), with the Swin fused
window-attention forward and backward (``ops.swin_attn``), the fused
augmentation (``ops.augment``) and the fused weighted cross-entropy
(``ops.fused_ce``) as hand-written CUDA kernels, and the (data,
spatial) mesh of ranks on ``torch.distributed`` (``core.mesh``,
``parallel.halo``) for the sharded scene paths and data-parallel
training, and the host decode and encode tier (``native``) as a C++
library of the port's own, built with ``g++`` at first use. ROADMAP.md
lists what is still to port.
"""
