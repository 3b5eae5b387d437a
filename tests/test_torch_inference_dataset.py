"""Port ``InferenceDataset`` (the reference's per-patch ``GID15`` view)
against the JAX package's on the same synthetic GID15 root: the length
and, for indices across scenes (and back, through the single-scene
cache), the patch, the index mask and the border-corrected padded patch
must be equal (uint8, exact), centered, with ``bug_parity`` and with
``random_shift`` (both draw from ``np.random.default_rng(seed)`` in the
same order). With ``load_context=True`` the context windows (3p
resized to p on the CPU) agree with the JAX package's within one level,
on all but a stated share of the values.
"""

import numpy as np
import pytest

from cvcs_tpu.data.inference_dataset import InferenceDataset as JaxDataset
from cvcs_tpu_torch.data.inference_dataset import InferenceDataset

P = 32
INDICES = [0, 5, 11, 12, 23, 3, 47]      # 12 tiles a scene, 4 scenes


@pytest.mark.parametrize("kw", [
    dict(border_correction=None),
    dict(border_correction=64),
    dict(border_correction=64, bug_parity=True),
    dict(border_correction=48, random_shift=True, seed=3),
], ids=["no_bc", "bc64", "bc64_bug_parity", "bc48_random_shift"])
def test_items_equal_jax(gid15_root, kw):
    ds = InferenceDataset(str(gid15_root), patch_size=P, **kw)
    ref = JaxDataset(str(gid15_root), patch_size=P, load_context=False, **kw)
    assert len(ds) == len(ref) == 48
    for i in INDICES:
        got, want = ds[i], ref[i]
        assert got[2] is None and want[2] is None
        for k in (0, 1, 3):
            if want[k] is None:
                assert got[k] is None
                continue
            assert got[k].dtype == want[k].dtype == np.uint8
            np.testing.assert_array_equal(got[k], want[k])
        assert got[0].shape == (P, P, 3) and got[1].shape == (P, P)


# contexts: at most one level apart, on at most this share of the values
# (0.0093% differed when this was written: the two frameworks' f32
# filters sum in different orders, and a value next to a .5 can round the
# other way)
CONTEXT_OFF_BY_ONE = 0.01


def test_context_request_raises(gid15_root):
    """The context windows that ``load_context=True`` once refused, now
    against JAX's, with ``random_shift`` (corner tiles reach the
    padding) and the rest of each item unchanged."""
    kw = dict(patch_size=P, border_correction=48, random_shift=True, seed=5)
    ds = InferenceDataset(str(gid15_root), load_context=True, **kw)
    ref = JaxDataset(str(gid15_root), load_context=True, **kw)
    off = []
    for i in INDICES:
        got, want = ds[i], ref[i]
        assert got[2].dtype == want[2].dtype == np.uint8
        assert got[2].shape == want[2].shape == (P, P, 3)
        diff = np.abs(got[2].astype(int) - want[2].astype(int))
        assert diff.max() <= 1, i
        off.append((diff > 0).mean())
        for k in (0, 1, 3):
            np.testing.assert_array_equal(got[k], want[k])
    assert np.mean(off) <= CONTEXT_OFF_BY_ONE
