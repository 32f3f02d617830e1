"""lvt_tpu_torch patch extraction (the patch kernel's plain version)
against lvt_tpu's Pallas patch kernel in interpret mode and its XLA
reference, on the same numpy inputs.

Tolerance: none — patches are copies of map values, so they are
bit-equal, and invalid slots are zero in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.ops import patches_pallas as jx_pt
from lvt_tpu_torch.ops import patches as pt


def _setup(k, seed=7, h=96, w=256):
    rs = np.random.RandomState(seed)
    smooth = (rs.rand(2, h, w) * 20000.0).astype(np.float32)
    raw = (rs.rand(2, h, w) * 100.0).astype(np.float32)
    # keypoints anywhere, including off-image garbage: clamp_coords keeps
    # every read inside the maps
    x = rs.randint(-5, w + 5, (2, k)).astype(np.int32)
    y = rs.randint(-5, h + 5, (2, k)).astype(np.int32)
    valid = rs.rand(2, k) > 0.3
    return smooth, raw, x, y, valid


@pytest.mark.parametrize("k", [128, 200], ids=["k128", "k200-not-128-aligned"])
def test_patches_match_pallas_kernel_and_xla(k):
    smooth, raw, x, y, valid = _setup(k)
    h, w = smooth.shape[1:]
    xc, yc = pt.clamp_coords(torch.from_numpy(x), torch.from_numpy(y), h, w)
    jxc, jyc = jx_pt.clamp_coords(jnp.asarray(x), jnp.asarray(y), h, w)
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jxc))
    np.testing.assert_array_equal(yc.numpy(), np.asarray(jyc))

    got = pt.extract_patches_batched(
        torch.from_numpy(smooth), torch.from_numpy(raw), xc, yc,
        torch.from_numpy(valid))
    args = (jnp.asarray(smooth), jnp.asarray(raw), jxc, jyc,
            jnp.asarray(valid))
    kern = jx_pt.extract_patches_batched(*args, interpret=True)
    xla = jx_pt.extract_patches_xla(*args)
    for g, kr, xr, shape in zip(got, kern, xla, ((32, 32), (8, 8))):
        assert g.shape == (2, k) + shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(kr)[:, :k])
        np.testing.assert_array_equal(g.numpy(), np.asarray(xr))
    assert not got[0].numpy()[~valid].any()


def test_patch_window_geometry():
    """The smooth patch's (15, 16) and the raw patch's (3, 4) entries are
    the keypoint's own pixel."""
    smooth, raw, x, y, valid = _setup(64, seed=3)
    h, w = smooth.shape[1:]
    x = np.clip(x, 16, w - 16)
    y = np.clip(y, 15, h - 17)
    valid[:] = True
    p, r = pt.extract_patches_batched(*map(torch.from_numpy,
                                           (smooth, raw, x, y, valid)))
    b = np.arange(2)[:, None]
    np.testing.assert_array_equal(p[:, :, 15, 16].numpy(), smooth[b, y, x])
    np.testing.assert_array_equal(r[:, :, 3, 4].numpy(), raw[b, y, x])


def test_wrapper_counts_only_kernel_launches():
    """On the CPU the wrapper takes the plain version and launches nothing."""
    smooth, raw, x, y, valid = _setup(16)
    before = pt.extract_patches_batched.launches
    pt.extract_patches_batched(*map(torch.from_numpy,
                                    (smooth, raw, x, y, valid)))
    assert pt.extract_patches_batched.launches == before
