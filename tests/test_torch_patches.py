"""lvt_tpu_torch kernel P's plain version — patch extraction, then BRIEF
and subpixel refinement — against lvt_tpu's Pallas patch kernel in
interpret mode (and its XLA reference) followed by lvt_tpu's
``brief.descriptors_from_patches`` and ``detect.subpixel_from_patches``,
on the same numpy inputs.

Tolerance: none — patches are copies of map values, descriptors are
comparisons, and the refinement is the same handful of f32 operations in
the same order, so every output is bit-equal for every slot, valid or
not; invalid slots are zero in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.io.synthetic import TexturedWorld
from lvt_tpu.ops import brief as jx_brief
from lvt_tpu.ops import detect as jx_detect
from lvt_tpu.ops import patches_pallas as jx_pt
from lvt_tpu.ops.perception_pallas import perception_patch_maps_batched
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

    got = pt.extract_patches_plain(
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
    p, r = pt.extract_patches_plain(*map(torch.from_numpy,
                                         (smooth, raw, x, y, valid)))
    b = np.arange(2)[:, None]
    np.testing.assert_array_equal(p[:, :, 15, 16].numpy(), smooth[b, y, x])
    np.testing.assert_array_equal(r[:, :, 3, 4].numpy(), raw[b, y, x])


def test_wrapper_counts_only_kernel_launches():
    """On the CPU the wrapper takes the plain version and launches nothing."""
    smooth, raw, x, y, valid = _setup(16)
    xc, yc = pt.clamp_coords(torch.from_numpy(x), torch.from_numpy(y),
                             *smooth.shape[1:])
    before = pt.describe_refine_batched.launches
    got = pt.describe_refine_batched(
        torch.from_numpy(smooth), torch.from_numpy(raw), xc, yc,
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid),
        *smooth.shape[1:])
    assert pt.describe_refine_batched.launches == before
    assert [t.shape for t in got] == [(2, 16, 8), (2, 16), (2, 16, 2)]


def _kitti_like_maps(h=96, w=256):
    """A uint8 stereo pair of TexturedWorld frames (dense texture, KITTI-
    like corner density) through lvt_tpu's kernel A in interpret mode ->
    (nms, raw, smooth) [2, h, w] f32 numpy."""
    world = TexturedWorld(width=w, height=h, fx=150.0, fy=150.0, cx=w / 2,
                          cy=h / 2, baseline=0.3)
    left, right, _ = next(world.stereo_sequence(1, speed=0.5))
    imgs = jnp.asarray(np.stack([left, right]).astype(np.uint8))
    maps = perception_patch_maps_batched(imgs, interpret=True)
    return [np.asarray(m)[:, :h, :w].copy() for m in maps]


def test_describe_refine_plain_matches_lvt_tpu_patch_path():
    """Kernel P's plain version against lvt_tpu's patch kernel (interpret)
    -> descriptors_from_patches -> subpixel_from_patches on the maps of a
    uint8 pair, at corners that are selected, unselected, inside the BRIEF
    border, on it, and off the image: desc, valid and kp bit-equal for
    every slot."""
    nms, raw, smooth = _kitti_like_maps()
    h, w = smooth.shape[1:]
    rs = np.random.RandomState(9)
    k = 300
    strong = np.argwhere(nms > 0)                  # real corners first
    pick = strong[rs.choice(len(strong), 2 * 200)].reshape(2, 200, 3)
    x = np.concatenate([pick[..., 2], rs.randint(-5, w + 5, (2, k - 200))],
                       1).astype(np.int32)
    y = np.concatenate([pick[..., 1], rs.randint(-5, h + 5, (2, k - 200))],
                       1).astype(np.int32)
    x[:, :8] = [19, 20, w - 21, w - 20, 0, 5, 30, 40]   # the border's edges
    y[:, :8] = [30, 30, 40, 40, 20, 19, h - 21, h - 20]
    sel = rs.rand(2, k) > 0.2
    xc, yc = pt.clamp_coords(torch.from_numpy(x), torch.from_numpy(y), h, w)
    desc, valid, kp = pt.describe_refine_batched(
        *map(torch.from_numpy, (smooth, raw)), xc, yc,
        *map(torch.from_numpy, (x, y, sel)), h, w)

    jxc, jyc = jnp.asarray(xc.numpy()), jnp.asarray(yc.numpy())
    patches, rawp = jx_pt.extract_patches_batched(
        jnp.asarray(smooth), jnp.asarray(raw), jxc, jyc, jnp.asarray(sel),
        interpret=True)
    refs = []
    for b in range(2):                     # lvt_tpu describes one image
        xb, yb = jnp.asarray(x[b]), jnp.asarray(y[b])
        refs.append((*jx_brief.descriptors_from_patches(
            patches[b, :k], xb, yb, jnp.asarray(sel[b]), h, w),
            *jx_detect.subpixel_from_patches(rawp[b, :k], xb, yb)))
    d_ref, v_ref, xs_ref, ys_ref = (np.stack([np.asarray(r[i]) for r in refs])
                                    for i in range(4))
    np.testing.assert_array_equal(valid.numpy(), v_ref)
    np.testing.assert_array_equal(desc.numpy().view(np.uint32), d_ref)
    np.testing.assert_array_equal(kp[..., 0].numpy(), xs_ref)
    np.testing.assert_array_equal(kp[..., 1].numpy(), ys_ref)
    v = valid.numpy()
    assert 150 < v.sum() < v.size and desc.numpy()[~v].max() == 0
    assert (kp.numpy() != np.stack([x, y], -1)).any(-1)[v].mean() > 0.5
