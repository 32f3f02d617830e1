"""lvt_tpu_torch perception (kernel A's plain version, corner selection,
BRIEF from patches, subpixel refinement, patch-mode extraction) against
lvt_tpu on the same numpy inputs.

Tolerance: none. Every output compared here is bit-equal — the uint8
score maps are exact integers in both packages, selection and descriptors
are integer or boolean, and subpixel refinement is the same handful of f32
operations in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract as jx_extract
from lvt_tpu.io.synthetic import TexturedWorld
from lvt_tpu.ops import brief as jx_brief
from lvt_tpu.ops import detect as jx_detect
from lvt_tpu.ops.perception_pallas import perception_patch_maps_batched
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.ops import brief, detect, perception
from test_torch_system import share_the_cores  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _uint8_frames(rs, b=2, h=96, w=256):
    """Smooth-ish uint8 frames: blurred noise has real FAST corners."""
    import cv2

    base = rs.uniform(0, 255, (b, h, w)).astype(np.float32)
    return np.stack([cv2.GaussianBlur(x, (0, 0), 1.2) for x in base]
                    ).round().clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frames():
    return _uint8_frames(np.random.RandomState(5))


@pytest.fixture(scope="module")
def port_maps(frames):
    return [x.numpy() for x in perception.perception_patch_maps_batched(
        torch.from_numpy(frames))]


def test_brief_pattern_matches_lvt_tpu():
    np.testing.assert_array_equal(brief.test_pattern(), jx_brief.test_pattern())
    np.testing.assert_array_equal(brief.sample_pool(), jx_brief.sample_pool())
    np.testing.assert_array_equal(brief.pair_indices(),
                                  jx_brief.pair_indices())
    assert brief.BORDER == jx_brief.BORDER


def test_kernel_a_plain_matches_pallas_interpret(frames, port_maps):
    """Kernel A's plain version vs the Pallas kernel in interpret mode,
    cropped to the true image: nms, raw and smooth bit-equal."""
    b, h, w = frames.shape
    want = perception_patch_maps_batched(jnp.asarray(frames), interpret=True)
    for name, got, ref in zip(("nms", "raw", "smooth"), port_maps, want):
        np.testing.assert_array_equal(got, np.asarray(ref)[:, :h, :w],
                                      err_msg=name)
    assert (port_maps[0] > 0).sum() > 100  # real corners survived NMS


def _pallas_a(imgs):
    """lvt_tpu's kernel A in interpret mode, cropped to the true image."""
    b, h, w = imgs.shape
    return [np.asarray(m)[:, :h, :w] for m in perception_patch_maps_batched(
        jnp.asarray(imgs), interpret=True)]


def test_kernel_a_plain_matches_pallas_on_non_integer_float_frames():
    """ROADMAP H4: float frames that are not integers. The port sums the
    9x9 box in the Pallas kernel's order (rows +d then -d, then columns),
    and the FAST score and NMS are subtractions, min, max and compares of
    the same operands, so nms, raw and smooth are bit-equal (no
    tolerance)."""
    imgs = (np.random.RandomState(9).rand(2, 70, 131) * 255).astype(np.float32)
    got = perception.perception_plain(torch.from_numpy(imgs))
    for name, g, want in zip(("nms", "raw", "smooth"), got, _pallas_a(imgs)):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
    assert (got[0] > 0).sum() > 50
    assert not np.array_equal(got[2].numpy(), np.round(got[2].numpy()))


@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 70, 131), (3, 5, 6),
                                   (1, 9, 66)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_kernel_a_plain_matches_pallas_at_ragged_shapes(shape, dtype):
    """Kernel A's plain version against the Pallas kernel in interpret
    mode at shapes the CUDA kernel's 64x32 tiles and 4-pixel groups cut
    raggedly: widths 1, 2 and 3 past a multiple of 4, heights not a
    multiple of 32, an image smaller than the 4-px halo, batch 1-3;
    uint8 and non-integer float32 frames, bit-equal."""
    rs = np.random.RandomState(sum(shape))
    imgs = (_uint8_frames(rs, *shape) if min(shape[1:]) > 8 and dtype == "uint8"
            else rs.randint(0, 256, shape).astype(np.uint8))
    if dtype == "float32":
        imgs = imgs + rs.rand(*shape).astype(np.float32)
    got = perception.perception_plain(torch.from_numpy(imgs))
    for name, g, want in zip(("nms", "raw", "smooth"), got, _pallas_a(imgs)):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


def test_kernel_a_plain_matches_unfused_detector(frames, port_maps):
    nms, raw, _ = port_maps
    for i, img in enumerate(frames):
        ref_raw = jx_detect.fast_score_map(jnp.asarray(img, jnp.float32))
        np.testing.assert_array_equal(raw[i], np.asarray(ref_raw))
        np.testing.assert_array_equal(
            nms[i], np.asarray(jx_detect.nms3x3(ref_raw)))


def test_fast_score_and_nms_match_lvt_tpu_on_float_input():
    """detect.fast_score_map / nms3x3 on non-integer frames, and NMS on a
    score map whose border is not zero (the edge counts as -inf)."""
    rs = np.random.RandomState(8)
    img = (rs.rand(1, 50, 70) * 255).astype(np.float32)
    got = detect.fast_score_map(torch.from_numpy(img))
    want = jx_detect.fast_score_map(jnp.asarray(img[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    score = rs.randint(0, 4, (1, 30, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        detect.nms3x3(torch.from_numpy(score))[0].numpy(),
        np.asarray(jx_detect.nms3x3(jnp.asarray(score[0]))))


def test_kernel_a_plain_float_frames(frames):
    """Float frames compute in f32 with the kernel's summation order; on
    integer-valued input every sum is exact, so they match uint8."""
    got = perception.perception_patch_maps_batched(
        torch.from_numpy(frames.astype(np.float32)))
    want = perception.perception_patch_maps_batched(torch.from_numpy(frames))
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_top_k_tie_order_lowest_index_first():
    """ROADMAP H1: among equal values the lowest index comes first, as in
    lax.top_k / approx_max_k; torch.topk alone gives [1, 3] here."""
    row = [1.0, 2.0, 2.0, 2.0, 0.0]
    vals, idx = detect.top_k_lowest_index_first(torch.tensor([row]), 2)
    _, jidx = jax.lax.top_k(jnp.asarray([row]), 2)
    assert idx.tolist() == [[1, 2]] == np.asarray(jidx).tolist()
    assert vals.tolist() == [[2.0, 2.0]]


def test_top_k_tie_order_wide_integer_rows():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 6, (3, 5000)).astype(np.float32)
    _, idx = detect.top_k_lowest_index_first(torch.from_numpy(x), 150)
    _, jidx = jax.lax.top_k(jnp.asarray(x), 150)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def _select_both(nms, spread_ties, h, w, threshold=10.0, cell=64, per_cell=24):
    kw = dict(cell_size=cell, max_per_cell=per_cell, corners_low_threshold=200)
    got = detect.select_corners(torch.from_numpy(nms), threshold,
                                img_hw=(h, w), spread_ties=spread_ties, **kw)
    want = jax.vmap(lambda n: jx_detect.select_corners(
        n, n, threshold, subpixel=False, img_hw=(h, w),
        spread_ties=spread_ties, **kw))(jnp.asarray(nms))
    return got, want


def _assert_selection_equal(got, want):
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.kp_int.numpy()[v],
                                  np.asarray(want.kp_int)[v])
    np.testing.assert_array_equal(got.score.numpy()[v],
                                  np.asarray(want.score)[v])
    np.testing.assert_array_equal(got.threshold_used.numpy(),
                                  np.asarray(want.threshold_used))
    assert v.sum() > 0


def test_select_corners_matches_lvt_tpu(frames, port_maps):
    b, h, w = frames.shape
    got, want = _select_both(port_maps[0], True, h, w)
    _assert_selection_equal(got, want)


@pytest.mark.parametrize("spread_ties", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_select_corners_ties(spread_ties):
    """A plateau: whole rows of equal scores, more than a cell can keep.
    With the dither (uint8 frames) the ties are ranked by position; without
    it (float frames) the lowest index wins, as in lax.top_k."""
    h, w = 64, 128
    nms = np.zeros((1, h, w), np.float32)
    nms[0, 8:56:4, 8:120:2] = 40.0
    nms[0, 10:50:8, 9:100:6] = 55.0
    if not spread_ties:
        nms[0, 30, 30:90:3] = 40.5   # a sub-unit score step only floats have
    got, want = _select_both(nms, spread_ties, h, w, threshold=20.0)
    _assert_selection_equal(got, want)


def test_descriptors_and_subpixel_from_patches_match_lvt_tpu():
    rs = np.random.RandomState(1)
    k, h, w = 300, 120, 200
    # integer-valued patches: equal pool samples are common, so the strict
    # ``<`` of every bit is exercised on ties
    patches = rs.randint(0, 8, (k, 32, 32)).astype(np.float32)
    x = rs.randint(0, w, k).astype(np.int32)
    y = rs.randint(0, h, k).astype(np.int32)
    valid = rs.rand(k) > 0.2
    d_got, v_got = brief.descriptors_from_patches(
        _t(patches), _t(x), _t(y), _t(valid), h, w)
    d_ref, v_ref = jx_brief.descriptors_from_patches(
        jnp.asarray(patches), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(valid), h, w)
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(d_got.numpy().view(np.uint32),
                                  np.asarray(d_ref))
    assert v_got.sum() > 50

    rawp = rs.uniform(0, 60, (k, 8, 8)).astype(np.float32)
    rawp[: k // 4] = 30.0          # flat: the denominator guard
    rawp[k // 4: k // 2, 3, 3] = rawp[k // 4: k // 2, 3, 5]
    xs_got, ys_got = detect.subpixel_from_patches(_t(rawp), _t(x), _t(y))
    xs_ref, ys_ref = jx_detect.subpixel_from_patches(
        jnp.asarray(rawp), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(xs_got.numpy(), np.asarray(xs_ref))
    np.testing.assert_array_equal(ys_got.numpy(), np.asarray(ys_ref))


def _textured_frames(n=2):
    world = TexturedWorld(width=256, height=128, fx=200.0, fy=200.0,
                          cx=128.0, cy=64.0, baseline=0.3)
    imgs = []
    for left, right, _ in world.stereo_sequence(n, speed=0.5):
        imgs += [left.astype(np.uint8), right.astype(np.uint8)]
    return world, np.stack(imgs)


def test_patch_mode_extraction_matches_lvt_tpu():
    """The whole patch-mode extraction on uint8 TexturedWorld frames: valid
    equal; kp, desc (through the uint32 view) and score bit-equal at valid
    slots."""
    world, imgs = _textured_frames()
    cfg = VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=64,
        max_keypoints_per_cell=32, descriptor_mode="patch",
        use_pallas_perception=False, use_pallas_matching=False,
        use_mxu_hamming=False)
    want = jx_extract.extract_features_batched(jnp.asarray(imgs), cfg)
    got = extract.extract_features_batched(torch.from_numpy(imgs), cfg)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() > 100
    np.testing.assert_array_equal(got.kp.numpy()[v], np.asarray(want.kp)[v])
    np.testing.assert_array_equal(got.desc.numpy().view(np.uint32)[v],
                                  np.asarray(want.desc)[v])
    np.testing.assert_array_equal(got.score.numpy()[v],
                                  np.asarray(want.score)[v])
    assert got.kp.shape == (imgs.shape[0], cfg.kp_capacity, 2)


def test_stereo_split_matches_batched():
    _, imgs = _textured_frames(1)
    world_cfg = VOConfig(fx=200.0, fy=200.0, cx=128.0, cy=64.0, baseline=0.3,
                         img_width=256, img_height=128, detection_cell_size=64,
                         max_keypoints_per_cell=32)
    t = torch.from_numpy(imgs)
    left, right = extract.extract_features_stereo(t[0], t[1], world_cfg)
    both = extract.extract_features_batched(t, world_cfg)
    for i, side in enumerate((left, right)):
        for a, b in zip(side, both):
            assert torch.equal(a, b[i])


def test_spread_ties_follows_frame_dtype():
    assert extract._spread_ties(torch.zeros(1, 4, 4, dtype=torch.uint8))
    assert not extract._spread_ties(torch.zeros(1, 4, 4))
