"""lvt_tpu_torch's dense descriptor mode (kernel B's plain version, the
descriptor gather from planes, subpixel refinement on the raw map, and
the whole dense extraction) against lvt_tpu on the same numpy inputs, and
the resolution of ``config.descriptor_mode``.

Tolerances:
  * uint8 frames: none. Raw, NMS and the bit planes are bit-equal to
    lvt_tpu's ``perception_maps_batched`` in interpret mode, except the
    rightmost 15 columns of an image whose width is not a multiple of
    128: there the TPU kernel B reads kernel A's tile padding past the
    right edge (box sums of the zero pad), where the port reads zero. No
    valid descriptor (BORDER = 20) reads there, and at a width that is a
    multiple of 128 the planes are bit-equal everywhere;
  * float frames: planes within the bound of
    tests/test_pallas_perception.py (bit-difference rate under 1e-4 in
    the interior), the box sums being f32;
  * extraction: kp, valid, desc and score bit-equal at valid keypoints.
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
from lvt_tpu.ops import perception_pallas as jx_pp
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.ops import brief, detect, perception
from test_torch_system import share_the_cores  # noqa: F401


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _blurred(rs, b, h, w):
    import cv2

    base = rs.uniform(0, 255, (b, h, w)).astype(np.float32)
    return np.stack([cv2.GaussianBlur(x, (0, 0), 1.2) for x in base])


def _config(world, **kw) -> VOConfig:
    return VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                    baseline=world.baseline, img_width=world.width,
                    img_height=world.height, detection_cell_size=64,
                    max_keypoints_per_cell=32, use_pallas_perception=False,
                    **kw)


@pytest.fixture(scope="module")
def world_frames():
    world = TexturedWorld(width=320, height=128, fx=160.0, fy=160.0,
                          cx=160.0, cy=64.0, baseline=0.3)
    left, right, _ = next(iter(world.stereo_sequence(1, speed=0.5)))
    return world, np.stack([left, right]).astype(np.uint8)


@pytest.mark.parametrize("mode,want", [(None, "patch"), ("patch", "patch"),
                                       ("dense", "dense")])
def test_descriptor_mode_resolution(world_frames, monkeypatch, mode, want):
    """"dense" runs the dense path (kernels A + B), no longer the patch
    path without a word; unset and "patch" run the patch path."""
    world, frames = world_frames
    cfg = _config(world, descriptor_mode=mode)
    assert extract._descriptor_mode(cfg) == want
    calls = []
    real = extract.perception_maps_batched
    monkeypatch.setattr(extract, "perception_maps_batched",
                        lambda imgs: calls.append(1) or real(imgs))
    extract.extract_features_batched(torch.from_numpy(frames), cfg)
    assert calls == ([1] if want == "dense" else [])


@pytest.mark.parametrize("kw", [dict(descriptor_mode="sparse"),
                                dict(use_dense_brief=False),
                                dict(descriptor_mode="bogus")])
def test_unported_descriptor_modes_raise(world_frames, kw):
    """The modes a config can name that the port once refused: "sparse"
    (asked for either way) is ported now, so it resolves as in lvt_tpu,
    its features are lvt_tpu's bit for bit and VOSystem takes it
    (tests/test_torch_sparse.py holds the mode against lvt_tpu); an
    unknown mode still raises ValueError."""
    world, frames = world_frames
    cfg = _config(world, **kw)
    if kw.get("descriptor_mode") == "bogus":
        with pytest.raises(ValueError):
            extract.extract_features_batched(torch.from_numpy(frames), cfg)
        with pytest.raises(ValueError):
            VOSystem(cfg, device="cpu")
        return
    assert extract._descriptor_mode(cfg) == "sparse"
    got = extract.extract_features_batched(torch.from_numpy(frames), cfg)
    want = jx_extract.extract_features_batched(jnp.asarray(frames), cfg)
    for field in ("kp", "desc", "valid", "score"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      _t(getattr(want, field)).numpy(),
                                      err_msg=field)
    VOSystem(cfg, device="cpu")


@pytest.mark.parametrize("h,w", [(120, 200), (120, 256)])
def test_perception_maps_match_pallas_interpret(h, w):
    rs = np.random.RandomState(11)
    imgs = _blurred(rs, 2, h, w).round().clip(0, 255).astype(np.uint8)
    raw, nms, planes = (x.numpy() for x in perception.perception_maps_batched(
        torch.from_numpy(imgs)))
    j_raw, j_nms, j_planes = (np.asarray(x) for x in
                              jx_pp.perception_maps_batched(
                                  jnp.asarray(imgs), interpret=True))
    np.testing.assert_array_equal(raw, j_raw)
    np.testing.assert_array_equal(nms, j_nms)
    j_planes = j_planes.view(np.int32)
    assert planes.shape == j_planes.shape == (2, 8, h, w)
    # kernel A's tile padding is read only within 15 px of the right edge
    edge = w if w % 128 == 0 else w - 15
    np.testing.assert_array_equal(planes[..., :edge], j_planes[..., :edge])
    assert (nms > 0).sum() > 100


def test_float_frame_planes_within_bound():
    rs = np.random.RandomState(3)
    imgs = _blurred(rs, 1, 120, 256)
    planes = perception.perception_maps_batched(torch.from_numpy(imgs))[2]
    want = np.asarray(jx_pp.perception_maps_batched(
        jnp.asarray(imgs), interpret=True)[2]).view(np.int32)
    m = brief.BORDER
    interior = (planes.numpy() ^ want)[..., m:-m, m:-m]
    diff_bits = np.unpackbits(interior.copy().view(np.uint8)).sum()
    assert diff_bits / (interior.size * 32) < 1e-4, diff_bits


def test_dense_planes_match_xla_on_any_smooth():
    """Kernel B's plain version is lvt_tpu's XLA ``dense_descriptor_planes``
    (both zero-pad by 16 px): only comparisons, so bit-equal on any f32
    input, ties included."""
    rs = np.random.RandomState(4)
    smooth = rs.randint(0, 20655, (2, 45, 70)).astype(np.float32)
    smooth[:, ::4] = 777.0
    got = brief.dense_descriptor_planes(_t(smooth)).numpy()
    for b in range(2):
        want = np.asarray(jx_brief.dense_descriptor_planes(
            jnp.asarray(smooth[b]))).view(np.int32)
        np.testing.assert_array_equal(got[b], want)


def test_brief_source_tables_match_the_pattern():
    """csrc/brief.cu and csrc/patches.cu compile the pattern in; the
    X-macro tables of the header they share must be sample_pool() and
    pair_indices()."""
    import re

    for name in ("brief.cu", "patches.cu"):
        assert '#include "brief_pattern.cuh"' in (
            perception.kernels.CSRC / name).read_text()
    src = (perception.kernels.CSRC / "brief_pattern.cuh").read_text()

    def table(name):
        body = src.split(f"#define {name}(X)")[1].split("\n\n")[0]
        return np.array([[int(v) for v in m] for m in re.findall(
            r"X\((-?\d+), (-?\d+), (-?\d+)\)", body)])

    pool, pairs = table("LVT_BRIEF_POOL"), table("LVT_BRIEF_PAIRS")
    np.testing.assert_array_equal(pool[:, 0], np.arange(brief.POOL_SIZE))
    np.testing.assert_array_equal(pool[:, 1:], brief.sample_pool())
    np.testing.assert_array_equal(pairs[:, 0], np.arange(brief.N_BITS))
    np.testing.assert_array_equal(pairs[:, 1:], brief.pair_indices())


def test_brief_schedule_loads_each_sample_once_and_compares_each_pair_once():
    """csrc/brief.cu runs the pattern in the order of LVT_BRIEF_SCHEDULE:
    every pool sample loaded once with its (dx, dy), every pair compared
    once as its bit, after both of its samples were loaded, and no more
    than 29 samples live at once (the register budget the kernel's
    comment gives)."""
    import re

    src = (perception.kernels.CSRC / "brief_pattern.cuh").read_text()
    body = src.split("#define LVT_BRIEF_SCHEDULE(L, X)")[1]
    steps = re.findall(r"([LX])\((-?\d+), (-?\d+), (-?\d+)\)", body)
    pool, pairs = brief.sample_pool(), brief.pair_indices()
    loads = [int(k) for op, k, _, _ in steps if op == "L"]
    assert sorted(loads) == list(range(brief.POOL_SIZE))
    bits = sorted(int(b) for op, b, _, _ in steps if op == "X")
    assert bits == list(range(brief.N_BITS))
    loaded, done, max_live = set(), set(), 0
    for op, a, b, c in steps:
        a, b, c = int(a), int(b), int(c)
        if op == "L":
            assert [b, c] == pool[a].tolist()
            loaded.add(a)
        else:
            assert [b, c] == pairs[a].tolist() and {b, c} <= loaded
            done.add(a)
        live = {s for s in loaded
                if any(s in pairs[k] and k not in done
                       for k in range(brief.N_BITS))}
        max_live = max(max_live, len(live))
    assert max_live <= 29


def test_descriptors_from_planes_match_lvt_tpu():
    rs = np.random.RandomState(5)
    h, w, k = 64, 96, 50
    planes = rs.randint(0, 2**32, (2, 8, h, w), dtype=np.uint64).astype(
        np.uint32)
    kp = np.stack([rs.uniform(-3, w + 3, (2, k)),
                   rs.uniform(-3, h + 3, (2, k))], -1).astype(np.float32)
    kp[:, :5] = np.round(kp[:, :5]) + 0.5      # round half to even
    valid = rs.rand(2, k) > 0.2
    desc, v = brief.descriptors_from_planes(_t(planes), _t(kp), _t(valid))
    for b in range(2):
        jd, jv = jx_brief.descriptors_from_planes(
            jnp.asarray(planes[b]), jnp.asarray(kp[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(desc[b].numpy(),
                                      np.asarray(jd).view(np.int32))


def test_subpixel_refine_matches_lvt_tpu():
    rs = np.random.RandomState(6)
    raw = rs.randint(0, 60, (2, 50, 80)).astype(np.float32)
    x = rs.randint(-2, 82, (2, 40)).astype(np.int32)
    y = rs.randint(-2, 52, (2, 40)).astype(np.int32)
    x[:, :4], y[:, :4] = 0, 49                 # clamped at the edges
    xf, yf = detect._subpixel_refine(_t(raw), _t(x), _t(y))
    for b in range(2):
        jx, jy = jx_detect._subpixel_refine(jnp.asarray(raw[b]),
                                            jnp.asarray(x[b]),
                                            jnp.asarray(y[b]))
        np.testing.assert_array_equal(xf[b].numpy(), np.asarray(jx))
        np.testing.assert_array_equal(yf[b].numpy(), np.asarray(jy))


def _jax_dense_interpret(imgs, cfg):
    """lvt_tpu's dense extraction through the Pallas kernels A and B in
    interpret mode (extract_features_batched reaches them only on a TPU)."""
    raw, nms, planes = jx_pp.perception_maps_batched(jnp.asarray(imgs),
                                                     interpret=True)
    spread = jx_extract._spread_ties(jnp.asarray(imgs))
    return jax.vmap(lambda r, n, p: jx_extract._select_and_describe(
        r, n, p, cfg, "dense", spread))(raw, nms, planes)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_dense_extraction_matches_lvt_tpu(world_frames, jax_path):
    world, frames = world_frames
    cfg = _config(world, descriptor_mode="dense")
    feats = extract.extract_features_batched(torch.from_numpy(frames), cfg)
    if jax_path == "xla":
        jf = jx_extract.extract_features_batched(jnp.asarray(frames), cfg)
    else:
        jf = _jax_dense_interpret(frames, cfg)
    v = feats.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(jf.valid))
    assert v.sum() > 100
    for name in ("kp", "score"):
        np.testing.assert_array_equal(getattr(feats, name).numpy()[v],
                                      np.asarray(getattr(jf, name))[v],
                                      err_msg=name)
    np.testing.assert_array_equal(feats.desc.numpy()[v],
                                  np.asarray(jf.desc).view(np.int32)[v])


def test_dense_mode_equals_patch_mode(world_frames):
    world, frames = world_frames
    imgs = torch.from_numpy(frames)
    dense = extract.extract_features_batched(
        imgs, _config(world, descriptor_mode="dense"))
    patch = extract.extract_features_batched(
        imgs, _config(world, descriptor_mode="patch"))
    v = dense.valid
    assert torch.equal(v, patch.valid) and int(v.sum()) > 100
    for name in ("kp", "desc", "score"):
        assert torch.equal(getattr(dense, name)[v], getattr(patch, name)[v]), name
