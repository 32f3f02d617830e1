"""lvt_tpu_torch's sparse descriptor mode (``descriptor_mode="sparse"``, or
``use_dense_brief=False`` with the mode unset) against lvt_tpu's sparse
mode on the same numpy inputs, and against the port's patch mode.

The JAX side runs as the JAX tests run it on the CPU (XLA ops, no Pallas
kernel), except on float frames: there lvt_tpu's CPU path box-sums with
cumulative sums, which round otherwise than its Pallas kernel A, and the
port follows kernel A (ROADMAP H4), so the reference is lvt_tpu with its
kernel A in interpret mode, as tests/test_torch_rectified.py does.
Tolerances:
  * uint8 frames: kp, desc, valid and score bit-equal over every slot;
  * float frames, against lvt_tpu with kernel A: the same, bit-equal;
  * the port's sparse mode against its patch mode: valid equal, and kp,
    desc and score bit-equal at the valid keypoints (lvt_tpu's config.py:
    every mode is bit-identical there);
  * VOSystem over 5 frames and a 2-stream MultiStreamVO over 4 frames, in
    the sparse mode: poses bit-equal to the port's own patch mode on the
    same frames, and against lvt_tpu's sparse mode statuses and tracked
    map points equal, poses within 1e-3 m, the bound
    tests/test_torch_system.py gives the jitted JAX step. The gap is the
    tracking body's, not the mode's: on these frames it is the same in
    all three modes, 1.15e-4 m (VOSystem) and 3.1e-4 m (MultiStreamVO).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io.synthetic import SyntheticWorld
from lvt_tpu.ops import perception_pallas as jx_pp
from lvt_tpu.parallel import multistream as jx_ms
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core.state import TRACKING
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.parallel import multistream as ms
from tests.test_torch_multistream import WORLD, _config, divergent_frames
from tests.test_torch_system import share_the_cores  # noqa: F401

SPARSE = {"sparse": dict(descriptor_mode="sparse"),
          "no_dense_brief": dict(use_dense_brief=False,
                                 descriptor_mode=None)}
FIELDS = ("kp", "desc", "valid", "score")


def _frames(n=1):
    seq = SyntheticWorld(**WORLD).stereo_sequence(n, speed=0.3)
    return [(np.clip(l, 0, 255).astype(np.uint8),
             np.clip(r, 0, 255).astype(np.uint8)) for l, r, _ in seq]


def _pair():
    return np.stack(_frames()[0])


def _jx_features(imgs, cfg):
    out = jx_extract.extract_features_batched(jnp.asarray(imgs), cfg)
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


def _features(imgs, cfg):
    out = extract.extract_features_batched(torch.from_numpy(imgs), cfg)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def _assert_features_equal(got, want):
    want = dict(want, desc=want["desc"].view(np.int32))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", SPARSE.values(), ids=SPARSE.keys())
def test_sparse_features_match_lvt_tpu(kw):
    """Both ways of asking for the sparse mode resolve to it, on both
    sides, and a uint8 stereo pair's features are lvt_tpu's, bit for
    bit."""
    cfg = _config(**kw)
    assert extract._descriptor_mode(cfg) == "sparse"
    assert jx_extract._descriptor_mode(cfg) == "sparse"
    imgs = _pair()
    got = _features(imgs, cfg)
    assert got["valid"].sum() > 100
    _assert_features_equal(got, _jx_features(imgs, cfg))


def test_float_frames_match_lvt_tpu_with_kernel_a(monkeypatch):
    """Non-integer float32 frames: lvt_tpu's sparse mode with its kernel A
    in interpret mode, bit for bit."""
    monkeypatch.setattr(jx_pp, "score_smooth_batched",
                        functools.partial(jx_pp.score_smooth_batched,
                                          interpret=True))
    rs = np.random.RandomState(3)
    imgs = (_pair().astype(np.float32)
            + rs.uniform(0.0, 1.0, (2, WORLD["height"], WORLD["width"]))
            .astype(np.float32))
    cfg = _config(descriptor_mode="sparse")
    got = _features(imgs, cfg)
    assert got["valid"].sum() > 100
    _assert_features_equal(got, _jx_features(
        imgs, cfg.replace(use_pallas_perception=True)))


def test_sparse_equals_patch_at_valid_keypoints():
    imgs = _pair()
    sparse = _features(imgs, _config(descriptor_mode="sparse"))
    patch = _features(imgs, _config(descriptor_mode="patch"))
    np.testing.assert_array_equal(sparse["valid"], patch["valid"])
    v = sparse["valid"]
    assert v.sum() > 100
    for k in ("kp", "desc", "score"):
        np.testing.assert_array_equal(sparse[k][v], patch[k][v], err_msg=k)


def _runs(make, jx_make, left, right, kw):
    """The port's sparse run, its patch run and lvt_tpu's sparse run of
    the same frames: (poses, metrics) each."""
    sparse = make(_config(**kw)).track_chunk(left, right)
    patch = make(_config(descriptor_mode="patch")).track_chunk(left, right)
    return sparse, patch, jx_make(_config(**kw)).track_chunk(left, right)


def _assert_runs(sparse, patch, theirs):
    (poses, metrics), (ppose, _), (jposes, jmetrics) = sparse, patch, theirs
    assert torch.equal(poses.t, ppose.t) and torch.equal(poses.q, ppose.q)
    for name in ("status", "tracked_map_points"):
        np.testing.assert_array_equal(getattr(metrics, name).numpy(),
                                      np.asarray(getattr(jmetrics, name)),
                                      err_msg=name)
    assert (metrics.status.numpy() == TRACKING).all()
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t),
                               atol=1e-3)


def test_vosystem_sparse_matches_lvt_tpu():
    frames = _frames(5)
    _assert_runs(*_runs(lambda cfg: VOSystem(cfg, device="cpu"), JxVOSystem,
                        np.stack([f[0] for f in frames]),
                        np.stack([f[1] for f in frames]), SPARSE["sparse"]))


def test_multistream_sparse_matches_lvt_tpu():
    _assert_runs(*_runs(lambda cfg: ms.MultiStreamVO(cfg, 2, device="cpu"),
                        lambda cfg: jx_ms.MultiStreamVO(cfg, 2),
                        *divergent_frames(4), SPARSE["no_dense_brief"]))
