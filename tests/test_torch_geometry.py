"""lvt_tpu_torch geometry (quaternions, SE(3) helpers) and the motion
model against lvt_tpu on the same numpy inputs.

Tolerance: a few f32 ulps, since the two packages sum short products in
different orders — 2e-6 absolute on unit quaternions and rotation
matrices, 1e-5 on rotated vectors, poses and points of magnitude up to
~30, 1e-5 relative on pixel projections, and 5e-4 rad on angle_between,
whose arccos near 1 magnifies one ulp of the dot product. Visibility masks
and from_matrix's branch choice are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.core import motion as jx_motion
from lvt_tpu.geometry import quaternion as jx_quat
from lvt_tpu.geometry import se3 as jx_se3
from lvt_tpu_torch.core import motion
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry import se3

ATOL = 2e-6


def _unit_quats(rs, n):
    q = rs.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("fn", ["multiply", "rotate", "to_matrix", "slerp",
                                "angle_between", "normalize", "conjugate"])
def test_quaternion_ops_match_lvt_tpu(fn):
    rs = np.random.RandomState(1)
    a, b = _unit_quats(rs, 64), _unit_quats(rs, 64)
    b[:4] = a[:4]            # slerp's near-parallel branch
    b[4:8] = -a[4:8]         # ... and its sign flip
    v = rs.randn(64, 3).astype(np.float32) * 5
    args = {"multiply": (a, b), "rotate": (a, v), "to_matrix": (a,),
            "slerp": (a, 0.5, b), "angle_between": (a, b),
            "normalize": (a * 3.0,), "conjugate": (a,)}[fn]
    conv = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for x in args]
    jconv = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    atol = 1e-5 if fn == "rotate" else (5e-4 if fn == "angle_between"
                                        else ATOL)
    _close(getattr(quat, fn)(*conv), getattr(jx_quat, fn)(*jconv), atol=atol)


def test_from_matrix_matches_lvt_tpu_including_ties():
    """Shepperd extraction picks the largest candidate; on ties (180-degree
    turns about an axis, the identity) the first index wins in both."""
    rs = np.random.RandomState(2)
    q = _unit_quats(rs, 32)
    m = np.asarray(jx_quat.to_matrix(jnp.asarray(q)))
    ties = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                     np.diag([-1, -1, 1])]).astype(np.float32)
    m = np.concatenate([m, ties])
    _close(quat.from_matrix(torch.from_numpy(m)),
           jx_quat.from_matrix(jnp.asarray(m)))


def _pose(rs):
    q = _unit_quats(rs, 1)[0]
    t = (rs.randn(3) * 3).astype(np.float32)
    return (se3.Pose(torch.from_numpy(t), torch.from_numpy(q)),
            jx_se3.Pose(jnp.asarray(t), jnp.asarray(q)))


def test_se3_helpers_match_lvt_tpu():
    rs = np.random.RandomState(3)
    pose, jpose = _pose(rs)
    other, jother = _pose(rs)
    pts = (rs.randn(200, 3) * 10).astype(np.float32)
    w2c, jw2c = se3.world_to_camera(pose), jx_se3.world_to_camera(jpose)
    _close(w2c, jw2c, atol=1e-5)
    _close(pose.matrix34(), jpose.matrix34(), atol=1e-6)
    cam = se3.transform_points(w2c, torch.from_numpy(pts))
    jcam = jx_se3.transform_points(jw2c, jnp.asarray(pts))
    _close(cam, jcam, atol=1e-5)
    for got, want in zip(pose.compose(other), jpose.compose(jother)):
        _close(got, want, atol=1e-5)
    for got, want in zip(pose.inverse(), jpose.inverse()):
        _close(got, want, atol=1e-5)

    cam_np = np.array(jcam)
    cam_np[:, 2] = np.abs(cam_np[:, 2]) + 1.0
    cam_np[:5, 2] = [0.0, -1e-13, 1e-13, -0.5, 600.0]   # the eps guard, behind
    args = (260.0, 250.0, 160.0, 120.0)
    uv = se3.project_points(torch.from_numpy(cam_np), *args)
    juv = jx_se3.project_points(jnp.asarray(cam_np), *args)
    _close(uv, juv, atol=1e-4, rtol=1e-5)
    bounds = (0.5, 150.0, 0.0, 320.0, 0.0, 240.0)
    np.testing.assert_array_equal(
        se3.visibility_mask(torch.from_numpy(cam_np), uv, *bounds).numpy(),
        np.asarray(jx_se3.visibility_mask(jnp.asarray(cam_np), juv, *bounds)))


def test_predict_next_pose_matches_lvt_tpu():
    """Three steps of the constant-velocity model from the initial state."""
    rs = np.random.RandomState(4)
    state, jstate = motion.MotionState.initial(), jx_motion.MotionState.initial()
    for _ in range(3):
        pose, jpose = _pose(rs)
        state, pred = motion.predict_next_pose(state, pose)
        jstate, jpred = jx_motion.predict_next_pose(jstate, jpose)
        for got, want in zip((*state, *pred), (*jstate, *jpred)):
            _close(got, want, atol=1e-5)
