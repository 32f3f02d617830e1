"""lvt_tpu_torch PnP, stereo triangulation and map upkeep against lvt_tpu
on the same numpy inputs.

Tolerances:
  * solve_pnp: pose within 1e-4 m and 1e-4 rad, inlier count equal (the
    LM iterations reduce over points in different orders, so the poses
    agree to f32 rounding, not bit for bit);
  * the normal-equation and sum ops (``lvt_tpu_torch::pnp_normal_eqs``,
    ``lvt_tpu_torch::stream_sum``) on the CPU: bit-equal to the einsums
    and the sum solve_pnp used before them, alone, over a stream axis and
    under vmap; the normal equations' ``wide`` (float64) outputs on the
    CPU: the float32 ones widened, exactly (the sharded solve adds them
    across ranks; one rank then keeps the unsharded bits);
  * triangulate_stereo: the validity mask equal, positions within 1e-5
    relative;
  * insert_points, apply_match_bookkeeping, clean_untracked: exact (they
    only select, copy and count).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.core import map as jx_map
from lvt_tpu.core.state import PointStore as JxStore
from lvt_tpu.geometry import quaternion as jx_quat
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.ops import triangulate as jx_tri
from lvt_tpu.solver.pnp import solve_pnp as jx_solve_pnp
from lvt_tpu_torch.core import map as map_ops
from lvt_tpu_torch.core.state import PointStore
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import triangulate
from lvt_tpu_torch.solver import pnp
from lvt_tpu_torch.solver.pnp import solve_pnp

FX, FY, CX, CY = 718.856, 718.856, 607.19, 185.21
BASELINE = 0.537


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _pose(rs, t_scale, r_scale):
    w = rs.randn(3) * r_scale
    th = np.linalg.norm(w)
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * w / th])
    return (rs.randn(3) * t_scale).astype(np.float32), q.astype(np.float32)


def _world_points(rs, n, zmin=4.0, zmax=80.0):
    z = rs.uniform(zmin, zmax, n)
    x = (rs.uniform(50, 1191, n) - CX) * z / FX
    y = (rs.uniform(30, 346, n) - CY) * z / FY
    return np.stack([x, y, z], -1).astype(np.float32)


def _angle(q_got, q_want) -> float:
    """Rotation angle between two quaternions, in f64 from their normalised
    relative rotation (arccos of a dot product near 1 would turn one f32
    ulp of norm into 5e-4 rad)."""
    a = q_got.double()
    b = torch.from_numpy(np.asarray(q_want, np.float64))
    rel = quat.multiply(quat.normalize(a), quat.conjugate(quat.normalize(b)))
    return float(2 * torch.atan2(rel[1:].norm(), rel[0].abs()))


def _project(pts_world, t, q):
    r = np.asarray(jx_quat.to_matrix(jnp.asarray(q)), np.float64)
    p = (pts_world - t) @ r          # world -> camera: R^T (x - t)
    return np.stack([FX * p[:, 0] / p[:, 2] + CX,
                     FY * p[:, 1] / p[:, 2] + CY], -1).astype(np.float32)


@pytest.mark.parametrize("n_out", [0, 60], ids=["clean", "outliers"])
def test_solve_pnp_matches_lvt_tpu(n_out):
    rs = np.random.RandomState(10 + n_out)
    pts = _world_points(rs, 300)
    t, q = _pose(rs, 1.0, 0.05)
    uv = _project(pts, t, q) + rs.randn(300, 2).astype(np.float32) * 0.5
    uv[:n_out] += rs.uniform(20, 90, (n_out, 2)).astype(np.float32)
    weights = (rs.rand(300) > 0.1).astype(np.float32)
    t0 = t + (rs.randn(3) * 0.2).astype(np.float32)
    q0 = q + (rs.randn(4) * 0.01).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    cam = dict(fx=FX, fy=FY, cx=CX, cy=CY)
    got = solve_pnp(Pose(_t(t0), _t(q0)), _t(pts), _t(uv), _t(weights), **cam)
    want = jx_solve_pnp(JxPose(jnp.asarray(t0), jnp.asarray(q0)),
                        jnp.asarray(pts), jnp.asarray(uv),
                        jnp.asarray(weights), **cam)
    dt = np.linalg.norm(got.pose.t.numpy() - np.asarray(want.pose.t))
    assert dt < 1e-4 and _angle(got.pose.q, want.pose.q) < 1e-4, dt
    assert int(got.inlier_count) == int(want.inlier_count)
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    # and it solved the problem
    assert np.linalg.norm(got.pose.t.numpy() - t) < 0.05
    if n_out:
        assert int(got.inlier_count) < int(weights.sum()) - n_out // 2


def _einsums(jac, w, r):
    """The normal equations as solve_pnp formed them before the op."""
    jw = jac * w[:, None, None]
    hg = torch.einsum("mki,mkj->ij", jw, torch.cat([jac, r[..., None]], -1))
    return hg, torch.einsum("m,mki,mki->i", w, jac, jac)


@pytest.mark.parametrize("s,m", [(1, 300), (3, 1024), (2, 7)])
def test_normal_equations_op_is_the_einsums_on_the_cpu(s, m):
    """The op at S = 1 (solve_pnp's call), over S streams at once, and
    under torch.func.vmap (the multi-stream step; here with the residuals
    unbatched too): every stream's hg and h_diag bit-equal to the einsums
    on that stream alone."""
    rs = np.random.RandomState(s * m)
    jac = torch.from_numpy((rs.randn(s, m, 2, 6) * [1e3, 1e3, 3e2, 5e2,
                                                     8e2, 4e2])
                           .astype(np.float32))
    w = torch.from_numpy((rs.rand(s, m) * (rs.rand(s, m) > 0.2))
                         .astype(np.float32))
    r = torch.from_numpy(rs.randn(s, m, 2).astype(np.float32))
    want = [_einsums(*a) for a in zip(jac, w, r)]
    batched = pnp.pnp_normal_eqs_op(jac, w, r)
    vmapped = torch.func.vmap(pnp.normal_equations)(jac, w, r)
    shared = torch.func.vmap(pnp.normal_equations, in_dims=(0, 0, None))(
        jac, w, r[0])
    for i, (hg, h_diag) in enumerate(want):
        for got in (pnp.normal_equations(jac[i], w[i], r[i]),
                    (batched[0][i], batched[1][i]),
                    (vmapped[0][i], vmapped[1][i])):
            assert torch.equal(got[0], hg) and torch.equal(got[1], h_diag)
        assert torch.equal(shared[0][i], _einsums(jac[i], w[i], r[0])[0])
    assert batched[0].shape == (s, 6, 7) and batched[1].shape == (s, 6)


@pytest.mark.parametrize("s,m", [(1, 300), (3, 1024)])
def test_wide_normal_equations_are_the_narrow_ones_widened_on_the_cpu(s, m):
    rs = np.random.RandomState(s + m)
    jac = torch.from_numpy(rs.randn(s, m, 2, 6).astype(np.float32) * 300)
    w = torch.from_numpy(rs.rand(s, m).astype(np.float32))
    r = torch.from_numpy(rs.randn(s, m, 2).astype(np.float32))
    narrow = pnp.pnp_normal_eqs_op(jac, w, r)
    for wide in (pnp.pnp_normal_eqs_op(jac, w, r, True),
                 torch.func.vmap(lambda *a: pnp.normal_equations(
                     *a, wide=True))(jac, w, r)):
        for a, b in zip(wide, narrow):
            assert a.dtype == torch.float64
            assert torch.equal(a, b.double())


@pytest.mark.parametrize("s,n", [(1, 1024), (8, 1024), (3, 8191)])
def test_stream_sum_op_is_the_sum_on_the_cpu(s, n):
    """The sum op alone (solve_pnp's chi-square), over S streams and under
    vmap: each stream's result bit-equal to ``x.sum()`` of that stream."""
    rs = np.random.RandomState(n + s)
    x = torch.from_numpy((rs.exponential(2.0, (s, n))
                          * (rs.rand(s, n) > 0.3)).astype(np.float32))
    batched = pnp.stream_sum_op(x)
    vmapped = torch.func.vmap(pnp.stream_sum)(x)
    for i in range(s):
        want = x[i].sum()
        for got in (pnp.stream_sum(x[i]), batched[i], vmapped[i]):
            assert got.shape == () and torch.equal(got, want)


def test_triangulate_stereo_matches_lvt_tpu():
    rs = np.random.RandomState(20)
    n = 400
    z = rs.uniform(1.0, 400.0, n).astype(np.float32)      # near to very far
    x = (rs.uniform(-50, 1291, n) - CX) * z / FX          # some leave the image
    y = (rs.uniform(-20, 396, n) - CY) * z / FY
    pts = np.stack([x, y, z], -1).astype(np.float32)
    uv_l = np.stack([FX * x / z + CX, FY * y / z + CY], -1).astype(np.float32)
    uv_r = np.stack([FX * (x - BASELINE) / z + CX, FY * y / z + CY],
                    -1).astype(np.float32)
    uv_r += rs.randn(n, 2).astype(np.float32) * 0.4
    uv_r[:40] += rs.uniform(2, 8, (40, 2)).astype(np.float32)   # gated out
    pair_valid = rs.rand(n) > 0.1
    t, q = _pose(rs, 5.0, 0.3)
    gates = dict(fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE, near=0.5,
                 far=300.0, min_x=0.0, max_x=1241.0, min_y=0.0, max_y=376.0,
                 reprojection_th2=5.991)
    got = triangulate.triangulate_stereo(_t(uv_l), _t(uv_r), _t(pair_valid),
                                         Pose(_t(t), _t(q)), **gates)
    want = jx_tri.triangulate_stereo(
        jnp.asarray(uv_l), jnp.asarray(uv_r), jnp.asarray(pair_valid),
        JxPose(jnp.asarray(t), jnp.asarray(q)), **gates)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert 0.3 * n < v.sum() < 0.9 * n
    for name in ("points_cam", "points_world"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _stores(rs, cap):
    pos = rs.randn(cap, 3).astype(np.float32)
    desc = rs.randint(0, 2**32, (cap, 8), dtype=np.uint64).astype(np.uint32)
    counter = rs.randint(0, 12, cap).astype(np.int32)
    age = rs.randint(0, 30, cap).astype(np.int32)
    valid = rs.rand(cap) > 0.5
    arrays = (pos, desc, counter, age, valid)
    return PointStore(*map(_t, arrays)), JxStore(*map(jnp.asarray, arrays))


def _assert_store_equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        np.testing.assert_array_equal(g.view(np.uint32) if name == "desc"
                                      else g, w, err_msg=name)


@pytest.mark.parametrize("n_new", [10, 200], ids=["fits", "overflows"])
def test_insert_points_matches_lvt_tpu(n_new):
    rs = np.random.RandomState(n_new)
    store, jstore = _stores(rs, 128)
    k = 256
    new_pos = rs.randn(k, 3).astype(np.float32)
    new_desc = rs.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    mask = np.zeros(k, bool)
    mask[rs.choice(k, n_new, replace=False)] = True
    ctr = rs.randint(0, 5, k).astype(np.int32)
    age = rs.randint(0, 5, k).astype(np.int32)
    got = map_ops.insert_points(store, _t(new_pos), _t(new_desc), _t(mask),
                                new_counter=_t(ctr), new_age=_t(age))
    want = jx_map.insert_points(jstore, jnp.asarray(new_pos),
                                jnp.asarray(new_desc), jnp.asarray(mask),
                                new_counter=jnp.asarray(ctr),
                                new_age=jnp.asarray(age))
    _assert_store_equal(got.store, want.store)
    for name in ("n_inserted", "n_dropped", "taken"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (int(got.n_dropped) > 0) == (n_new > 64)


def test_bookkeeping_and_clean_untracked_match_lvt_tpu():
    rs = np.random.RandomState(30)
    store, jstore = _stores(rs, 128)
    k = 96
    match_idx = rs.randint(-2, k, 128).astype(np.int64)
    match_idx[:40] = rs.choice(k, 40, replace=False)
    feature_matched = rs.rand(k) > 0.5
    got = map_ops.apply_match_bookkeeping(store, _t(match_idx))
    want = jx_map.apply_match_bookkeeping(jstore, jnp.asarray(match_idx))
    _assert_store_equal(got, want)
    got_c, got_f = map_ops.clean_untracked(got, _t(match_idx),
                                           _t(feature_matched), 10)
    want_c, want_f = jx_map.clean_untracked(want, jnp.asarray(match_idx),
                                            jnp.asarray(feature_matched), 10)
    _assert_store_equal(got_c, want_c)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert int(got_c.size()) < int(got.size())
