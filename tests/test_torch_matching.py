"""lvt_tpu_torch matching (Hamming matrix, the top-2 kernel's plain
version in its four modes, acceptance, one-to-one resolution, map
matching, row matching) against lvt_tpu on the same numpy inputs.

Tolerance: none. Distances, indices, counts and masks are integers or
booleans and must be equal; d1/d2 are small integers held in f32. The top-2
``best`` index is compared where a candidate exists (n_cand > 0), as the
Pallas kernel's own tests do. The map-match projections are f32 geometry:
within 1e-4 px or 1e-5 relative (clutter near the camera plane projects
far outside the image).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.core.features import FrameFeatures as JxFeatures
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.ops import hamming as jx_hamming
from lvt_tpu.ops import matching as jx_matching
from lvt_tpu.ops.top2_pallas import masked_dual_top2 as jx_top2
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import hamming, matching, top2


def _desc(rs, n):
    return rs.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _flip_bits(rs, desc, n_bits):
    out = desc.copy()
    for row in out:
        for b in rs.choice(256, n_bits, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_popcount_and_hamming_matrix_exact():
    rs = np.random.RandomState(0)
    a, b = _desc(rs, 70), _desc(rs, 90)
    a[0] = 0xFFFFFFFF          # every bit, sign bit included
    b[0] = 0
    got = hamming.hamming_matrix(_t(a), _t(b))
    want = jx_hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == 256


@pytest.fixture(scope="module")
def top2_problem():
    rs = np.random.RandomState(42)
    m, k = 200, 300
    dist = np.array(jx_hamming.hamming_matrix(
        jnp.asarray(_desc(rs, m)), jnp.asarray(_desc(rs, k))))
    dist[:, 1::7] = dist[:, ::7][:, :dist[:, 1::7].shape[1]]  # equal distances
    q_uv = rs.uniform(0, 300, (m, 2)).astype(np.float32)
    t_kp = rs.uniform(0, 300, (k, 2)).astype(np.float32)
    q_valid = rs.rand(m) > 0.15
    t_valid = rs.rand(k) > 0.15
    # left keypoints for the row modes, a few near the image's edges, and
    # two query sets that overlap (the triangulation's excludes, the BA's
    # includes)
    q_kp = rs.uniform(0, 300, (m, 2)).astype(np.float32)
    q_kp[:3, 1] = [0.5, 299.7, 1.2]
    excl = rs.rand(m) > 0.6
    incl = rs.rand(m) > 0.5
    return dict(dist=dist, q_uv=q_uv, t_kp=t_kp, q_valid=q_valid,
                t_valid=t_valid, q_kp=q_kp, excl=excl, incl=incl)


def _jx_row_window(q_kp, radius, img_rows):
    """lvt_tpu's row window (lvt_tpu/ops/matching.py:189-191), the Pallas
    kernel's (lo, hi) query metadata in row mode."""
    y_l = jnp.floor(jnp.asarray(q_kp)[:, 1])
    return jnp.stack([jnp.maximum(y_l - radius, 0.0),
                      jnp.minimum(y_l + radius, float(img_rows))], axis=-1)


def _jx_row_sets(dist, q_kp, q_valid, t_kp, t_valid, excl, incl, radius,
                 img_rows):
    """lvt_tpu's Pallas top-2 (interpret mode) in row mode on its own
    window: the first set (valid & ~excl) and, with ``incl``, the second
    (valid & incl) as the two predicates of a dual row launch."""
    window = _jx_row_window(q_kp, radius, img_rows)
    sets = [q_valid & ~excl] + ([] if incl is None else [q_valid & incl])
    outs = [jx_top2(jnp.asarray(dist), window, jnp.asarray(ok),
                    jnp.asarray(t_kp), jnp.asarray(t_valid), r2a=0.0,
                    r2b=0.0, row_mode=True, interpret=True)[0]
            for ok in sets]
    return outs[0], outs[-1]


@pytest.mark.parametrize("mode", ["dual", "single", "row", "row_dual"])
def test_top2_plain_matches_pallas_kernel(top2_problem, mode):
    """The plain top-2 against lvt_tpu's Pallas kernel in interpret mode:
    radius modes on the same coordinates; the row modes from the left
    keypoints (the window computed inside) against the kernel on lvt_tpu's
    own window, single and dual (two overlapping query sets, each equal to
    its own single-set launch)."""
    p = top2_problem
    if mode.startswith("row"):
        incl = p["incl"] if mode == "row_dual" else None
        args = (p["dist"], p["q_kp"], p["q_valid"], p["t_kp"], p["t_valid"],
                p["excl"])
        want = _jx_row_sets(*args, incl, 2, 300)
        got = top2.masked_dual_top2_plain(
            *map(_t, args), None if incl is None else _t(incl),
            row_mode=True, row_radius=2.0, img_rows=300.0)
        assert (p["q_valid"] & ~p["excl"] & p["incl"]).sum() > 10
    else:
        kw = {"dual": dict(r2a=40.0**2, r2b=80.0**2),
              "single": dict(r2a=25.0**2, r2b=25.0**2)}[mode]
        args = (p["dist"], p["q_uv"], p["q_valid"], p["t_kp"], p["t_valid"])
        want = jx_top2(*map(jnp.asarray, args), interpret=True, **kw)
        got = top2.masked_dual_top2_plain(*map(_t, args), **kw)
    for g, w in zip(got, want):
        d1, d2, best, nc = (np.asarray(x) for x in w)
        np.testing.assert_array_equal(g[3].numpy(), nc)
        np.testing.assert_array_equal(g[0].numpy(), d1)
        np.testing.assert_array_equal(g[1].numpy(), d2)
        has = nc > 0
        np.testing.assert_array_equal(g[2].numpy()[has], best[has])
        assert has.sum() > 20 and (nc > 1).sum() > 5


@pytest.mark.parametrize("mode", ["dual", "single", "row", "row_dual"])
def test_hamming_top2_plain_matches_hamming_then_pallas_kernel(mode):
    """Kernel T's plain version, which takes descriptors, against lvt_tpu's
    Hamming matrix followed by its Pallas top-2 kernel (interpret mode):
    repeated target descriptors give equal distances, whole query rows
    are invalid or have no valid target in reach, and a few targets sit
    on the radius (row modes: the window from the keypoints inside, two
    overlapping query sets in the dual one, against lvt_tpu's window)."""
    rs = np.random.RandomState({"dual": 5, "single": 6, "row": 7,
                                "row_dual": 8}[mode])
    m, k = 150, 260
    q_desc, t_desc = _desc(rs, m), _desc(rs, k)
    t_desc[1::5] = t_desc[::5][:t_desc[1::5].shape[0]]   # duplicate targets
    q_desc[:30] = _flip_bits(rs, t_desc[rs.choice(k, 30)], 20)
    t_kp = rs.uniform(0, 200, (k, 2)).astype(np.float32)
    q_valid = rs.rand(m) > 0.1
    q_valid[:4] = False                                  # all-invalid rows
    t_valid = rs.rand(k) > 0.1
    dist = jx_hamming.hamming_matrix(jnp.asarray(q_desc), jnp.asarray(t_desc))
    if mode.startswith("row"):
        q = rs.uniform(0, 200, (m, 2)).astype(np.float32)
        q[4:8, 1] = [-50.0, -40.0, -45.5, -60.0]         # no target in reach
        q[8, 1] = t_kp[0, 1] + 2.0                        # target 0 at the edge
        excl = rs.rand(m) > 0.7
        excl[:8] = False
        incl = (rs.rand(m) > 0.4) | excl if mode == "row_dual" else None
        got = top2.hamming_top2(
            _t(q_desc), _t(t_desc), *map(_t, (q, q_valid, t_kp, t_valid,
                                              excl)),
            None if incl is None else _t(incl), row_mode=True,
            row_radius=2.0, img_rows=200.0)
        want = _jx_row_sets(dist, q, q_valid, t_kp, t_valid, excl, incl, 2,
                            200)
        if incl is not None:
            assert (q_valid & ~excl & incl).sum() > 10   # overlapping sets
    else:
        q = rs.uniform(0, 200, (m, 2)).astype(np.float32)
        q[4:8] = -500.0                                  # no target in reach
        q[8] = t_kp[0] + np.float32([30.0, 0.0])         # target 0 on the radius
        kw = dict(r2a=30.0**2, r2b=(60.0 if mode == "dual" else 30.0)**2)
        args = (q, q_valid, t_kp, t_valid)
        got = top2.hamming_top2(_t(q_desc), _t(t_desc), *map(_t, args), **kw)
        want = jx_top2(dist, *map(jnp.asarray, args), interpret=True, **kw)
    for g, w in zip(got, want):
        d1, d2, best, nc = (np.asarray(x) for x in w)
        np.testing.assert_array_equal(g[3].numpy(), nc)
        np.testing.assert_array_equal(g[0].numpy(), d1)
        np.testing.assert_array_equal(g[1].numpy(), d2)
        has = nc > 0
        np.testing.assert_array_equal(g[2].numpy()[has], best[has])
        assert not g[2].numpy()[~has].any()
        assert (~has[:8]).all() and has.sum() > 40 and (nc > 1).sum() > 10
        assert (g[0].numpy()[has] == g[1].numpy()[has]).any()  # equal d1, d2


def test_masked_top2_int_accept_and_resolve_exact(top2_problem):
    p = top2_problem
    rs = np.random.RandomState(3)
    cand = rs.rand(*p["dist"].shape) > 0.9
    got = hamming.masked_top2_int(_t(p["dist"]), _t(cand))
    want = jx_hamming.masked_top2_int(jnp.asarray(p["dist"]), jnp.asarray(cand))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    idx = hamming.accept_matches(*got, 0.9, 80.0)
    jidx = jx_hamming.accept_matches(*want, 0.9, 80.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    # many queries claiming few targets: one-to-one resolution is exercised
    claims = rs.randint(-1, 12, 200)
    d1 = rs.randint(0, 6, 200).astype(np.float32)
    got_r = hamming.resolve_one_to_one(_t(claims), _t(d1), 12)
    want_r = jx_hamming.resolve_one_to_one(jnp.asarray(claims),
                                           jnp.asarray(d1), 12)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    won = got_r.numpy()[got_r.numpy() >= 0]
    assert len(won) == len(set(won)) > 5


def _frame_features(rs, k, w=320, h=240):
    kp = np.stack([rs.uniform(25, w - 25, k), rs.uniform(25, h - 25, k)],
                  -1).astype(np.float32)
    desc = _desc(rs, k)
    valid = rs.rand(k) > 0.1
    return kp, desc, valid


CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, near=0.5, far=150.0,
           min_x=0.0, max_x=320.0, min_y=0.0, max_y=240.0)


@pytest.mark.parametrize("n_true", [300, 30], ids=["narrow", "wide-retry"])
def test_find_map_matches_matches_lvt_tpu(n_true):
    """Map points that reproject near features with near-identical
    descriptors, plus clutter; with few true matches the 2x-radius retry
    fires."""
    rs = np.random.RandomState(n_true)
    m, k = 512, 640
    kp, desc, valid = _frame_features(rs, k)
    src = rs.choice(k, n_true, replace=False)
    depth = rs.uniform(3.0, 60.0, n_true)
    # offsets up to 40 px: some land in the wide radius only
    uv = kp[src] + rs.uniform(-1, 1, (n_true, 2)) * (
        40.0 if n_true < 50 else 6.0)
    pts = np.zeros((m, 3), np.float32)
    pts[:n_true, 0] = (uv[:, 0] - CAM["cx"]) / CAM["fx"] * depth
    pts[:n_true, 1] = (uv[:, 1] - CAM["cy"]) / CAM["fy"] * depth
    pts[:n_true, 2] = depth
    pts[n_true:] = rs.uniform([-20, -10, -5], [20, 10, 80], (m - n_true, 3))
    mdesc = _desc(rs, m)
    mdesc[:n_true] = _flip_bits(rs, desc[src], 6)
    mvalid = rs.rand(m) > 0.05
    t = np.array([0.01, -0.02, 0.03], np.float32)
    q = np.array([1.0, 0.001, -0.002, 0.0005], np.float32)
    q /= np.linalg.norm(q)
    kw = dict(tracking_radius=25, ratio_threshold=0.9, abs_threshold=80.0,
              retry_min_matches=50, **CAM)

    score = np.zeros(k, np.float32)
    got = matching.find_map_matches(
        _t(pts), _t(mdesc), _t(mvalid), Pose(_t(t), _t(q)),
        FrameFeatures(_t(kp), _t(desc), _t(score), _t(score), _t(valid)),
        **kw)
    want = jx_matching.find_map_matches(
        jnp.asarray(pts), jnp.asarray(mdesc), jnp.asarray(mvalid),
        JxPose(jnp.asarray(t), jnp.asarray(q)),
        JxFeatures(*map(jnp.asarray, (kp, desc, score, score, valid))),
        use_kernel=False, use_mxu=False, **kw)
    for name in ("match_idx", "visible", "d1", "d2", "feature_matched",
                 "matches_count", "used_wide_radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.projection.numpy(),
                               np.asarray(want.projection), rtol=1e-5,
                               atol=1e-4)
    assert bool(got.used_wide_radius) == (n_true < 50)
    assert int(got.matches_count) > n_true // 3


def test_row_top2_then_acceptance_matches_lvt_tpus_row_match():
    """Kernel T's single row mode (the window from the keypoints) followed
    by the acceptance, the one-to-one resolution and the claims, the ops
    ``ba_observe``'s plain version runs on T's set, give lvt_tpu's
    ``row_match``."""
    rs = np.random.RandomState(11)
    k = 512
    kp_l, desc_l, valid_l = _frame_features(rs, k)
    perm = rs.permutation(k)
    kp_r = kp_l[perm] - np.array([8.0, 0.0], np.float32)
    kp_r[:, 1] += rs.uniform(-2.5, 2.5, k).astype(np.float32)
    desc_r = _flip_bits(rs, desc_l[perm], 10)
    valid_r = rs.rand(k) > 0.1
    excluded = rs.rand(k) > 0.7
    score = np.zeros(k, np.float32)
    window = dict(vertical_search_radius=2, img_rows=240)
    accept = dict(ratio_threshold=0.6, abs_threshold=80.0)
    left = (kp_l, desc_l, score, score, valid_l)
    right = (kp_r, desc_r, score, score, valid_r)
    d1, d2, best, n_cand = top2._unpack(*matching.row_top2_packed(
        FrameFeatures(*map(_t, left)), FrameFeatures(*map(_t, right)),
        _t(excluded), **window))[0]
    idx = hamming.accept_matches(d1, d2, best, n_cand, *accept.values())
    idx = hamming.resolve_one_to_one(idx, d1, k)
    got = dict(right_idx=idx, left_matched=idx >= 0,
               right_matched=hamming.claim_mask(idx, k) & _t(valid_r),
               count=(idx >= 0).sum())
    want = jx_matching.row_match(JxFeatures(*map(jnp.asarray, left)),
                                 JxFeatures(*map(jnp.asarray, right)),
                                 jnp.asarray(excluded), use_kernel=False,
                                 use_mxu=False, **window, **accept)
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got["count"]) > 100

