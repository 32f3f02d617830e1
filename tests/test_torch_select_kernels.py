"""Corner selection and the map match's acceptance as custom ops on the CPU
(``lvt_tpu_torch::select_corners``, ops/detect.py, and
``lvt_tpu_torch::map_accept``, ops/matching.py), where each is its plain
version; the CUDA kernels (csrc/select.cu, csrc/track.cu) are held against
the plain versions in tests/test_torch_cuda.py.

A numpy model of ``map_accept_kernel``'s order (the counts and claims
from the targets' keys, tiles of the block's threads) is held against the
plain version.

Tolerance: none. The selection is integer keys, masks and a handful of f32
operations in lvt_tpu's order (the subpixel fit); the acceptance is
integer keys, indices, counts and masks, with d1 / d2 small integers in
f32 and the observations copies of keypoints. Against lvt_tpu the slots
that are valid are compared, as tests/test_torch_perception.py compares
the selection (lvt_tpu's ``approx_max_k`` may order invalid slots
otherwise); every slot is compared with the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core.features import FrameFeatures as JxFeatures
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.ops import detect as jx_detect
from lvt_tpu.ops import matching as jx_matching
from lvt_tpu.ops import patches_pallas as jx_patches
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import detect, matching, top2
from tests.test_torch_cuda import (_assert_outputs_equal, accept_args,
                                   accept_problem, accept_retry, sparse_map)
from tests.test_torch_system import share_the_cores  # noqa: F401

# ---- corner selection

def _select_port(nms, raw, spread, cap, threshold, cell, per_cell, low):
    raw_t = torch.zeros(0) if raw is None else torch.from_numpy(raw)
    return detect.select_corners_op(torch.from_numpy(nms), raw_t, NO_PLANES,
                                    float(threshold), cell, per_cell, low,
                                    spread, cap)


def _select_jax(nms, raw, spread, cap, threshold, cell, per_cell, low):
    """lvt_tpu's select_corners per image (subpixel on ``raw`` when given),
    its ``_pad_to`` to ``cap`` slots and ``clamp_coords`` at the maps'
    extent; the threshold each image used."""
    b, h, w = nms.shape
    subpixel = raw is not None
    det = jax.vmap(lambda n, r: jx_detect.select_corners(
        r, n, threshold, cell_size=cell, max_per_cell=per_cell,
        corners_low_threshold=low, subpixel=subpixel, img_hw=(h, w),
        spread_ties=spread))(jnp.asarray(nms),
                             jnp.asarray(raw if subpixel else nms))

    def pad(a):
        return np.asarray(jx_extract._pad_to(a, cap, axis=1))

    xi, yi = pad(det.kp_int[..., 0]), pad(det.kp_int[..., 1])
    xc, yc = jx_patches.clamp_coords(jnp.asarray(xi), jnp.asarray(yi), h, w)
    out = dict(xi=xi, yi=yi, xc=np.asarray(xc), yc=np.asarray(yc),
               score=pad(det.score), valid=pad(det.valid))
    if subpixel:
        out["kp"] = pad(det.kp)
        out["corner"] = pad(det.kp_int.astype(jnp.float32))
    return out, np.asarray(det.threshold_used)


NAMES = ("xi", "yi", "xc", "yc", "score", "valid", "kp", "corner", "desc",
         "desc_valid")
# no planes: the patch and sparse modes' selection
NO_PLANES = torch.zeros(0, dtype=torch.int32)


def _check_selection(nms, raw=None, *, spread, threshold=20.0, cell=32,
                     per_cell=12, low=200, cap=None):
    b, h, w = nms.shape
    ncells = -(-h // min(cell, h)) * -(-w // min(cell, w))
    cap = cap or -(-ncells * per_cell // 128) * 128
    args = (nms, raw, spread, cap, threshold, cell, per_cell, low)
    got = _select_port(*args)
    want, t_used = _select_jax(*args)
    v = want["valid"]
    np.testing.assert_array_equal(got[5].numpy(), v)
    for name, g in zip(NAMES, got):
        if name in want and name != "valid":
            np.testing.assert_array_equal(g.numpy()[v], want[name][v],
                                          err_msg=name)
    assert v.sum() > 0
    # every slot: the op (its CPU kernel) is the plain version, and the
    # wrapper the step calls is the op
    plain = detect.select_corners_plain(
        torch.from_numpy(nms), torch.zeros(0) if raw is None
        else torch.from_numpy(raw), NO_PLANES, threshold, cell, per_cell,
        low, spread, cap)
    _assert_outputs_equal(got, plain, "select_corners")
    wrapped = detect.select_slots(
        torch.from_numpy(nms), threshold, cell_size=cell,
        max_per_cell=per_cell, corners_low_threshold=low,
        spread_ties=spread, capacity=cap,
        score_raw=None if raw is None else torch.from_numpy(raw))
    _assert_outputs_equal(wrapped, got, "select_slots")
    # the pad slots are zero, clamped as kernel P's corners
    used = ncells * per_cell
    assert not got[5][:, used:].any() and not got[4][:, used:].any()
    return got, t_used


@pytest.mark.parametrize("spread", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_select_matches_lvt_tpu(spread):
    rs = np.random.RandomState(3)
    nms = sparse_map(rs, 2, 64, 96)
    if not spread:   # non-integer scores, as float frames give
        nms = nms * rs.uniform(0.5, 1.5, nms.shape).astype(np.float32)
    _check_selection(nms, spread=spread)


@pytest.mark.parametrize("spread", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_select_plateau_larger_than_a_cell_keeps(spread):
    """Whole rows of equal scores, many more than a cell keeps: with the
    dither ranked by position, without it by the lowest index."""
    h, w = 64, 128
    nms = np.zeros((1, h, w), np.float32)
    nms[0, 8:56:2, 4:124:2] = 40.0
    nms[0, 10:50:8, 9:100:6] = 55.0
    if not spread:
        nms[0, 30, 30:90:3] = 40.5
    _check_selection(nms, spread=spread, per_cell=20)


@pytest.mark.parametrize("spread", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_select_cells_that_do_not_divide_the_image(spread):
    """70 x 150 in 32-px cells: the last row and column of cells reach
    into the zero pad (ranked by the dither there, or by index)."""
    rs = np.random.RandomState(8)
    _check_selection(sparse_map(rs, 2, 70, 150, density=0.08),
                     spread=spread, per_cell=16)


def test_select_fallback_per_image():
    """B = 3: image 1 has fewer than ``low`` slots above t and takes
    t_low; images 0 and 2 keep t. Scores between t_low and t are valid in
    image 1 only."""
    rs = np.random.RandomState(4)
    h, w = 64, 128
    nms = np.zeros((3, h, w), np.float32)
    for i, n_strong in enumerate((180, 40, 220)):
        ys, xs = rs.randint(0, h, 400), rs.randint(0, w, 400)
        nms[i, ys, xs] = 15.0                       # above t_low only
        ys, xs = rs.randint(0, h, n_strong), rs.randint(0, w, n_strong)
        nms[i, ys, xs] = rs.randint(30, 90, n_strong)
    got, t_used = _check_selection(nms, spread=True, threshold=25.0,
                                   per_cell=24, low=100)
    t, t_low = detect._thresholds(25.0)
    assert t_used.tolist() == [t, t_low, t]
    score, valid = got[4].numpy(), got[5].numpy()
    assert (valid[1] & (score[1] == 15.0)).any()
    assert not (valid[[0, 2]] & (score[[0, 2]] == 15.0)).any()


@pytest.mark.parametrize("spread", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_select_subpixel_mode_matches_lvt_tpu(spread):
    """The dense and sparse modes' selection: kp refined on the raw map at
    every valid slot, the integer corner beside it."""
    rs = np.random.RandomState(6)
    b, h, w = 2, 72, 100
    raw = rs.randint(0, 60, (b, h, w)).astype(np.float32)
    if not spread:
        raw = raw + rs.rand(b, h, w).astype(np.float32)
    nms = np.where(rs.rand(b, h, w) < 0.05, raw, 0).astype(np.float32)
    got, _ = _check_selection(nms, raw, spread=spread, per_cell=16)
    assert got[6].shape == (b, got[0].shape[1], 2)
    frac = got[6].numpy() - got[7].numpy()
    assert (np.abs(frac) <= 0.5).all() and (frac != 0).any()


def test_select_vmap_rule_is_each_image_alone():
    """Under ``torch.func.vmap`` over 3 frames of 2 images the rule folds
    vmap's axis into the image axis: each image gets its own bits."""
    rs = np.random.RandomState(9)
    nms = torch.from_numpy(sparse_map(rs, 6, 48, 80)).view(3, 2, 48, 80)
    raw = torch.zeros(0)
    rest = (20.0, 32, 10, 50, True, 128)
    got = torch.func.vmap(lambda n: detect.select_corners_op(
        n, raw, NO_PLANES, *rest))(nms)
    for i in range(3):
        alone = detect.select_corners_op(nms[i], raw, NO_PLANES, *rest)
        _assert_outputs_equal([x[i] for x in got], alone, f"frame {i}")


@pytest.mark.parametrize("mode", ["patch", "raw", "dense"])
def test_select_op_opcheck(mode):
    """``torch.library.opcheck``: schema, fake kernel, autograd
    registration and AOT dispatch on the CPU kernel (dense: with kernel
    B's planes, the descriptors too)."""
    rs = np.random.RandomState(2)
    nms = torch.from_numpy(sparse_map(rs, 2, 40, 72))
    raw = nms + 1.0 if mode != "patch" else torch.zeros(0)
    planes = (torch.from_numpy(rs.randint(-2**31, 2**31 - 1, (2, 8, 40, 72),
                                          dtype=np.int64).astype(np.int32))
              if mode == "dense" else NO_PLANES)
    torch.library.opcheck(detect.select_corners_op,
                          (nms, raw, planes, 20.0, 32, 8, 30, True, 128))


@pytest.mark.parametrize("spread", [True, False],
                         ids=["uint8-dither", "float-no-dither"])
def test_dense_select_descriptors_match_lvt_tpu(spread):
    """The dense mode's selection with kernel B's planes: each slot's
    descriptor and its validity equal lvt_tpu's ``descriptors_from_planes``
    (lvt_tpu/ops/brief.py:234-251) at lvt_tpu's selected integer corners
    and validity, every slot (zeros where invalid, within the border or
    padded); the selection's other outputs as without the planes."""
    from lvt_tpu.ops import brief as jx_brief

    rs = np.random.RandomState(12)
    b, h, w = 2, 96, 128
    raw = rs.randint(0, 60, (b, h, w)).astype(np.float32)
    if not spread:
        raw = raw + rs.rand(b, h, w).astype(np.float32)
    nms = np.where(rs.rand(b, h, w) < 0.05, raw, 0).astype(np.float32)
    planes = rs.randint(-2**31, 2**31 - 1, (b, 8, h, w),
                        dtype=np.int64).astype(np.int32)
    cap, args = 192, (20.0, 32, 16, 200, spread)
    got = detect.select_corners_op(
        torch.from_numpy(nms), torch.from_numpy(raw),
        torch.from_numpy(planes), *args, cap)
    alone = _select_port(nms, raw, spread, cap, *args[:4])
    _assert_outputs_equal(got[:8], alone[:8], "select_corners, planes")
    want, _ = _select_jax(nms, raw, spread, cap, *args[:4])
    corner = np.where(want["valid"][..., None], want["corner"], 0.0)
    jd, jv = jax.vmap(jx_brief.descriptors_from_planes)(
        jnp.asarray(planes.view(np.uint32)), jnp.asarray(corner),
        jnp.asarray(want["valid"]))
    np.testing.assert_array_equal(got[9].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got[8].numpy(),
                                  np.asarray(jd).view(np.int32))
    border = (~np.asarray(jv) & want["valid"]).sum()
    assert np.asarray(jv).sum() > 20 and border > 0
    _assert_outputs_equal(got, detect.select_corners_plain(
        torch.from_numpy(nms), torch.from_numpy(raw),
        torch.from_numpy(planes), *args, cap), "select_corners_plain")


# ---- the map match after kernel T

# ---- the premise of csrc/select.cu: one thread-block cluster per cell

def _cluster_select(nms, spread, cap, threshold, cell, per_cell, low,
                    cluster):
    """A numpy model of the kernel's selection at ``cluster`` blocks per
    cell: block rank r holds the cell's rows [r R, (r + 1) R) (R =
    ceil(s_y / cluster)) as 32-bit order-preserving values; a radix select
    8 bits a pass adds the ranks' histograms of the values sharing the
    prefix and stops once a bin holds exactly what is still needed; the
    values at the k-th largest T (a bin left after 32 bits) are cut lowest
    cell index first, rank by rank; each survivor's slot is the count of
    the cell's survivors with a larger 64-bit key. Returns the selection's
    outputs xi, yi, score, valid [B, capacity] as select_corners_plain
    gives them."""
    b, h, w = nms.shape
    s_y, s_x, _, ncx = detect._cell_geometry(h, w, cell)
    n = s_y * s_x
    vals = detect.cell_values(torch.from_numpy(nms), h, w, cell,
                              spread).numpy()
    bits = (vals + np.float32(0.0)).view(np.int32)
    u = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).view(np.uint32) ^ \
        np.uint32(0x80000000)
    rows = -(-s_y // cluster)
    ranges = [(min(n, r * rows * s_x), min(n, (r + 1) * rows * s_x))
              for r in range(cluster)]
    ncells = vals.shape[1]
    idx = np.zeros((b, ncells, per_cell), np.int64)
    for bi in range(b):
        for c in range(ncells):
            uc = u[bi, c]
            pre, msk, need, exact = 0, 0, per_cell, False
            for shift in (24, 16, 8, 0):
                hist = sum(np.bincount((uc[lo:hi][(uc[lo:hi] & msk) == pre]
                                        >> shift) & 0xFF, minlength=256)
                           for lo, hi in ranges)
                run, d = 0, 255
                while run + hist[d] < need:
                    run += hist[d]
                    d -= 1
                need -= run
                pre |= d << shift
                msk |= 0xFF << shift
                if hist[d] == need:
                    exact = True
                    break
            take = (uc & msk) >= pre if exact else uc > pre
            if not exact:
                below = 0
                for lo, hi in ranges:
                    ties = lo + np.nonzero(uc[lo:hi] == pre)[0]
                    take[ties[:min(len(ties), max(0, need - below))]] = True
                    below += len(ties)
            sel = np.nonzero(take)[0]
            assert len(sel) == per_cell
            keys = (uc[sel].astype(np.uint64) << np.uint64(32)) | \
                (n - 1 - sel).astype(np.uint64)
            idx[bi, c, (keys[None, :] > keys[:, None]).sum(1)] = sel
    cy, cx = np.arange(ncells) // ncx, np.arange(ncells) % ncx
    y2 = (cy[:, None] * s_y + idx // s_x).reshape(b, -1)
    x2 = (cx[:, None] * s_x + idx % s_x).reshape(b, -1)
    xi, yi = np.minimum(x2, w - 1), np.minimum(y2, h - 1)
    v = np.where((y2 < h) & (x2 < w), nms[np.arange(b)[:, None], yi, xi],
                 np.float32(0.0))
    if spread:
        d = detect._dither_at(torch.from_numpy(y2), torch.from_numpy(x2))
        d = d.numpy()
        v = (v + d) - d
    t, t_low = detect._thresholds(threshold)
    t_eff = np.where((v > np.float32(t)).sum(1) < low, np.float32(t_low),
                     np.float32(t))
    pad = cap - xi.shape[1]
    return [np.pad(a, ((0, 0), (0, pad))) for a in
            (xi.astype(np.int32), yi.astype(np.int32), v.astype(np.float32),
             v > t_eff[:, None])]


def _cluster_case(name):
    """(nms, spread, capacity, threshold, cell, per_cell, low) of this
    file's selection cases, TUM fr1's one cell, and cells with fewer
    non-zero pixels than they keep (ties at 0 without the dither)."""
    rs = np.random.RandomState(11)
    if name == "sparse":
        return sparse_map(rs, 2, 64, 96), True, 128, 20.0, 32, 12, 200
    if name == "float":
        nms = sparse_map(rs, 2, 64, 96)
        return (nms * rs.uniform(0.5, 1.5, nms.shape).astype(np.float32),
                False, 128, 20.0, 32, 12, 200)
    if name == "plateau":
        nms = np.zeros((1, 64, 128), np.float32)
        nms[0, 8:56:2, 4:124:2] = 40.0
        nms[0, 10:50:8, 9:100:6] = 55.0
        return nms, False, 256, 20.0, 32, 20, 200
    if name == "ragged":
        return (sparse_map(rs, 2, 70, 150, density=0.08), True, 256, 20.0,
                32, 16, 200)
    if name == "fallback":
        return (sparse_map(rs, 3, 64, 128, density=0.02), True, 512, 25.0,
                32, 24, 100)
    if name == "zeros":   # fewer non-zero pixels than a cell keeps
        return (sparse_map(rs, 2, 64, 96, density=0.003), False, 128, 20.0,
                32, 12, 200)
    if name == "dense-bin":   # many values in T's first bin: more passes
        nms = np.where(rs.rand(2, 128, 256) < 0.4,
                       rs.uniform(32, 64, (2, 128, 256)), 0)
        return nms.astype(np.float32), True, 256, 20.0, 128, 100, 200
    if name == "zeros-wide":   # ... ties at 0 over a wider cell
        return (sparse_map(rs, 2, 128, 192, density=0.002), False, 256,
                20.0, 64, 40, 200)
    nms = sparse_map(rs, 1, 480, 640, density=0.01)   # TUM fr1's one cell
    return nms, True, 1024, 20.0, 640, 1000, 200


@pytest.mark.parametrize("cluster", [1, 4, 8, 16])
@pytest.mark.parametrize("name", ["sparse", "float", "plateau", "ragged",
                                  "fallback", "zeros", "zeros-wide",
                                  "dense-bin", "tum"])
def test_cluster_selection_model_is_the_plain_version(name, cluster):
    """The kernel's cluster design (rank ranges of cell index, a 32-bit
    value select with the lowest-index tie cut, slots by counting) gives
    select_corners_plain's slots bit for bit at 1, 4, 8 and 16 blocks per
    cell, dither on and off (ties at the k-th value and at 0), and a
    dense first bin (more passes)."""
    nms, spread, cap, threshold, cell, per_cell, low = _cluster_case(name)
    got = _cluster_select(nms, spread, cap, threshold, cell, per_cell, low,
                          cluster)
    want = detect.select_corners_plain(
        torch.from_numpy(nms), torch.zeros(0), NO_PLANES, threshold, cell,
        per_cell, low, spread, cap)
    for a, bw, label in zip(got, (want[0], want[1], want[4], want[5]),
                            ("xi", "yi", "score", "valid")):
        np.testing.assert_array_equal(a, bw.numpy(), err_msg=label)


def _jax_map_match(monkeypatch, narrow, wide, visible, valid, kp, kw):
    """lvt_tpu's find_map_matches with its top-2 stage returning
    ``narrow`` and ``wide`` (lvt_tpu's own acceptance, resolution, retry
    and claims after T), over map points that project in view where
    ``visible`` (identity pose, 10 m ahead) and behind the camera where
    not; then lvt_tpu's step glue before PnP (core/step.py:400-401)."""
    m, k = visible.shape[0], kp.shape[0]
    pts = np.zeros((m, 3), np.float32)
    pts[:, 2] = np.where(visible, 10.0, -10.0)
    monkeypatch.setattr(
        jx_matching, "dual_radius_top2",
        lambda *a, **_: (tuple(map(jnp.asarray, narrow)),
                         tuple(map(jnp.asarray, wide))))
    desc = np.zeros((k, 8), np.uint32)
    zeros = np.zeros(k, np.float32)
    mm = jx_matching.find_map_matches(
        jnp.asarray(pts), jnp.zeros((m, 8), jnp.uint32),
        jnp.ones((m,), bool), JxPose(jnp.zeros(3), jnp.array([1.0, 0, 0, 0])),
        JxFeatures(*map(jnp.asarray, (kp, desc, zeros, zeros, valid))),
        fx=100.0, fy=100.0, cx=50.0, cy=50.0, near=0.1, far=100.0,
        min_x=0.0, max_x=100.0, min_y=0.0, max_y=100.0, tracking_radius=10,
        use_kernel=False, use_mxu=False, **kw)
    np.testing.assert_array_equal(np.asarray(mm.visible), visible)
    obs = jnp.asarray(kp)[jnp.clip(mm.match_idx, 0, k - 1)]
    weights = (mm.match_idx >= 0).astype(jnp.float32)
    return dict(match_idx=mm.match_idx, d1=mm.d1, d2=mm.d2,
                feature_matched=mm.feature_matched,
                matches_count=mm.matches_count,
                used_wide_radius=mm.used_wide_radius, obs=obs,
                weights=weights)


@pytest.mark.parametrize("case", ["narrow", "wide"])
def test_map_accept_matches_lvt_tpu(monkeypatch, case):
    """The cases the rule tells apart: invisible queries, no candidate, one
    (the absolute test), two or more (the ratio test), features claimed by
    several queries at one distance (the lower query wins), the narrow
    radius sufficing or the wide retry."""
    rs = np.random.RandomState(1 + (case == "wide"))
    m, k = 300, 200
    narrow, wide, visible, valid, kp = accept_problem(rs, m, k, case)
    kw = dict(ratio_threshold=0.8, abs_threshold=30.0, retry_min_matches=40)
    fout, iout = top2._pack(tuple(map(torch.from_numpy, narrow)),
                            tuple(map(torch.from_numpy, wide)))
    feats = FrameFeatures(torch.from_numpy(kp), None, None, None,
                          torch.from_numpy(valid))
    got = matching.map_accept(fout, iout, torch.from_numpy(visible), feats,
                              **kw)
    want = _jax_map_match(monkeypatch, narrow, wide, visible, valid, kp, kw)
    for name in matching.ACCEPT_FIELDS:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    assert bool(got["used_wide_radius"]) == (case == "wide")
    idx = got["match_idx"].numpy()
    assert (idx == -2).any() and (idx == -1).any() and (idx >= 0).any()
    n_used = (wide if case == "wide" else narrow)[3]
    assert (n_used == 0).any() and (n_used == 1).any() and (n_used > 1).any()


def test_map_accept_op_is_its_plain_version():
    """The op's CPU kernel is the plain version stream by stream."""
    args = accept_args(np.random.RandomState(5), 3, 128, 96, "cpu")
    got = matching.map_accept_op(*args, 0.8, 30.0, 20)
    for i in range(3):
        want = matching.map_accept_plain(
            *top2._unpack(args[0][i], args[1][i]), args[2][i], args[3][i],
            args[4][i], ratio_threshold=0.8, abs_threshold=30.0,
            retry_min_matches=20)
        _assert_outputs_equal([x[i] for x in got],
                              [want[n] for n in matching.ACCEPT_FIELDS],
                              f"stream {i}")


def test_map_accept_vmap_rule_is_each_stream_alone():
    """Under ``torch.func.vmap`` over S = 3 streams (the multi-stream step)
    the rule's one call gives each stream the bits of its own call."""
    fout, iout, vis, valid, kp = accept_args(np.random.RandomState(7), 3,
                                             160, 120, "cpu")
    kw = dict(ratio_threshold=0.8, abs_threshold=30.0, retry_min_matches=30)
    got = torch.func.vmap(lambda f, g, v, fv, p: tuple(matching.map_accept(
        f, g, v, FrameFeatures(p, None, None, None, fv), **kw).values()))(
            fout, iout, vis, valid, kp)
    for i in range(3):
        alone = matching.map_accept(
            fout[i], iout[i], vis[i],
            FrameFeatures(kp[i], None, None, None, valid[i]), **kw)
        _assert_outputs_equal([x[i] for x in got], list(alone.values()),
                              f"stream {i}")


def test_map_accept_op_opcheck():
    args = accept_args(np.random.RandomState(4), 2, 64, 48, "cpu", ("wide",))
    torch.library.opcheck(matching.map_accept_op, (*args, 0.8, 30.0, 20))


def test_find_map_matches_through_the_op_matches_lvt_tpu():
    """The port's find_map_matches (projection, kernel T's plain version,
    then the op) against lvt_tpu's on a scene whose narrow radius matches
    few: the wide retry's matches, claims and observations."""
    rs = np.random.RandomState(12)
    m, k = 256, 320
    kp = rs.uniform([0, 0], [320, 240], (k, 2)).astype(np.float32)
    desc = rs.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    valid = rs.rand(k) > 0.1
    src = rs.choice(k, 60, replace=False)
    uv = kp[src] + rs.uniform(-30, 30, (60, 2)).astype(np.float32)
    depth = rs.uniform(4.0, 40.0, 60)
    pts = rs.uniform([-20, -10, -5], [20, 10, 80], (m, 3)).astype(np.float32)
    pts[:60, 0] = (uv[:, 0] - 160.0) / 260.0 * depth
    pts[:60, 1] = (uv[:, 1] - 120.0) / 260.0 * depth
    pts[:60, 2] = depth
    mdesc = rs.randint(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    mdesc[:60] = desc[src]
    mvalid = rs.rand(m) > 0.05
    cam = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, near=0.5, far=150.0,
               min_x=0.0, max_x=320.0, min_y=0.0, max_y=240.0)
    kw = dict(tracking_radius=12, ratio_threshold=0.9, abs_threshold=80.0,
              retry_min_matches=50, **cam)
    zeros = np.zeros(k, np.float32)
    t = np.zeros(3, np.float32)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

    def i32(a):
        return torch.from_numpy(a.view(np.int32).copy())

    got = matching.find_map_matches(
        torch.from_numpy(pts), i32(mdesc), torch.from_numpy(mvalid),
        Pose(torch.from_numpy(t), torch.from_numpy(q)),
        FrameFeatures(torch.from_numpy(kp), i32(desc),
                      torch.from_numpy(zeros), torch.from_numpy(zeros),
                      torch.from_numpy(valid)), **kw)
    want = jx_matching.find_map_matches(
        jnp.asarray(pts), jnp.asarray(mdesc), jnp.asarray(mvalid),
        JxPose(jnp.asarray(t), jnp.asarray(q)),
        JxFeatures(*map(jnp.asarray, (kp, desc, zeros, zeros, valid))),
        use_kernel=False, use_mxu=False, **kw)
    for name in ("match_idx", "d1", "d2", "feature_matched",
                 "matches_count", "used_wide_radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    idx = np.asarray(want.match_idx)
    np.testing.assert_array_equal(got.obs.numpy(),
                                  kp[np.clip(idx, 0, k - 1)])
    np.testing.assert_array_equal(got.weights.numpy(),
                                  (idx >= 0).astype(np.float32))
    assert bool(got.used_wide_radius) and int(got.matches_count) > 10


# ---- map_accept_kernel's order (csrc/track.cu), modelled in numpy

IMAX = np.iinfo(np.int32).max
# (M, K, edge) of tests/test_torch_cuda.py's accept_edge and accept_retry
ACCEPT_MODEL_CASES = [(1024, 1536, None), (1024, 1536, "retry_at"),
                      (1024, 1536, "retry_below"), (1024, 1536, "invisible"),
                      (1024, 1536, "ties"), (50, 300, None),
                      (4096, 896, None), (8192, 1024, "ties"),
                      (1024, 1536, "best_k"), (4096, 896, "best_k")]


def _match(fout, iout, r, lo, hi, ratio, abs_th, m):
    """Queries [lo, hi) at radius r: d1, d2, the accepted target and the
    key (distance x (M + 1) + query)."""
    d1, d2 = fout[0, r, lo:hi], fout[1, r, lo:hi]
    idx = np.where((((iout[1, r, lo:hi] >= 2) & (d1 < np.float32(ratio) * d2))
                    | ((iout[1, r, lo:hi] == 1) & (d1 <= np.float32(abs_th)))),
                   iout[0, r, lo:hi], -1)
    key = (np.where(idx >= 0, d1, 0).astype(np.int32) * np.int32(m + 1)
           + np.arange(lo, hi, dtype=np.int32))
    return d1, d2, idx, key


def _accept_model(fout, iout, visible, fvalid, kp, ratio, abs_th, retry_min,
                  threads):
    """map_accept of one stream (numpy) in map_accept_kernel's order with a
    block of ``threads``: both radii's keys by atomic minima over tiles of
    the queries, each radius's count the number of minima that found their
    target's key unset (targets 0..K), summed per thread, per warp, then
    over the warps' sums; the claims read from the keys; tile 0's outputs
    from what its threads loaded first, later tiles' from the radius used
    loaded again; the observations from the staged keypoints."""
    m, k = visible.shape[0], fvalid.shape[0]
    keys = np.full((2, k + 1), IMAX, np.int32)
    won = np.zeros((2, threads), np.int64)   # first claims, per thread
    for lo in range(0, m, threads):
        for r in (0, 1):
            _, _, idx, key = _match(fout, iout, r, lo, min(m, lo + threads),
                                    ratio, abs_th, m)
            for t in np.nonzero(idx >= 0)[0]:
                won[r, t] += keys[r, idx[t]] == IMAX
                keys[r, idx[t]] = min(keys[r, idx[t]], key[t])
    won = won.reshape(2, -1, 32).sum(2).sum(1)
    wide = bool(won[0] < retry_min)
    ku = keys[int(wide)]
    out = [np.zeros(m, np.int64), np.zeros(m, np.float32),
           np.zeros(m, np.float32), None, None, None,
           np.zeros((m, 2), np.float32), np.zeros(m, np.float32)]
    for lo in range(0, m, threads):
        hi = min(m, lo + threads)
        d1, d2, idx, key = _match(fout, iout, int(wide), lo, hi, ratio,
                                  abs_th, m)
        ok = (idx >= 0) & (ku[np.clip(idx, 0, k)] == key)
        mi = np.where(visible[lo:hi], np.where(ok, idx, -1), -2)
        out[0][lo:hi], out[1][lo:hi], out[2][lo:hi] = mi, d1, d2
        out[6][lo:hi], out[7][lo:hi] = kp[np.clip(mi, 0, k - 1)], mi >= 0
    out[3] = (ku[:k] != IMAX) & fvalid
    out[4], out[5] = np.int64(won[int(wide)]), wide
    return out


@pytest.mark.parametrize("threads", [1024, 64])
@pytest.mark.parametrize("m,k,edge", ACCEPT_MODEL_CASES,
                         ids=["m%d-k%d-%s" % c for c in ACCEPT_MODEL_CASES])
def test_map_accept_kernel_model_is_the_plain_version(m, k, edge, threads):
    """csrc/track.cu's map_accept_kernel as a numpy model (tiles of a
    block's threads, the counts from the minima that found a target's key
    unset, the claims from the keys) against map_accept_plain, stream by
    stream, every output equal: the narrow count at the retry's threshold
    and one below it, no query visible, ties on one feature, more features
    than queries, M = 4096 and 8192, accepted targets of K (counted, never
    claimed)."""

    args = accept_args(np.random.RandomState(m + threads), 2, m, k, "cpu",
                       edge=edge)
    retry = accept_retry(args, edge, m)
    want = matching.map_accept_op(*args, 0.8, 30.0, retry)
    for i in range(2):
        got = _accept_model(*(x[i].numpy() for x in args), 0.8, 30.0, retry,
                            threads)
        for name, g, w in zip(matching.ACCEPT_FIELDS, got, want):
            np.testing.assert_array_equal(np.asarray(g), w[i].numpy(),
                                          err_msg=f"{name} stream {i}")
    idx = want[0].numpy()
    if edge in ("retry_at", "retry_below"):
        assert bool(want[5][0]) == (edge == "retry_below")
    if edge == "invisible":
        assert (idx == -2).all() and not want[4].any()
    if edge == "best_k":
        assert (idx == k).any()
    if edge == "ties":
        assert ((idx == 5).sum(1) <= 1).all()
