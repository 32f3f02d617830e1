"""The hand-written CUDA kernels (lvt_tpu_torch/csrc) against their plain
PyTorch versions, and the wrappers' contract.

Tests marked ``cuda`` need an NVIDIA GPU with nvcc and skip elsewhere.
On a GPU machine without JAX, skip tests/conftest.py (it imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: none — kernels A, B, P and T (one stream, or S streams in one
launch) are bit-exact with their plain
versions by construction (integer arithmetic, or on float frames A's f32
sums in the plain version's order; float comparisons; packed integer
keys; and P's subpixel fit in the plain version's order of f32
operations, rounded to nearest). PnP's two reduction ops sum in another
order than their plain versions by design (one fixed order per stream,
the same at every S): each output within 1e-5 of the sum of its terms'
magnitudes, and every stream of an S-stream launch bit-equal to its own
S = 1 launch. PnP's whole solve (``lvt_tpu_torch::pnp_solve``) against
its plain version (``solve_pnp_plain``, whose 6x6 step is cuSOLVER's and
not the kernel's LU): pose within 1e-4 m and 1e-4 rad, inlier count
equal, chi2 within 1e-4 of the plain chi2 or of reprojection_th2 where
the plain chi2 is below it (a fit of a few points has a chi2 near 0),
also with 3-6 valid points, none, or all at one pixel; every stream of an
S-stream launch and the sharded solve's phases (all-reduces as
identities) bit-equal to the fused kernel. Local BA's whole body
(``lvt_tpu_torch::ba_refine``) against its plain version
(``refine_structure_plain``): every output bit-equal, and every stream
of an S-stream launch bit-equal to its own; the sharded body's phases
(``lvt_tpu_torch::ba_phase``) on one rank bit-equal to it, and each
stream to its own S = 1 phases. The tracking ops that launch their
kernels under a group (``track.GROUP_OPS``), on a one-rank group:
bit-equal to their plain group versions. Local BA as a CUDA IF node
(core/graphs.py::cond): the graph bit-equal to the eager step, in the
streaming worker thread too, and many streams with BA bit-equal to each
stream alone. The unmarked tests run
anywhere: a wrapper given a tensor that is not on the CPU launches its
kernel or raises, never falls back.
"""

import collections
import contextlib
import os
from collections import Counter

import numpy as np
import pytest
import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.core.track import CLUSTERS
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import hamming, patches, perception, top2
from lvt_tpu_torch.parallel.dryrun import device_launches
from lvt_tpu_torch.solver import pnp


# the tracking branch's five ops (core/track.py, csrc/track.cu), of which
# two are thread-block cluster kernels
TRACK_OPS = ("predict_project", "upkeep_pre", "staged_promote",
             "triangulate_insert", "ba_observe")
CLUSTER_OPS = TRACK_OPS[2:4]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _frames(rs, b, h, w):
    return rs.randint(0, 256, (b, h, w)).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 376, 1241), (1, 37, 53), (3, 64, 96),
    # ragged for kernel A's 64x32 tiles and 4-pixel groups: w % 4 = 1, 2,
    # 3; h below the 4-row halo and not a multiple of 32; batch 1 and 3
    (3, 33, 65), (1, 70, 130), (3, 41, 131), (1, 3, 7), (1, 6, 250)])
@pytest.mark.parametrize("frames", ["uint8", "float32", "float32-fraction"])
def test_perception_kernel_matches_plain(cuda, shape, frames):
    rs = np.random.RandomState(0)
    imgs = _frames(rs, *shape)
    if frames == "float32-fraction":   # non-integer frames (ROADMAP H4)
        imgs = imgs + rs.rand(*shape).astype(np.float32)
    dtype = torch.uint8 if frames == "uint8" else torch.float32
    imgs = torch.from_numpy(imgs).to(cuda, dtype)
    before = perception.perception_patch_maps_batched.launches
    got = perception.perception_patch_maps_batched(imgs)
    torch.cuda.synchronize()
    assert perception.perception_patch_maps_batched.launches == before + 1
    for g, w in zip(got, perception.perception_plain(imgs)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 376, 1241), (1, 37, 53), (3, 64, 96),
                                   (1, 5, 131)])
@pytest.mark.parametrize("values", ["integer", "special"])
def test_brief_kernel_matches_plain(cuda, shape, values):
    rs = np.random.RandomState(3)
    smooth = rs.randint(0, 20656, shape).astype(np.float32)
    smooth[:, ::5] = 4321.0                       # ties compare false
    if values == "special":
        # non-integers, negatives, -0.0 beside 0.0, infinities and NaN,
        # and runs of ties
        smooth = (smooth - 10000.0) * rs.rand(*shape).astype(np.float32)
        pick = rs.randint(0, 8, shape)
        smooth[pick == 0] = -0.0
        smooth[pick == 1] = 0.0
        smooth[pick == 2] = np.inf
        smooth[pick == 3] = -np.inf
        smooth[pick == 4] = np.nan
        smooth[:, :, 7:19] = 2.5
    smooth = torch.from_numpy(smooth).to(cuda)
    before = perception.brief_planes.launches
    got = perception.brief_planes(smooth)
    torch.cuda.synchronize()
    assert perception.brief_planes.launches == before + 1
    assert got.shape == (shape[0], 8, *shape[1:]) and got.dtype == torch.int32
    assert torch.equal(got, perception.brief_planes_plain(smooth))


def _desc(rs, n):
    return rs.randint(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1536, 77])
@pytest.mark.parametrize("selected", ["some", "none"])
def test_patch_kernel_matches_plain(cuda, k, selected):
    """Kernel P (describe + refine) against its plain composition: desc,
    valid and kp bit-equal for every slot, on integer-valued maps (ties
    in the comparisons and flat parabolas) with corners anywhere."""
    rs = np.random.RandomState(1)
    h, w = 376, 1241
    smooth = torch.from_numpy(rs.randint(0, 8, (2, h, w)).astype(np.float32))
    raw = torch.from_numpy(rs.randint(0, 60, (2, h, w)).astype(np.float32))
    x = torch.from_numpy(rs.randint(-4, w + 4, (2, k)).astype(np.int32))
    y = torch.from_numpy(rs.randint(-4, h + 4, (2, k)).astype(np.int32))
    xc, yc = patches.clamp_coords(x, y, h, w)
    sel = torch.from_numpy(rs.rand(2, k) > (0.3 if selected == "some" else 2))
    args = [t.to(cuda) for t in (smooth, raw, xc, yc, x, y, sel)] + [h, w]
    before = patches.describe_refine_batched.launches
    got = patches.describe_refine_batched(*args)
    torch.cuda.synchronize()
    assert patches.describe_refine_batched.launches == before + 1
    want = patches.describe_refine_plain(*args)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert got[1].any() == (selected == "some")


T_MODES = ["dual", "single", "row", "row_dual"]


def _row_queries(rs, shape):
    """Row-mode queries: left keypoints [..., M, 2] whose rows reach past
    both image edges, one at a fraction under a row, a NaN row (no window)
    and whole rows at the window's edges; the triangulation's exclusion
    and the BA's set, which overlap."""
    q = rs.uniform(0, 300, (*shape, 2)).astype(np.float32)
    y = q[..., 1]
    y[..., 2::17] = -3.0
    y[..., 3::17] = 301.5
    y[..., 4::17] = np.float32(np.nextafter(np.float32(120.0), 0))
    y[..., 5::29] = np.nan
    y[..., 6::11] = np.floor(y[..., 6::11])
    return q, rs.rand(*shape) > 0.6, rs.rand(*shape) > 0.5


def _top2_kw(mode):
    if mode.startswith("row"):
        return dict(row_mode=True, row_radius=2.0, img_rows=300.0)
    return dict(r2a=25.0**2, r2b=(50.0 if mode == "dual" else 25.0)**2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", T_MODES)
@pytest.mark.parametrize("mk", [(1024, 1536), (1536, 1536), (101, 2048),
                                (3, 333)])
def test_top2_kernel_matches_plain(cuda, mode, mk):
    """Kernel T (Hamming distances + masked dual top-2) against the matrix
    followed by the plain top-2: equal bit for bit, with duplicate
    target descriptors, invalid query rows, and M not a multiple of the
    kernel's 4 rows per block (row modes: the window computed inside from
    each keypoint, NaN and rows past the edges among them; the dual row
    launch's second predicate equal to a single launch of its set)."""
    rs = np.random.RandomState(2)
    m, k = mk
    t_desc = _desc(rs, k)
    t_desc[1::3] = t_desc[::3][:t_desc[1::3].shape[0]]
    q_desc = _desc(rs, m)
    t_kp = torch.from_numpy(rs.uniform(0, 300, (k, 2)).astype(np.float32))
    sets = []
    if mode.startswith("row"):
        q, excl, incl = _row_queries(rs, (m,))
        q = torch.from_numpy(q)
        sets = [excl] + [incl] * (mode == "row_dual")
    else:
        q = torch.from_numpy(rs.uniform(0, 300, (m, 2)).astype(np.float32))
    kw = _top2_kw(mode)
    q_valid = rs.rand(m) > 0.1
    q_valid[:2] = False
    args = [torch.from_numpy(a).to(cuda) for a in (q_desc, t_desc)] + [
        q.to(cuda), torch.from_numpy(q_valid).to(cuda), t_kp.to(cuda),
        torch.from_numpy(rs.rand(k) > 0.1).to(cuda)] + [
        torch.from_numpy(x).to(cuda) for x in sets]
    before = top2.hamming_top2.launches
    got = top2.hamming_top2(*args, **kw)
    torch.cuda.synchronize()
    assert top2.hamming_top2.launches == before + 1
    want = top2.hamming_top2_plain(*args, **kw)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    if mode == "row_dual":
        alone = top2.hamming_top2(*args[:6], ~args[7], **kw)
        _equal_outputs((got[1],), (alone[0],))
        _equal_outputs((got[0],), top2.hamming_top2(*args[:7], **kw)[:1])


def _top2_streams(rs, s, m, k, mode, device):
    """Kernel T's arguments for ``s`` streams ([S, ...], contiguous) with
    duplicate targets and invalid rows (row modes: ``_row_queries``), and
    its keyword arguments."""
    t_desc = np.stack([_desc(rs, k) for _ in range(s)])
    t_desc[:, 1::3] = t_desc[:, ::3][:, :t_desc[:, 1::3].shape[1]]
    q_desc = np.stack([_desc(rs, m) for _ in range(s)])
    t_kp = rs.uniform(0, 300, (s, k, 2)).astype(np.float32)
    sets = []
    if mode.startswith("row"):
        q, excl, incl = _row_queries(rs, (s, m))
        sets = [excl] + [incl] * (mode == "row_dual")
    else:
        q = rs.uniform(0, 300, (s, m, 2)).astype(np.float32)
    q_valid = rs.rand(s, m) > 0.1
    q_valid[:, :2] = False
    args = [torch.from_numpy(a).to(device) for a in (
        q_desc, t_desc, q, q_valid, t_kp, rs.rand(s, k) > 0.1, *sets)]
    return args, _top2_kw(mode)


def _equal_outputs(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", T_MODES)
@pytest.mark.parametrize("s", [1, 3, 8, 20])
@pytest.mark.parametrize("mk", [(1024, 1536), (101, 2048), (3, 333)])
def test_top2_batched_launch_matches_plain(cuda, mode, s, mk):
    """Kernel T over a stream axis: one launch for S streams, bit-equal to
    the plain version stream by stream, at ragged M and K."""
    args, kw = _top2_streams(np.random.RandomState(s), s, *mk, mode, cuda)
    before = top2.hamming_top2.launches
    got = top2.hamming_top2_batched(*args, **kw)
    torch.cuda.synchronize()
    assert top2.hamming_top2.launches == before + 1
    _equal_outputs(got, top2.hamming_top2_plain_batched(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dual", "single"])
def test_top2_kernel_at_tum_map_match_shape(cuda, mode):
    """M = 8192 map points against K = 1024 keypoints (TUM fr1's map
    match): 2048 row blocks."""
    args, kw = _top2_streams(np.random.RandomState(8), 1, 8192, 1024, mode,
                             cuda)
    _equal_outputs(top2.hamming_top2_batched(*args, **kw),
                   top2.hamming_top2_plain_batched(*args, **kw))
    got = top2.hamming_top2(*(a[0] for a in args), **kw)
    _equal_outputs(tuple(tuple(x.cpu() for x in o) for o in got),
                   top2.hamming_top2_plain(*(a[0].cpu() for a in args),
                                           **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", T_MODES)
def test_top2_single_stream_is_a_batch_of_one(cuda, mode):
    """The single-stream call (S = 1) gives the bits of the plain version,
    which the kernel before the stream axis matched bit for bit, and each
    stream of a batched launch gives the bits of its own single launch."""
    args, kw = _top2_streams(np.random.RandomState(11), 5, 700, 1536, mode,
                             cuda)
    batched = top2.hamming_top2_batched(*args, **kw)
    for i in range(5):
        one = [a[i] for a in args]
        got = top2.hamming_top2(*one, **kw)
        _equal_outputs(tuple(tuple(x.cpu() for x in o) for o in got),
                       top2.hamming_top2_plain(*(a.cpu() for a in one), **kw))
        _equal_outputs(got, tuple(tuple(x[i] for x in o) for o in batched))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dual", "row_dual"])
@pytest.mark.parametrize("unbatched", [None, 2, 5])
def test_top2_vmap_rule_launches_once(cuda, unbatched, mode):
    """Under torch.func.vmap the single-stream call reaches the kernel in
    one launch for all streams, an unbatched argument expanded."""
    args, kw = _top2_streams(np.random.RandomState(12), 4, 300, 500, mode,
                             cuda)
    in_dims = [0] * len(args)
    if unbatched is not None:
        in_dims[unbatched] = None
        args[unbatched] = args[unbatched][0]
    before = top2.hamming_top2.launches
    got = torch.func.vmap(lambda *a: top2.hamming_top2(*a, **kw),
                          in_dims=tuple(in_dims))(*args)
    torch.cuda.synchronize()
    assert top2.hamming_top2.launches == before + 1
    full = [a if d == 0 else a.expand(4, *a.shape).contiguous()
            for a, d in zip(args, in_dims)]
    _equal_outputs(got, top2.hamming_top2_plain_batched(*full, **kw))


@pytest.mark.cuda
def test_top2_kernel_all_invalid(cuda):
    """No valid query or no valid target: every row comes back empty
    (BIG, BIG, 0, 0), as in the plain version."""
    rs = np.random.RandomState(4)
    m, k = 37, 64
    d = [torch.from_numpy(_desc(rs, n)).to(cuda) for n in (m, k)]
    meta = [torch.zeros(n, 2, device=cuda) for n in (m, k)]
    for qv, tv in ((False, True), (True, False)):
        args = (d[0], d[1], meta[0], torch.full((m,), qv, device=cuda),
                meta[1], torch.full((k,), tv, device=cuda))
        got = top2.hamming_top2(*args, r2a=4.0, r2b=9.0)
        for g, w in zip(got, top2.hamming_top2_plain(*args, r2a=4.0,
                                                     r2b=9.0)):
            for a, b in zip(g, w):
                assert torch.equal(a, b)
        assert not got[0][3].any() and (got[0][0] == hamming.BIG).all()


def _pnp_inputs(rs, s, m, device):
    """PnP's normal-equation inputs for ``s`` streams of ``m`` points:
    Jacobian columns at the main path's scales, Cauchy-like weights with
    a fifth of the points masked, pixel residuals."""
    jac = rs.randn(s, m, 2, 6) * [1e3, 1e3, 3e2, 5e2, 8e2, 4e2]
    w = rs.rand(s, m) * (rs.rand(s, m) > 0.2)
    r = rs.randn(s, m, 2) * 2.0
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (jac, w, r)]


def _pnp_close(got, jac, w, r):
    """got (hg [S, 6, 7], h_diag [S, 6]) within 1e-5 of each entry's sum
    of term magnitudes of the plain version, stream by stream."""
    for i in range(jac.shape[0]):
        want = pnp.normal_equations_plain(jac[i], w[i], r[i])
        scale = pnp.normal_equations_plain(jac[i].abs(), w[i], r[i].abs())
        for g, x, sc in zip((got[0][i], got[1][i]), want, scale):
            assert ((g - x).abs() <= 1e-5 * sc + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("m", [1024, 8192, 300, 7])
def test_pnp_normal_eqs_kernel_matches_plain(cuda, s, m):
    """The op over S streams in one launch: within its tolerance of the
    plain version, H's diagonal equal to h_diag, and each stream bit-equal
    to its own S = 1 launch (the sum order does not depend on S); M up to
    TUM fr1's 8192 and ragged against the 256 threads of a block."""
    jac, w, r = _pnp_inputs(np.random.RandomState(s + m), s, m, cuda)
    before = pnp.normal_equations.launches
    got = pnp.pnp_normal_eqs_op(jac, w, r)
    torch.cuda.synchronize()
    assert pnp.normal_equations.launches == before + 1
    _pnp_close(got, jac, w, r)
    assert torch.equal(torch.diagonal(got[0][:, :, :6], dim1=1, dim2=2),
                       got[1])
    for i in range(s):
        one = pnp.normal_equations(jac[i], w[i], r[i])
        assert torch.equal(one[0], got[0][i]) and torch.equal(one[1],
                                                             got[1][i])


@pytest.mark.cuda
def test_pnp_normal_eqs_refuses_wide_on_the_card(cuda):
    """The float64 (``wide``) normal equations are the CPU's only (the
    CPU's sharded phases): on the card the op raises before it launches,
    alone and under vmap."""
    jac, w, r = _pnp_inputs(np.random.RandomState(4), 2, 256, cuda)
    before = pnp.normal_equations.launches
    with pytest.raises(ValueError, match="wide"):
        pnp.pnp_normal_eqs_op(jac, w, r, True)
    with pytest.raises(ValueError, match="wide"):
        torch.func.vmap(lambda *a: pnp.normal_equations(*a, wide=True))(
            jac, w, r)
    assert pnp.normal_equations.launches == before


@pytest.mark.cuda
def test_pnp_normal_eqs_vmap_rule_launches_once(cuda):
    """Under torch.func.vmap the single-stream call reaches the kernel in
    one launch for all streams, with the bits of the direct launch."""
    jac, w, r = _pnp_inputs(np.random.RandomState(5), 4, 1024, cuda)
    before = pnp.normal_equations.launches
    got = torch.func.vmap(pnp.normal_equations)(jac, w, r)
    torch.cuda.synchronize()
    assert pnp.normal_equations.launches == before + 1
    want = pnp.pnp_normal_eqs_op(jac, w, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("n", [1024, 8192, 300, 7])
def test_stream_sum_kernel_matches_plain(cuda, s, n):
    """The sum op over S streams in one launch: within 1e-5 of the sum of
    magnitudes of each stream's plain ``x.sum()``, each stream bit-equal
    to its own S = 1 launch, and one launch under vmap."""
    rs = np.random.RandomState(s + n)
    x = torch.from_numpy((rs.randn(s, n) * 3).astype(np.float32)).to(cuda)
    before = pnp.stream_sum.launches
    got = pnp.stream_sum_op(x)
    torch.cuda.synchronize()
    assert pnp.stream_sum.launches == before + 1
    for i in range(s):
        assert abs(float(got[i] - x[i].sum())) <= 1e-5 * float(
            x[i].abs().sum())
        assert torch.equal(pnp.stream_sum(x[i]), got[i])
    before = pnp.stream_sum.launches
    assert torch.equal(torch.func.vmap(pnp.stream_sum)(x), got)
    assert pnp.stream_sum.launches == before + 1


PNP_CAM = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.21)


def _quat_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _pnp_problem(rs, s, m, device, n_out=None):
    """``s`` streams of a PnP problem with ``m`` points each, as the
    tracking step poses it: world points 4-80 m deep in view, their pixels
    at a true pose with 0.5 px noise, the first ``n_out`` of them outliers
    (20-90 px off; by default an eighth), a tenth masked, and an initial
    pose off by about 0.2 m and 0.01 -> (t [S, 3], q [S, 4], points, obs,
    weights) on ``device``."""
    cam = PNP_CAM
    n_out = m // 8 if n_out is None else n_out
    out = [[] for _ in range(5)]
    for _ in range(s):
        z = rs.uniform(4.0, 80.0, m)
        pts = np.stack([(rs.uniform(50, 1191, m) - cam["cx"]) * z / cam["fx"],
                        (rs.uniform(30, 346, m) - cam["cy"]) * z / cam["fy"],
                        z], -1)
        w3 = rs.randn(3) * 0.05
        th = np.linalg.norm(w3)
        q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * w3 / th])
        t = rs.randn(3) * 0.5
        pc = (pts - t) @ _quat_matrix(q)       # world -> camera: R^T (x - t)
        uv = np.stack([cam["fx"] * pc[:, 0] / pc[:, 2] + cam["cx"],
                       cam["fy"] * pc[:, 1] / pc[:, 2] + cam["cy"]], -1)
        uv += rs.randn(m, 2) * 0.5
        uv[:n_out] += rs.uniform(20, 90, (n_out, 2))
        q0 = q + rs.randn(4) * 0.01
        for acc, x in zip(out, (t + rs.randn(3) * 0.2, q0 / np.linalg.norm(q0),
                                pts, uv, rs.rand(m) > 0.1)):
            acc.append(x)
    return [torch.from_numpy(np.stack(x).astype(np.float32)).to(device)
            for x in out]


def _angle(a, b) -> float:
    """Rotation angle between two quaternions, in float64."""
    rel = quat.multiply(quat.normalize(a.double()),
                        quat.conjugate(quat.normalize(b.double())))
    return float(2 * torch.atan2(rel[1:].norm(), rel[0].abs()))


def _pnp_results(out, i):
    """Stream i of pnp_solve's outputs as (t, q, inlier, count, chi2)."""
    return tuple(x[i] for x in out)


def _pnp_edge(args, case):
    """``_pnp_problem``'s streams at an edge of the solve: ``few``, stream
    i keeps 3 + i % 4 valid points (the fit of 3-6 points has a chi2 near
    0, where the LM accept tests sit on ties); ``none``, every weight 0
    (H and g 0, the step 0, nothing accepted); ``one_pixel``, every point
    the first one, at one pixel (H of rank 2, the damped system near
    singular)."""
    t, q, pts, obs, w = args
    if case == "few":
        k = 3 + torch.arange(w.shape[0], device=w.device)[:, None] % 4
        w = w * (torch.cumsum(w, -1) <= k)
    elif case == "none":
        w = torch.zeros_like(w)
    elif case == "one_pixel":
        pts = pts[:, :1].expand_as(pts).contiguous()
        obs = obs[:, :1].expand_as(obs).contiguous()
        w = torch.ones_like(w)
    elif case == "ray":
        ray = torch.linspace(0.5, 3.0, pts.shape[1], device=pts.device)
        pts = (t[:, None] + ray[None, :, None] * (pts[:, :1] - t[:, None])
               ).contiguous()
        obs = obs[:, :1].expand_as(obs).contiguous()
        w = torch.ones_like(w)
    return [t, q, pts, obs, w]


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,case", [
    (1, 256, "outliers"), (1, 1024, "outliers"), (1, 4096, "outliers"),
    (8, 256, "outliers"), (8, 1024, "outliers"), (8, 4096, "outliers"),
    (2, 9000, "outliers"), (8, 1024, "few"), (2, 256, "none"),
    (2, 1024, "one_pixel"), (1, 8193, "outliers"), (16, 1024, "outliers"),
    (1, 1, "small"), (2, 255, "small"), (2, 257, "small"), (4, 64, "ray")])
def test_pnp_solve_kernel_matches_plain(cuda, s, m, case):
    """The fused solve against the plain version stream by stream (pose
    within 1e-4 m and 1e-4 rad, inlier count equal, chi2 within 1e-4 of
    the plain chi2 or of reprojection_th2 where the plain chi2 is below
    it), every stream of the S-stream launch bit-equal to its own S = 1
    launch; M = 9000 reads the points beyond the kernel's shared-memory
    stage from device memory (8193: one point past it); ``few``,
    ``none``, ``one_pixel`` and ``ray`` are the solve's edges
    (``_pnp_edge``); ``small`` M (1, and 255 and 257 about the block's 256
    threads) has no extra outliers."""
    args = _pnp_problem(np.random.RandomState(7 * s + m), s, m, cuda,
                        0 if case == "small" else None)
    if case not in ("outliers", "small"):
        args = _pnp_edge(args, case)
    before = pnp.pnp_solve.launches
    got = pnp.pnp_solve(*args, **PNP_CAM)
    torch.cuda.synchronize()
    assert pnp.pnp_solve.launches == before + 1
    for i in range(s):
        t, q, inlier, count, chi2 = _pnp_results(got, i)
        want = pnp.solve_pnp_plain(Pose(args[0][i], args[1][i]),
                                   *(x[i] for x in args[2:]), **PNP_CAM)
        dt = float((t - want.pose.t).norm())
        da = _angle(q, want.pose.q)
        rel = float((chi2 - want.chi2).abs()
                    / want.chi2.abs().clamp(min=5.991))
        assert dt < 1e-4 and da < 1e-4 and rel < 1e-4, (i, dt, da, rel)
        assert int(count) == int(want.inlier_count) == int(inlier.sum())
        assert torch.equal(inlier, want.inlier_mask)
        if case == "outliers":
            assert int(count) < int(args[4][i].sum()) - m // 16
        elif case == "none":
            assert int(count) == 0
        one = pnp.pnp_solve(*(x[i:i + 1] for x in args), **PNP_CAM)
        for a, b in zip(one, got):
            assert torch.equal(a[0], b[i])


PNP_EXACT_CASES = [(1, 1, "small"), (2, 255, "small"), (2, 257, "small"),
                   (1, 8193, "outliers"), (16, 1024, "outliers"),
                   (2, 1024, "one_pixel"), (4, 64, "ray"), (8, 1024, "few"),
                   (2, 256, "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,case", PNP_EXACT_CASES)
def test_pnp_solve_kernel_is_the_plain_version_bit_for_bit(cuda, s, m, case):
    """Every output of the fused solve bit-equal to the plain version's on
    the card, stream by stream: M of 1, about the block's 256 threads and
    one past the shared-memory stage, 16 streams, and the edges whose LM
    steps are rejected (``ray``: every point on one ray from the camera,
    a singular system; ``one_pixel``; ``few``; ``none``)."""
    args = _pnp_problem(np.random.RandomState(5 * s + m), s, m, cuda,
                        0 if case == "small" else None)
    if case not in ("outliers", "small"):
        args = _pnp_edge(args, case)
    got = pnp.pnp_solve(*args, **PNP_CAM)
    for i in range(s):
        want = pnp.solve_pnp_plain(Pose(args[0][i], args[1][i]),
                                   *(x[i] for x in args[2:]), **PNP_CAM)
        for a, b in zip(_pnp_results(got, i),
                        (*want.pose, want.inlier_mask, want.inlier_count,
                         want.chi2)):
            assert torch.equal(a, b), (case, i)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m", [(1, 1024), (8, 1024), (8, 4096)])
def test_pnp_normal_eqs_h_is_not_bit_symmetric(cuda, s, m):
    """The premise of summing H's upper triangle alone fails: jw_i = jac_i
    w is rounded to float32 before its product with jac_j, so H[i][j] and
    H[j][i] add other products, and the op's H (the sums pnp_solve also
    takes) is symmetric only to rounding, not to the bit. pnp_solve keeps
    all 42 sums."""
    jac, w, r = _pnp_inputs(np.random.RandomState(s * m), s, m, cuda)
    h = pnp.pnp_normal_eqs_op(jac, w, r)[0][..., :6]
    torch.cuda.synchronize()
    ht = h.transpose(-1, -2)
    assert not torch.equal(h, ht)
    assert ((h - ht).abs() <= 1e-5 * h.abs().amax((-1, -2), keepdim=True)
            ).all()


@pytest.mark.cuda
def test_pnp_solve_launches_on_every_device_and_thread(cuda):
    """M = 4096 needs 96 KB of dynamic shared memory, above the default
    48 KB: the kernel's limit is raised for the device current at each
    launch, so a solve runs on every card present, whichever was current,
    and from a thread that never launched before; each bit-equal to the
    first card's."""
    import threading

    args = _pnp_problem(np.random.RandomState(3), 2, 4096, cuda)
    want = pnp.pnp_solve(*args, **PNP_CAM)
    n = torch.cuda.device_count()
    for d in range(n):
        dev = torch.device("cuda", d)
        with torch.cuda.device(n - 1 - d):
            got = pnp.pnp_solve(*(x.to(dev) for x in args), **PNP_CAM)
        torch.cuda.synchronize(dev)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
    out = []
    worker = threading.Thread(
        target=lambda: out.append(pnp.pnp_solve(*args, **PNP_CAM)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    for a, b in zip(out[0], want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m", [(1, 1024), (8, 1024), (1, 4096), (2, 9000)])
def test_pnp_phases_equal_the_fused_kernel(cuda, s, m):
    """The sharded solve's phases with the all-reduces as identities (no
    group: one rank) under vmap over the streams: N_PHASES launches, and
    every output bit-equal to the fused kernel's."""
    args = _pnp_problem(np.random.RandomState(m + s), s, m, cuda)
    fused = pnp.pnp_solve(*args, **PNP_CAM)
    before = pnp.pnp_phase.launches
    res = torch.func.vmap(lambda t, q, *a: tuple(pnp.solve_pnp_phases(
        Pose(t, q), *a, **PNP_CAM)))(*args)
    torch.cuda.synchronize()
    assert pnp.pnp_phase.launches == before + pnp.N_PHASES
    (t, q), inlier, count, chi2 = res
    for a, b in zip((t, q, inlier, count, chi2), fused):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pnp_solve_vmap_rule_launches_once(cuda):
    args = _pnp_problem(np.random.RandomState(11), 3, 1024, cuda)
    before = pnp.pnp_solve.launches
    res = torch.func.vmap(lambda t, q, *a: tuple(pnp.solve_pnp(
        Pose(t, q), *a, **PNP_CAM)))(*args)
    torch.cuda.synchronize()
    assert pnp.pnp_solve.launches == before + 1
    (t, q), inlier, count, chi2 = res
    for a, b in zip((t, q, inlier, count, chi2),
                    pnp.pnp_solve(*args, **PNP_CAM)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("solve", ["fused", "phases"])
def test_pnp_solve_captures_in_a_graph_without_syncs(cuda, solve):
    """One stream's solve: 0 host syncs eagerly, captured in a CUDA graph,
    and the replay bit-equal to the eager call."""
    from lvt_tpu_torch.parallel.dryrun import count_syncs

    t, q, *rest = (x[0] for x in _pnp_problem(np.random.RandomState(5), 1,
                                              1024, cuda))
    fn = pnp.solve_pnp if solve == "fused" else pnp.solve_pnp_phases

    def call():
        res = fn(Pose(t, q), *rest, **PNP_CAM)
        return (*res.pose, *res[1:])

    eager, syncs = count_syncs(call)
    assert syncs == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(static, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    imgs = torch.zeros(2, 40, 48, dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError):
        perception.perception_patch_maps_batched(imgs)
    desc = torch.zeros(8, 8, dtype=torch.int32, device=cuda)
    tdesc = torch.zeros(16, 8, dtype=torch.int32, device=cuda)
    q = torch.zeros(2, 8, device=cuda).T           # not contiguous
    ok = torch.ones(8, dtype=torch.bool, device=cuda)
    tk = torch.zeros(16, 2, device=cuda)
    tv = torch.ones(16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        top2.hamming_top2(desc, tdesc, q, ok, tk, tv, r2a=1.0, r2b=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(16 * 8 + 1, dtype=torch.int32, device=cuda)
        top2.hamming_top2(desc, flat[1:].view(16, 8), q.contiguous(), ok, tk,
                          tv, r2a=1.0, r2b=1.0)
    with pytest.raises(ValueError, match="K="):
        top2.hamming_top2(desc, torch.zeros(4096, 8, dtype=torch.int32,
                                            device=cuda), q.contiguous(), ok,
                          torch.zeros(4096, 2, device=cuda),
                          torch.ones(4096, dtype=torch.bool, device=cuda),
                          r2a=1.0, r2b=1.0)


@pytest.mark.cuda
def test_main_path_on_the_card_matches_the_cpu(cuda):
    """A few synthetic frames through VOSystem on both devices: the
    extracted features are bit-equal and the poses agree within 1e-4 m."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.core.extract import extract_features_stereo
    from lvt_tpu_torch.core.system import TrackingState, VOSystem

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    cfg = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                   baseline=world.baseline, img_width=320, img_height=240,
                   detection_cell_size=80, max_keypoints_per_cell=60,
                   agast_threshold=15, near_plane_distance=0.5,
                   far_plane_distance=150.0)
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(4, speed=0.5)]
    il = torch.from_numpy(np.stack([f[0] for f in frames]))
    ir = torch.from_numpy(np.stack([f[1] for f in frames]))
    for g, c in zip(extract_features_stereo(il[1].to(cuda), ir[1].to(cuda),
                                            cfg),
                    extract_features_stereo(il[1], ir[1], cfg)):
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
    gpu, cpu = VOSystem(cfg, device=cuda), VOSystem(cfg, device="cpu")
    pg, _ = gpu.track_chunk(il.to(cuda), ir.to(cuda))
    pc, _ = cpu.track_chunk(il, ir)
    assert gpu.get_state() == TrackingState.TRACKING
    torch.testing.assert_close(pg.t.cpu(), pc.t, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_dense_ba_path_on_the_card_matches_the_cpu(cuda):
    """Path 2 (dense descriptors, local BA on) through VOSystem on both
    devices over 6 frames, BA running at frame 4: features bit-equal and
    poses within 1e-3 m, the bound chip_smoke.py holds over a span with BA
    runs."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.core.extract import extract_features_stereo
    from lvt_tpu_torch.core.system import TrackingState, VOSystem

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    cfg = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                   baseline=world.baseline, img_width=320, img_height=240,
                   detection_cell_size=80, max_keypoints_per_cell=60,
                   agast_threshold=15, near_plane_distance=0.5,
                   far_plane_distance=150.0, descriptor_mode="dense",
                   local_ba_window=4, local_ba_every=4)
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(6, speed=0.5)]
    il = torch.from_numpy(np.stack([f[0] for f in frames]))
    ir = torch.from_numpy(np.stack([f[1] for f in frames]))
    before = perception.brief_planes.launches
    for g, c in zip(extract_features_stereo(il[1].to(cuda), ir[1].to(cuda),
                                            cfg),
                    extract_features_stereo(il[1], ir[1], cfg)):
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
    assert perception.brief_planes.launches == before + 1
    gpu, cpu = VOSystem(cfg, device=cuda), VOSystem(cfg, device="cpu")
    pg, mg = gpu.track_chunk(il.to(cuda), ir.to(cuda))
    pc, mc = cpu.track_chunk(il, ir)
    assert gpu.get_state() == TrackingState.TRACKING
    assert torch.equal(mg.local_ba_ran.cpu(), mc.local_ba_ran)
    assert bool(mc.local_ba_ran[4])
    torch.testing.assert_close(pg.t.cpu(), pc.t, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_multistream_on_the_card_matches_the_cpu(cuda, sensor):
    """MultiStreamVO with 2 streams of different content over 4 frames on
    both devices: poses within 1e-4 m, and kernel T launched once per
    site for both streams (3 per stereo frame, 2 per RGB-D frame)."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.state import TRACKING
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    kw = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
              baseline=0.3, n_points=1500, extent_x=40.0, extent_y=18.0,
              extent_z=90.0)
    worlds = [SyntheticWorld(**kw), SyntheticWorld(**kw, seed=99)]
    cfg = VOConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, baseline=0.3,
                   img_width=320, img_height=240, detection_cell_size=80,
                   max_keypoints_per_cell=60, agast_threshold=15,
                   near_plane_distance=0.5, far_plane_distance=150.0,
                   triangulation_policy=2 if sensor == "rgbd" else 1)
    seqs = [list(w.rgbd_sequence(4, speed=0.5) if sensor == "rgbd"
                 else w.stereo_sequence(4, speed=0.5)) for w in worlds]
    a = torch.from_numpy(np.stack([[np.clip(f[0], 0, 255).astype(np.uint8)
                                    for f in fs] for fs in zip(*seqs)]))
    b = torch.from_numpy(np.stack([[
        f[1].astype(np.float32) if sensor == "rgbd"
        else np.clip(f[1], 0, 255).astype(np.uint8) for f in fs]
        for fs in zip(*seqs)]))
    rgbd = sensor == "rgbd"
    gpu = MultiStreamVO(cfg, 2, device=cuda, rgbd=rgbd)
    cpu = MultiStreamVO(cfg, 2, device="cpu", rgbd=rgbd)
    (pg, _), ran = device_launches(
        lambda: gpu.track_chunk(a.to(cuda), b.to(cuda)))
    # the graph's warm-up step and 4 replays, T once per site for both
    # streams (what the card ran: a wrapper counts only Python calls)
    assert ran["hamming_top2"] == 5 * (2 if rgbd else 3)
    pc, _ = cpu.track_chunk(a, b)
    assert (gpu.status == TRACKING).all()
    torch.testing.assert_close(pg.t.cpu(), pc.t, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_rectified_path_on_the_card_matches_the_cpu(cuda):
    """Raw EuRoC frames through VOSystem(rectify_maps=...) on both devices:
    the remapped pair and its features bit-equal, the poses of 4 frames
    within 1e-4 m, kernel T twice per frame at the EuRoC config's sites."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core import step
    from lvt_tpu_torch.core.extract import extract_features_stereo
    from lvt_tpu_torch.core.system import TrackingState, VOSystem
    from lvt_tpu_torch.io import datasets

    rs = np.random.RandomState(5)
    points = np.stack([rs.uniform(-15, 15, 2500), rs.uniform(-8, 8, 2500),
                       rs.uniform(2.0, 30.0, 2500)], -1)
    shade = rs.uniform(60.0, 215.0, 2500)
    raw = [np.stack([datasets.render_euroc_raw(points, shade,
                                               np.array([0, 0, 0.2 * i]), rt)
                     for i in range(4)]) for rt in (False, True)]
    il, ir = (torch.from_numpy(x) for x in raw)
    p = datasets.EUROC_P
    cfg = VOConfig(fx=float(p[0, 0]), fy=float(p[1, 1]), cx=float(p[0, 2]),
                   cy=float(p[1, 2]), baseline=datasets.EUROC_BASELINE,
                   img_width=752, img_height=480, agast_threshold=15,
                   detection_cell_size=160, max_keypoints_per_cell=60,
                   near_plane_distance=0.5, far_plane_distance=100.0,
                   staged_threshold=0)
    maps = datasets.euroc_rectify_maps()
    mc = [torch.from_numpy(m) for m in maps]
    rc = step._rectify_pair(il[0], ir[0], *mc)
    rg = step._rectify_pair(il[0].to(cuda), ir[0].to(cuda),
                            *(m.to(cuda) for m in mc))
    for g, c in zip(rg, rc):
        assert torch.equal(g.cpu(), c)
    for g, c in zip(extract_features_stereo(*rg, cfg),
                    extract_features_stereo(*rc, cfg)):
        for a, b in zip(g, c):
            assert torch.equal(a.cpu(), b)
    gpu = VOSystem(cfg, device=cuda, rectify_maps=maps)
    cpu = VOSystem(cfg, device="cpu", rectify_maps=maps)
    (pg, _), ran = device_launches(
        lambda: gpu.track_chunk(il.to(cuda), ir.to(cuda)))
    assert ran["hamming_top2"] == 5 * 2   # the warm-up step, 4 replays
    pc, _ = cpu.track_chunk(il, ir)
    assert gpu.get_state() == TrackingState.TRACKING
    torch.testing.assert_close(pg.t.cpu(), pc.t, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_external_corners_on_the_card_match_the_cpu(cuda):
    """track_with_external_corners on both devices over 4 frames, corners
    from the port's own extraction: the descriptors at the corners
    bit-equal, the poses within 1e-4 m; kernel T three times per frame,
    kernels A and P never."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.extract import (describe_external_corners,
                                            extract_features)
    from lvt_tpu_torch.core.system import TrackingState, VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    cfg = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                   baseline=world.baseline, img_width=320, img_height=240,
                   detection_cell_size=80, max_keypoints_per_cell=60,
                   agast_threshold=15, near_plane_distance=0.5,
                   far_plane_distance=150.0)

    def corners(img):
        f = extract_features(torch.from_numpy(img), cfg)
        return f.kp[f.valid].numpy()

    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(4, speed=0.5)]
    seq = [(l, r, corners(l), corners(r)) for l, r in frames]
    l0, _, c0, _ = seq[0]
    cap = cfg.kp_capacity
    pad = np.zeros((cap, 2), np.float32)
    pad[:len(c0)] = c0
    valid = torch.from_numpy(np.arange(cap) < len(c0))
    args = (torch.from_numpy(l0), torch.from_numpy(pad), valid)
    fc = describe_external_corners(*args, cfg)
    fg = describe_external_corners(*(a.to(cuda) for a in args), cfg)
    for a, b in zip(fg, fc):
        assert torch.equal(a.cpu(), b)
    gpu, cpu = VOSystem(cfg, device=cuda), VOSystem(cfg, device="cpu")
    pg, ran = device_launches(
        lambda: [gpu.track_with_external_corners(*f) for f in seq])
    # the warm-up step and 4 replays: T at 3 sites, no A, no P
    assert [ran[k] for k in ("hamming_top2", "perception",
                             "describe_refine")] == [5 * 3, 0, 0]
    pc = [cpu.track_with_external_corners(*f) for f in seq]
    assert gpu.get_state() == TrackingState.TRACKING
    torch.testing.assert_close(torch.stack([p.t.cpu() for p in pg]),
                               torch.stack([p.t for p in pc]), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_kitti_cli_on_the_card_is_the_in_process_run(cuda, tmp_path):
    """``python -m lvt_tpu_torch kitti`` on the card (its default device)
    over a small tree (tests/test_cli.py's world and YAML, PNGs by
    chip_smoke's writer: the GPU machine has no OpenCV) writes, byte for
    byte, the trajectory of an in-process ``track_chunk`` run on the card
    over the decoded frames in the same chunks."""
    import chip_smoke
    from lvt_tpu_torch.cli import main
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.datasets import KittiSequence
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.io.trajectory import dump_kitti

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    seq_dir = tmp_path / "sequences" / "03"
    for side in ("image_0", "image_1"):
        (seq_dir / side).mkdir(parents=True)
    for i, (l, r, _) in enumerate(world.stereo_sequence(10, speed=0.5)):
        chip_smoke.write_png(str(seq_dir / "image_0" / f"{i:06d}.png"),
                             l.astype(np.uint8))
        chip_smoke.write_png(str(seq_dir / "image_1" / f"{i:06d}.png"),
                             r.astype(np.uint8))
    calib, cfg = tmp_path / "calib_03.yaml", tmp_path / "vo.yaml"
    calib.write_text("camera_matrix:\n  data: [260.0, 0.0, 160.0, 0.0, "
                     "260.0, 120.0, 0.0, 0.0, 1.0]\nbaseline: 0.3\n")
    cfg.write_text("near_plane_distance: 0.5\nfar_plane_distance: 150.0\n"
                   "agast_threshold: 15\ndetection_cell_size: 80\n"
                   "max_keypoints_per_cell: 60\nmax_map_points: 1024\n"
                   "max_staged_points: 1024\n")
    out = tmp_path / "03.txt"
    assert main(["kitti", "--sequences-dir", str(tmp_path / "sequences"),
                 "--seq", "3", "--calib", str(calib), "--config", str(cfg),
                 "--output", str(out), "--chunk", "4"]) == 0
    seq = KittiSequence(str(tmp_path / "sequences"), 3, str(calib))
    vo = VOSystem(seq.configure(load_config(str(cfg))), device=cuda)
    frames, poses = list(seq), []
    for c in range(0, len(frames), 4):
        p, m = vo.track_chunk(np.stack([f[0] for f in frames[c:c + 4]]),
                              np.stack([f[1] for f in frames[c:c + 4]]))
        assert (m.status == 2).all()
        poses += [type(p)(t, q) for t, q in zip(p.t, p.q)]
    want = tmp_path / "in_process.txt"
    dump_kitti(str(want), poses)
    assert len(out.read_text().splitlines()) == 10
    assert out.read_bytes() == want.read_bytes()


@pytest.mark.cuda
def test_collectives_vmap_rule_on_cuda_tensors(cuda):
    """The collectives over 2 ranks sharing the card (gloo carries CUDA
    tensors through the host), under vmap against a loop of unbatched
    calls: equal, one collective per batched call, no vmap fallback."""
    from lvt_tpu_torch.parallel import dryrun

    res = dryrun.spawn([dryrun.job(dryrun.collectives_check, device="cuda")],
                       2, device="cuda", backend="gloo")
    x = sum(np.arange(12, dtype=np.float32).reshape(3, 4) * (r + 1)
            for r in range(2))
    for rank, (c,) in enumerate(res):
        assert (c["axis_index"], c["axis_size"]) == (rank, 2)
        np.testing.assert_array_equal(c["psum"], x)
        assert c["batched_equal"] == {"psum": True, "pmin": True,
                                      "por": True}
        assert c["batched_calls"] == 3 and c["fallback_warnings"] == []


@pytest.mark.cuda
def test_one_rank_nccl_sharded_stream_is_vosystem(cuda):
    """ShardedStreamVO on a 1-rank NCCL group over 8 frames: poses,
    statuses and map size bit-equal to VOSystem on the card (one rank's
    collectives return their input; the sums round as unsharded)."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.parallel import dryrun

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    cfg = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                   baseline=world.baseline, img_width=320, img_height=240,
                   detection_cell_size=80, max_keypoints_per_cell=60,
                   agast_threshold=15, near_plane_distance=0.5,
                   far_plane_distance=150.0, local_ba_window=4)
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(8, speed=0.5)]
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    ((r,),) = dryrun.spawn([dryrun.job(dryrun.sharded_stream, cfg, il, ir,
                                       chunk=8, device="cuda")], 1,
                           device="cuda", backend="nccl")
    vo = VOSystem(cfg, device=cuda)
    poses, metrics = vo.track_chunk(il, ir)
    assert r["backend"] == "nccl"
    np.testing.assert_array_equal(r["poses"][0], poses.t.cpu().numpy())
    np.testing.assert_array_equal(r["poses"][1], poses.q.cpu().numpy())
    np.testing.assert_array_equal(r["metrics"].status,
                                  metrics.status.cpu().numpy())
    assert r["map_size"] == vo.map_size


@pytest.mark.parametrize("call", ["perception", "brief", "patches", "top2",
                                  "pnp", "stream_sum", "pnp_solve",
                                  "pnp_phase", "ba_refine", "ba_phase",
                                  *TRACK_OPS,
                                  "select_corners", "map_accept"])
def test_wrapper_never_falls_back_off_the_cpu(call):
    """A tensor on another device than the CPU goes to the kernel path,
    whose argument checks refuse anything that is not on a CUDA device."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if call in TRACK_OPS:
            args = _track_problem(np.random.RandomState(0), call, 1, "cpu")
            _track_wrapper(call, [x.to("meta") if isinstance(x, torch.Tensor)
                                  else x for x in args])
        elif call == "select_corners":
            from lvt_tpu_torch.ops import detect

            detect.select_slots(torch.empty(2, 40, 48, **meta), 20.0,
                                cell_size=16, max_per_cell=4,
                                corners_low_threshold=10, spread_ties=True,
                                capacity=128)
        elif call == "map_accept":
            from lvt_tpu_torch.core.features import FrameFeatures
            from lvt_tpu_torch.ops import matching

            matching.map_accept(
                torch.empty(2, 2, 5, **meta),
                torch.empty(2, 2, 5, dtype=torch.int64, **meta),
                torch.empty(5, dtype=torch.bool, **meta),
                FrameFeatures(torch.empty(6, 2, **meta), None, None, None,
                              torch.empty(6, dtype=torch.bool, **meta)),
                ratio_threshold=0.8, abs_threshold=30.0, retry_min_matches=4)
        elif call == "perception":
            perception.perception_patch_maps_batched(
                torch.empty(2, 40, 48, dtype=torch.uint8, **meta))
        elif call == "brief":
            perception.brief_planes(torch.empty(2, 40, 48, **meta))
        elif call == "stream_sum":
            pnp.stream_sum(torch.empty(5, **meta))
        elif call == "pnp_solve":
            pnp.pnp_solve(torch.empty(1, 3, **meta), torch.empty(1, 4, **meta),
                          torch.empty(1, 5, 3, **meta),
                          torch.empty(1, 5, 2, **meta),
                          torch.empty(1, 5, **meta), **PNP_CAM)
        elif call == "pnp_phase":
            pnp.pnp_phase(pnp.K_SETUP, 0, torch.empty(1, pnp.NSTATE, **meta),
                          torch.empty(1, 5, **meta),
                          torch.empty(1, 5, 3, **meta),
                          torch.empty(1, 5, 2, **meta), None, None, **PNP_CAM)
        elif call == "ba_refine":
            from lvt_tpu_torch.solver import bundle

            w = torch.empty(4, 5, **meta)
            x = torch.empty(4, 5, 2, **meta)
            bundle.ba_refine(Pose(torch.empty(4, 3, **meta),
                                  torch.empty(4, 4, **meta)),
                             torch.empty(5, 3, **meta), x, w, x, w,
                             iterations=6, reprojection_th2=5.991, **BA_CAM)
        elif call == "ba_phase":
            from lvt_tpu_torch.solver import bundle

            w = torch.empty(1, 4, 5, **meta)
            x = torch.empty(1, 4, 5, 2, **meta)
            bundle.ba_phase(bundle.K_GATE1, 0, None, None,
                            torch.empty(1, 4, 3, **meta),
                            torch.empty(1, 4, 4, **meta),
                            torch.empty(1, 5, 3, **meta), x, w, x, w, None,
                            iterations=6, reprojection_th2=5.991, **BA_CAM)
        elif call == "pnp":
            pnp.normal_equations(torch.empty(5, 2, 6, **meta),
                                 torch.empty(5, **meta),
                                 torch.empty(5, 2, **meta))
        elif call == "patches":
            f = torch.empty(2, 40, 48, **meta)
            i = torch.empty(2, 5, dtype=torch.int32, **meta)
            patches.describe_refine_batched(
                f, f, i, i, i, i, torch.empty(2, 5, dtype=torch.bool, **meta),
                40, 48)
        else:
            d = torch.empty(4, 8, dtype=torch.int32, **meta)
            top2.hamming_top2(
                d, torch.empty(6, 8, dtype=torch.int32, **meta),
                torch.empty(4, 2, **meta),
                torch.empty(4, dtype=torch.bool, **meta),
                torch.empty(6, 2, **meta),
                torch.empty(6, dtype=torch.bool, **meta), r2a=1.0, r2b=1.0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_library_name_follows_the_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path == kernels.library_path()
    assert path.name.startswith("liblvt_tpu_torch_") and path.suffix == ".so"
    assert {p.name for p in kernels.CSRC.glob("*.cu")} == {
        "perception.cu", "brief.cu", "patches.cu", "top2.cu", "pnp.cu",
        "pnp_lm.cu", "graph_cond.cu", "ba.cu", "track.cu", "select.cu",
        "tail.cu"}


def test_ptxas_report_picks_one_kernels_lines():
    """``kernels.ptxas_report``: of a verbose build's report, the lines on
    the kernel whose mangled name holds the name asked for (its stack
    frame and spills, then its registers and shared memory), none of
    another kernel's."""
    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113"
        "set_if_kernelEyPKb' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113"
        "set_if_kernelEyPKb\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 8 registers, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "ba_refine_kernelEPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116"
        "ba_refine_kernelEPKfS1_\n"
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 40664 bytes "
        "smem, 504 bytes cmem[0]\n")
    assert kernels.ptxas_report("ba_refine_kernel", report) == [
        "16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 168 registers, used 1 barriers, 40664 bytes smem, 504 bytes "
        "cmem[0]"]
    assert kernels.ptxas_report("no_such_kernel", report) == []


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source (all started before any is waited on), then one
    link of the objects; the objects are removed afterwards. A stand-in
    nvcc records its arguments and writes its output file."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then touch "$2"; fi; shift\n'
        "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    out = kernels.build()
    assert out.exists() and out.parent == tmp_path / "build"
    lines = log.read_text().splitlines()
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    compiles = [line for line in lines if " -c " in line]
    assert sorted(line.rsplit("/", 1)[1] for line in compiles) == sources
    assert all("arch=compute_90a,code=sm_90a" in line for line in lines)
    link = [line for line in lines if "-shared" in line]
    assert len(link) == 1 and link[0].count(".o") == len(sources)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [out.name]


def _graph_case(entry: str, device):
    """A small system of entry point ``entry`` and its frames: (make() ->
    a new system on ``device``, chunk(system, lo, hi) -> (poses, metrics)
    of frames lo .. hi - 1, the number of frames)."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.extract import extract_features
    from lvt_tpu_torch.core.system import SensorType, VOSystem
    from lvt_tpu_torch.io import datasets
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    n = 6
    kw = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
              baseline=0.3, n_points=1500, extent_x=40.0, extent_y=18.0,
              extent_z=90.0)
    world = SyntheticWorld(**kw)
    cfg = VOConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, baseline=0.3,
                   img_width=320, img_height=240, detection_cell_size=80,
                   max_keypoints_per_cell=60, agast_threshold=15,
                   near_plane_distance=0.5, far_plane_distance=150.0)
    u8 = lambda x: np.clip(x, 0, 255).astype(np.uint8)  # noqa: E731

    def chunks(make, a, b):
        a, b = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        return make, lambda vo, lo, hi: vo.track_chunk(a[lo:hi], b[lo:hi]), n

    if entry in ("stereo", "stereo_dense_ba", "stereo_sparse"):
        if entry == "stereo_dense_ba":
            cfg = cfg.replace(descriptor_mode="dense", local_ba_window=4,
                              local_ba_every=2)
        if entry == "stereo_sparse":
            cfg = cfg.replace(descriptor_mode="sparse")
        seq = list(world.stereo_sequence(n, speed=0.5))
        return chunks(lambda: VOSystem(cfg, device=device),
                      np.stack([u8(f[0]) for f in seq]),
                      np.stack([u8(f[1]) for f in seq]))
    if entry in ("rgbd", "rgbd_ba"):
        cfg = cfg.replace(triangulation_policy=2)
        if entry == "rgbd_ba":
            # local BA with no right camera: the kernel runs on its
            # schedule with no stereo pair and refines no point
            cfg = cfg.replace(local_ba_window=4, local_ba_every=2)
        seq = list(world.rgbd_sequence(n, speed=0.5))
        return chunks(lambda: VOSystem(cfg, SensorType.RGBD, device=device),
                      np.stack([u8(f[0]) for f in seq]),
                      np.stack([f[1].astype(np.float32) for f in seq]))
    if entry == "multistream":
        worlds = [world, SyntheticWorld(**kw, seed=99)]
        seqs = [list(w.stereo_sequence(n, speed=0.5)) for w in worlds]
        return chunks(lambda: MultiStreamVO(cfg, 2, device=device),
                      np.stack([[u8(f[0]) for f in fs] for fs in zip(*seqs)]),
                      np.stack([[u8(f[1]) for f in fs] for fs in zip(*seqs)]))
    if entry == "rectified":
        rs = np.random.RandomState(5)
        points = np.stack([rs.uniform(-15, 15, 2500),
                           rs.uniform(-8, 8, 2500),
                           rs.uniform(2.0, 30.0, 2500)], -1)
        shade = rs.uniform(60.0, 215.0, 2500)
        raw = [np.stack([datasets.render_euroc_raw(
            points, shade, np.array([0, 0, 0.2 * i]), rt) for i in range(n)])
            for rt in (False, True)]
        p = datasets.EUROC_P
        cfg = VOConfig(fx=float(p[0, 0]), fy=float(p[1, 1]),
                       cx=float(p[0, 2]), cy=float(p[1, 2]),
                       baseline=datasets.EUROC_BASELINE, img_width=752,
                       img_height=480, agast_threshold=15,
                       detection_cell_size=160, max_keypoints_per_cell=60,
                       near_plane_distance=0.5, far_plane_distance=100.0,
                       staged_threshold=0)
        maps = datasets.euroc_rectify_maps()
        return chunks(lambda: VOSystem(cfg, device=device,
                                       rectify_maps=maps), *raw)
    assert entry == "corners"

    def corners(img):
        f = extract_features(torch.from_numpy(img), cfg)
        return f.kp[f.valid].numpy()

    seq = [(u8(l), u8(r)) for l, r, _ in world.stereo_sequence(n, speed=0.5)]
    seq = [(l, r, corners(l), corners(r)) for l, r in seq]

    def chunk(vo, lo, hi):
        out = [(vo.track_with_external_corners(*f), vo.last_metrics)
               for f in seq[lo:hi]]
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        return tuple(type(o[0])(*map(stack, *o)) for o in zip(*out))

    return lambda: VOSystem(cfg, device=device), chunk, n


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["stereo", "stereo_dense_ba", "rgbd",
                                   "rgbd_ba", "rectified", "corners",
                                   "multistream", "stereo_sparse"])
def test_graph_replays_equal_the_eager_step(cuda, entry):
    """Each entry point on the card over 6 frames in chunks of 3, replayed
    from its captured graph and, in a second system on the same frames,
    run eagerly under ``disable_graphs()``: poses, every metrics leaf and
    the final state bit-equal; the same kernels run on the card in the
    second chunk (a kernel trace, graph replays included); 0 host syncs in
    a replayed chunk. The wrappers count the Python calls: the eager
    step's at every frame, the graph's at its warm-up and its capture, and
    in both modes one ``copy_leaves`` a chunk (its start) and none a
    frame (the step's tail ends it)."""
    from lvt_tpu_torch.core import graphs
    from lvt_tpu_torch.parallel.dryrun import (count_syncs, device_launches,
                                               zero_kernel_counters)
    from lvt_tpu_torch.tree import leaves

    make, chunk, n = _graph_case(entry, cuda)
    runs = {}
    for mode in ("graph", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            counters = zero_kernel_counters()
            vo = make()
            first = chunk(vo, 0, 3)
            (second, syncs), device = device_launches(
                lambda: count_syncs(lambda: chunk(vo, 3, n)))
            runners = list(vo.runners.values())
            assert len(runners) == 1 and runners[0].mode == mode
            runs[mode] = dict(
                out=[first, second], syncs=syncs, vo=vo, device=device,
                launches={k: f.launches for k, f in counters.items()},
                replays=runners[0].replays)
    graph, eager = runs["graph"], runs["eager"]
    assert graph["replays"] == n and eager["replays"] == 0
    assert graph["syncs"] == 0 and eager["syncs"] == 0
    # a chunk starts with one copy_leaves (its table, frame 0's inputs);
    # the external corners' entry point is a chunk of one frame a call
    chunks = (n, n - 3) if entry == "corners" else (2, 1)
    per_chunk = {k: int(k == "copy_leaves") for k in eager["launches"]}
    per_frame = {k: (v - per_chunk[k] * chunks[0]) // n
                 for k, v in eager["launches"].items()}
    assert per_frame["hamming_top2"] > 0 and per_frame["copy_leaves"] == 0
    assert eager["launches"] == {k: v * n + per_chunk[k] * chunks[0]
                                 for k, v in per_frame.items()}
    assert graph["launches"] == {k: v * 2 + per_chunk[k] * chunks[0]
                                 for k, v in per_frame.items()}
    second = {k: v * (n - 3) + per_chunk[k] * chunks[1]
              for k, v in per_frame.items()}
    for mode in ("graph", "eager"):
        want = dict(second)
        if mode == "graph" and want["ba_refine"]:
            # local BA's kernel runs in the graph's IF node on BA frames
            # only (its launches are its own count: dryrun.device_launches)
            cfg = graph["vo"].config
            want["ba_refine"] = sum(f >= cfg.local_ba_window
                                    and f % cfg.local_ba_every == 0
                                    for f in range(3, n))
        assert {k: runs[mode]["device"][k] for k in second} == want
    for g, e in zip(graph["out"], eager["out"]):
        for a, b in zip([*g[0], *g[1]], [*e[0], *e[1]]):
            assert torch.equal(a, b)
    state = lambda vo: getattr(vo, "state", None) or vo.states  # noqa: E731
    for a, b in zip(leaves(state(graph["vo"])),
                    leaves(state(eager["vo"]))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rgbd_local_ba_on_the_card_leaves_the_map_as_it_was(cuda):
    """An RGB-D config with local BA on the card (the kernel in the graph's
    IF node on BA frames; right weights all 0): poses and the final map
    bit-equal to the same config without BA on the card, and within 1e-3 m
    of the CPU's run (tests/test_torch_ba_refine.py holds the CPU's to its
    BA-off run). With a baseline of 0 the card's step raises the CPU's
    ValueError at the first frame."""
    from lvt_tpu_torch.core.system import SensorType, VOSystem

    make, _, n = _graph_case("rgbd_ba", cuda)
    cfg = make().config
    runs = {}
    for name, c, dev in (("ba", cfg, cuda),
                         ("off", cfg.replace(local_ba_window=0), cuda),
                         ("cpu", cfg, "cpu")):
        vo = VOSystem(c, SensorType.RGBD, device=dev)
        poses, _ = _graph_case("rgbd_ba", dev)[1](vo, 0, n)
        runs[name] = (poses, vo.state.map)
    (p_ba, m_ba), (p_off, m_off) = runs["ba"], runs["off"]
    assert torch.equal(p_ba.t, p_off.t) and torch.equal(p_ba.q, p_off.q)
    assert torch.equal(m_ba.pos, m_off.pos)
    assert int(m_ba.valid.sum()) > 100
    gap = (p_ba.t.cpu() - runs["cpu"][0].t).abs().max()
    assert float(gap) < 1e-3
    no_baseline = cfg.replace(baseline=0.0)
    for dev in (cuda, "cpu"):
        vo = VOSystem(no_baseline, SensorType.RGBD, device=dev)
        with pytest.raises(ValueError, match="nonzero baseline"):
            _graph_case("rgbd_ba", dev)[1](vo, 0, 1)


@pytest.mark.cuda
def test_capture_of_a_step_that_syncs_raises(cuda):
    """A step that reads a value back to the host runs in the warm-up but
    cannot be captured: the first replay raises, and the runner does not
    run the step eagerly instead (the state is left as it was)."""
    from lvt_tpu_torch.core import graphs
    from lvt_tpu_torch.geometry.se3 import Pose

    def step(state, x):
        if float(x.sum()) > 0:          # a host sync
            x = x * 2
        return state._replace(t=state.t + 1), x, x

    state = Pose.identity(cuda)
    x = torch.zeros(3, device=cuda)
    runner = graphs.StepGraph(step, state, [x], outputs=(x, x))
    assert runner.mode == "graph"
    with pytest.raises(RuntimeError):
        runner.run(torch.ones(1, 3, device=cuda))
    torch.cuda.synchronize()
    assert runner.replays == 0 and runner._graph is None
    assert torch.equal(state.t.cpu(), torch.zeros(3))


def _kitti_ba_frames(n):
    """Path 2's config (the shipped KITTI YAML in dense mode: local BA
    window 4 every 4 frames) and n frames of chip_smoke's KITTI-geometry
    world."""
    from lvt_tpu_torch import configs
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    cfg = configs.kitti_ba_dense_config()
    world = SyntheticWorld(width=cfg.img_width, height=cfg.img_height,
                           fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                           baseline=cfg.baseline, n_points=6000,
                           extent_x=80.0, extent_y=20.0, extent_z=160.0)
    return cfg, [(l.astype(np.uint8), r.astype(np.uint8))
                 for l, r, _ in world.stereo_sequence(n, speed=0.9)]


@pytest.mark.cuda
def test_ba_under_an_if_node_equals_the_eager_step(cuda):
    """Path 2's config over 17 frames, one ``track`` each: the graph, whose
    local BA is a CUDA IF node on its schedule, against the eager step,
    which computes BA on every frame and selects it, bit for bit: poses,
    the map's positions after each frame, ``local_ba_ran`` (BA at frames
    4, 8, 12 and 16). What the card ran per frame (a kernel trace of
    frames 5-16): A, B, T 4 times and PnP once on every frame; local BA's
    kernel (its own count) once on each BA frame and on no other in the
    graph, once on every frame in the eager step; in the
    graph one kernel setting the node's predicate per frame, the same
    kernels on each other frame, a BA frame's being
    an other frame's and at most as many more as the node's body holds
    (kernels, and copies and fills, which a body runs as kernels; a trace
    can miss records of a node's body); in the eager step no predicate and
    the same kernels on every frame."""
    import ctypes

    from lvt_tpu_torch.core import graphs
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.parallel.dryrun import frame_launches

    cfg, frames = _kitti_ba_frames(17)
    runs = {}
    for mode in ("graph", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            vo = VOSystem(cfg, device=cuda)

            def track(i):
                pose = vo.track(*frames[i])
                return pose, vo.last_metrics, vo.state.map.pos.clone()

            first = [track(i) for i in range(5)]
            rest, per_frame = frame_launches(lambda i: track(i + 5), 12)
            (runner,) = vo.runners.values()
            assert runner.mode == mode and runner.if_nodes
        runs[mode] = dict(out=[*first, *rest], frames=per_frame,
                          runner=runner)
    for (gp, gm, gpos), (ep, em, epos) in zip(runs["graph"]["out"],
                                              runs["eager"]["out"]):
        assert torch.equal(gp.t, ep.t) and torch.equal(gp.q, ep.q)
        assert torch.equal(gpos, epos)
        assert torch.equal(gm.local_ba_ran, em.local_ba_ran)
    assert [bool(m.local_ba_ran) for _, m, _ in runs["graph"]["out"]] == [
        i in (4, 8, 12, 16) for i in range(17)]
    is_ba = [i in (8, 12, 16) for i in range(5, 17)]
    # T's one dual row launch serves both row matches; local BA's
    # observations one launch a frame
    need = dict(perception=1, brief=1, hamming_top2=3, pnp_solve=1,
                ba_observe=1)
    for mode, if_node in (("graph", 1), ("eager", 0)):
        for f, ba in zip(runs[mode]["frames"], is_ba):
            assert {k: f[k] for k in [*need, "if_node", "ba_refine"]} == dict(
                need, if_node=if_node, ba_refine=int(ba or mode == "eager"))

    def kernels_of(f):
        return Counter(n for n in f["names"]
                       if not n.startswith(("Memcpy", "Memset")))

    graph = [kernels_of(f) for f in runs["graph"]["frames"]]
    ba = [k for k, b in zip(graph, is_ba) if b]
    other = [k for k, b in zip(graph, is_ba) if not b]
    for k in other[1:]:
        assert k == other[0], (dict(k - other[0]), dict(other[0] - k))
    (branch,) = runs["graph"]["runner"]._branches
    counts = (ctypes.c_int * len(graphs._NODE_TYPES))()
    kernels.lib().lvt_graph_node_counts(branch.raw_cuda_graph(), counts,
                                        len(counts))
    # the body's copies and fills run as kernels of CUDA's own
    # (memcpy32_post), which a kernel trace lists as kernels
    nodes = sum(counts[graphs._NODE_TYPES.index(t)]
                for t in ("kernel", "memcpy", "memset"))
    assert nodes > 0
    for k in ba:
        assert not other[0] - k
        assert sum((k - other[0]).values()) <= nodes
    eager = [kernels_of(f) for f in runs["eager"]["frames"]]
    for k in eager[1:]:
        assert k == eager[0], (dict(k - eager[0]), dict(eager[0] - k))


@pytest.mark.cuda
def test_streaming_ba_under_an_if_node_in_its_worker_thread(cuda):
    """StreamingVO with local BA on (path 2's config) over 9 frames: the
    graph is captured in its worker thread, the IF node's body included,
    and every frame's pose is bit-equal to ``VOSystem.track``'s."""
    import time

    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.streaming import StreamingVO

    cfg, frames = _kitti_ba_frames(9)
    stream = StreamingVO(cfg, queue_size=len(frames), device=cuda)
    seen = []
    stream.on_odometry(lambda odo: seen.append(
        [x.cpu() for x in stream.vo.last_pose]))
    stream.start()
    try:
        for i, (a, b) in enumerate(frames):
            stream.feed(float(i), a, b)
        deadline = time.monotonic() + 120
        while len(seen) < len(frames) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stream.stop()
    vo = VOSystem(cfg, device=cuda)
    want = [vo.track(a, b) for a, b in frames]
    assert len(seen) == len(frames)
    for (t, q), w in zip(seen, want):
        assert torch.equal(t, w.t.cpu()) and torch.equal(q, w.q.cpu())
    (runner,) = stream.vo.runners.values()
    assert runner.mode == "graph" and runner.if_nodes
    assert bool(vo.last_metrics.local_ba_ran)


@pytest.mark.cuda
def test_multistream_ba_on_the_card_is_each_stream_alone(cuda):
    """MultiStreamVO with local BA on (dense mode, window 4 every 4; its
    vmapped step computes BA on every frame and selects it) with 2 streams
    of different content over 9 frames on the card, against each stream's
    VOSystem on the card (BA an IF node in its graph): poses, the map's
    positions and ``local_ba_ran`` (frames 4 and 8) bit-equal."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    kw = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
              baseline=0.3, n_points=1500, extent_x=40.0, extent_y=18.0,
              extent_z=90.0)
    worlds = [SyntheticWorld(**kw), SyntheticWorld(**kw, seed=99)]
    cfg = VOConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, baseline=0.3,
                   img_width=320, img_height=240, detection_cell_size=80,
                   max_keypoints_per_cell=60, agast_threshold=15,
                   near_plane_distance=0.5, far_plane_distance=150.0,
                   descriptor_mode="dense", local_ba_window=4,
                   local_ba_every=4)
    seqs = [list(w.stereo_sequence(9, speed=0.5)) for w in worlds]
    a = torch.from_numpy(np.stack([[f[0].astype(np.uint8) for f in fs]
                                   for fs in zip(*seqs)])).to(cuda)
    b = torch.from_numpy(np.stack([[f[1].astype(np.uint8) for f in fs]
                                   for fs in zip(*seqs)])).to(cuda)
    msvo = MultiStreamVO(cfg, 2, device=cuda)
    poses, metrics = msvo.track_chunk(a, b)
    assert metrics.local_ba_ran[:, 0].tolist() == [i in (4, 8)
                                                   for i in range(9)]
    for s in (0, 1):
        vo = VOSystem(cfg, device=cuda)
        p, m = vo.track_chunk(a[:, s], b[:, s])
        assert torch.equal(p.t, poses.t[:, s]) and torch.equal(
            p.q, poses.q[:, s]), float((p.t - poses.t[:, s]).abs().max())
        assert torch.equal(vo.state.map.pos, msvo.states.map.pos[s])
        assert torch.equal(m.local_ba_ran, metrics.local_ba_ran[:, s])


# ---- local BA's whole body: lvt_tpu_torch::ba_refine (csrc/ba.cu)

BA_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
              baseline=0.537165718864)


def _ba_problem(rs, s, m, device, case="noisy", f=4):
    """``s`` streams of a local BA window as the tracking step poses it,
    with KITTI 00's camera: ``m`` map points 4-60 m deep seen by ``f``
    poses 0.9 m apart along the optical axis (a small turn each), their
    left and right pixels with 0.5 px noise; the poses off by 2 cm and the
    points by 5 cm. ``case``: ``noisy`` (a sixteenth of the left
    observations 10-40 px off, a tenth of each frame's points unobserved,
    a fifth of the right ones), ``few`` (only 12 points observed), ``none``
    (no observation). -> (t [S, F, 3], q [S, F, 4], pos [S, M, 3], obs
    [S, F, M, 2], w [S, F, M], obs_r, w_r) float32 on ``device``."""
    fx, fy, cx, cy, base = (BA_CAM[k] for k in ("fx", "fy", "cx", "cy",
                                                "baseline"))
    out = [[] for _ in range(7)]
    for _ in range(s):
        z = rs.uniform(4.0, 60.0, m)
        pts = np.stack([(rs.uniform(0, 1241, m) - cx) * z / fx,
                        (rs.uniform(0, 376, m) - cy) * z / fy, z], -1)
        ts, qs, obs, obs_r, w, w_r = [], [], [], [], [], []
        for i in range(f):
            w3 = np.array([0.0, 0.01 * i, 0.0]) + rs.randn(3) * 1e-3
            th = np.linalg.norm(w3)
            q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * w3 / th])
            t = np.array([0.0, 0.0, -0.9 * (f - 1 - i)]) + rs.randn(3) * 0.02
            pc = (pts - t) @ _quat_matrix(q)
            for cam_x, acc in ((0.0, obs), (base, obs_r)):
                p = pc - [cam_x, 0.0, 0.0]
                acc.append(np.stack([fx * p[:, 0] / p[:, 2] + cx,
                                     fy * p[:, 1] / p[:, 2] + cy], -1)
                           + rs.randn(m, 2) * 0.5)
            obs[-1][rs.rand(m) < 1 / 16] += rs.uniform(10, 40, 2)
            w.append(rs.rand(m) > 0.1)
            w_r.append(w[-1] & (rs.rand(m) > 0.2))
            q0 = q + rs.randn(4) * 1e-3
            ts.append(t + rs.randn(3) * 0.02)
            qs.append(q0 / np.linalg.norm(q0))
        w, w_r = np.stack(w), np.stack(w_r)
        if case == "few":
            w[:, 12:] = False
            w_r[:, 12:] = False
        elif case == "none":
            w[:] = False
            w_r[:] = False
        for acc, x in zip(out, (ts, qs, pts + rs.randn(m, 3) * 0.05, obs, w,
                                obs_r, w_r)):
            acc.append(np.asarray(x))
    return [torch.from_numpy(np.stack(x).astype(np.float32)).to(device)
            for x in out]


def _ba_plain(args, iterations=6):
    """The plain version (torch ops) stream by stream, stacked as
    ba_refine's outputs."""
    from lvt_tpu_torch.solver import bundle

    outs = [bundle.refine_structure_plain(
        Pose(*a[:2]), *a[2:], iterations=iterations, reprojection_th2=5.991,
        **BA_CAM) for a in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,case,f", [
    (1, 1024, "noisy", 4), (4, 1024, "noisy", 4), (2, 4096, "noisy", 4),
    (2, 300, "few", 4), (1, 256, "none", 4), (2, 512, "noisy", 2),
    (2, 512, "noisy", 3), (2, 512, "noisy", 5), (2, 5, "noisy", 4),
    (2, 1000, "noisy", 4), (1, 1023, "noisy", 4), (2, 512, "noisy", 8),
    (16, 256, "noisy", 4), (20, 256, "noisy", 4)])
def test_ba_refine_kernel_matches_plain(cuda, s, m, case, f):
    """Local BA's body in one launch against the plain version stream by
    stream, every output bit-equal (positions, chi2, n_obs, the accept
    bits), and every stream of the S-stream launch bit-equal to its own
    S = 1 launch; windows of 2 to 8 poses (the reduced solve at each
    size, up to the kernel's limit); fewer points than a stream's cluster
    has blocks (M = 5), slices of unequal size (M = 1000, 1023), and 16
    and 20 streams (128 and 160 blocks beside the card's 132 SMs)."""
    from lvt_tpu_torch.solver import bundle

    args = _ba_problem(np.random.RandomState(13 * s + m + f), s, m, cuda,
                       case, f)
    cam = tuple(float(BA_CAM[k]) for k in ("fx", "fy", "cx", "cy",
                                            "baseline"))
    before = bundle.ba_refine.launches
    got = bundle.ba_refine_op(*args, *cam, 5.991, 6)
    torch.cuda.synchronize()
    assert bundle.ba_refine.launches == before + 1
    want = _ba_plain(args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), (
            i, float((g.double() - w.double()).abs().max()))
    for i in range(s):
        one = bundle.ba_refine_op(*(x[i:i + 1] for x in args), *cam, 5.991, 6)
        for a, b in zip(one, got):
            assert torch.equal(a[0], b[i])
    if case == "none":
        assert torch.equal(got[0], args[2]) and int(got[2].sum()) == 0


@pytest.mark.cuda
def test_ba_refine_vmap_rule_launches_once(cuda):
    """``bundle.ba_refine`` under ``torch.func.vmap`` over 3 streams: one
    launch, each stream the op's."""
    from lvt_tpu_torch.solver import bundle

    args = _ba_problem(np.random.RandomState(5), 3, 512, cuda)
    before = bundle.ba_refine.launches
    got = torch.func.vmap(lambda t, q, *a: bundle.ba_refine(
        Pose(t, q), *a, iterations=6, reprojection_th2=5.991, **BA_CAM))(
            *args)
    torch.cuda.synchronize()
    assert bundle.ba_refine.launches == before + 1
    cam = tuple(float(BA_CAM[k]) for k in ("fx", "fy", "cx", "cy",
                                            "baseline"))
    for a, b in zip(got, bundle.ba_refine_op(*args, *cam, 5.991, 6)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ba_refine_refuses_a_window_beyond_the_kernels_limit(cuda):
    """The kernel takes windows of 1 to its static limit of poses; a longer
    one raises before any launch, never falls back."""
    from lvt_tpu_torch.solver import bundle

    limit = kernels.lib().lvt_ba_max_window()
    args = _ba_problem(np.random.RandomState(2), 1, 64, cuda, f=limit + 1)
    before = bundle.ba_refine.launches
    with pytest.raises(ValueError, match="window"):
        bundle.ba_refine(Pose(args[0][0], args[1][0]),
                         *(x[0] for x in args[2:]), iterations=6,
                         reprojection_th2=5.991, **BA_CAM)
    assert bundle.ba_refine.launches == before


# ---- the sharded body's phases: lvt_tpu_torch::ba_phase (csrc/ba.cu)

def _ba_phases(args, iterations=6):
    """The sharded body's phases on one rank (no group: every all-reduce
    the identity), vmapped over the streams: one launch per phase for all
    of them, as ba_refine's outputs."""
    from lvt_tpu_torch.solver import bundle

    return torch.func.vmap(lambda t, q, *a: bundle.refine_structure_phases(
        Pose(t, q), *a, iterations=iterations, reprojection_th2=5.991,
        **BA_CAM).outputs())(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,case,f,iterations", [
    (1, 1024, "noisy", 4, 6), (8, 1024, "noisy", 4, 6),
    (2, 4096, "noisy", 4, 6), (2, 300, "few", 4, 6), (1, 256, "none", 4, 6),
    (2, 512, "noisy", 1, 6), (2, 512, "noisy", 2, 6), (2, 512, "noisy", 3, 6),
    (2, 512, "noisy", 8, 6), (2, 5, "noisy", 4, 6), (3, 1023, "noisy", 6, 6),
    (5, 1000, "noisy", 5, 6), (8, 256, "noisy", 7, 6),
    (2, 512, "noisy", 4, 0), (2, 512, "noisy", 4, 1)])
def test_ba_phase_on_one_rank_is_ba_refine(cuda, s, m, case, f, iterations):
    """The phases of local BA's body, each all-reduce the identity (one
    rank), against the whole body in one launch of ``ba_refine``: every
    output bit-equal (positions, chi2, n_obs, the accept bits), ``n_phases``
    launches for all S streams, and every stream bit-equal to its own S = 1
    phases; S = 1 to 8, F = 1 to 8, M up to 4096, 0 and 1 iterations."""
    from lvt_tpu_torch.solver import bundle

    args = _ba_problem(np.random.RandomState(7 * s + m + f), s, m, cuda,
                       case, f)
    cam = tuple(float(BA_CAM[k]) for k in ("fx", "fy", "cx", "cy",
                                            "baseline"))
    before = bundle.ba_phase.launches
    got = _ba_phases(args, iterations)
    torch.cuda.synchronize()
    assert bundle.ba_phase.launches == before + bundle.n_phases(iterations)
    want = bundle.ba_refine_op(*args, *cam, 5.991, iterations)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), (
            i, float((g.double() - w.double()).abs().max()))
    for i in range(s):
        one = _ba_phases([x[i:i + 1] for x in args], iterations)
        for a, b in zip(one, got):
            assert torch.equal(a[0], b[i])


@pytest.mark.cuda
def test_ba_phase_counts_its_launches_on_the_card(cuda):
    """The kernel's own count (``bundle.phase_device_launches``) advances
    by one per phase, in a CUDA graph's replays too."""
    from lvt_tpu_torch.solver import bundle

    args = _ba_problem(np.random.RandomState(3), 1, 256, cuda)
    _ba_phases(args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _ba_phases(args)
    before = bundle.phase_device_launches()
    graph.replay()
    graph.replay()
    assert bundle.phase_device_launches() == before + 2 * bundle.n_phases(6)


@pytest.mark.cuda
def test_ba_phase_refuses_a_window_beyond_the_kernels_limit(cuda):
    """As ``ba_refine``: a window beyond the kernel's limit of poses raises
    before any launch, never falls back."""
    from lvt_tpu_torch.solver import bundle

    limit = kernels.lib().lvt_ba_max_window()
    args = _ba_problem(np.random.RandomState(2), 1, 64, cuda, f=limit + 1)
    before = bundle.ba_phase.launches
    with pytest.raises(ValueError, match="window"):
        _ba_phases(args)
    assert bundle.ba_phase.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,case", [(1024, "noisy"), (301, "few")])
def test_ba_phase_on_two_ranks_sharing_the_card(cuda, m, case):
    """The phases over 2 ranks sharing the card (gloo carries the float64
    partials through the host), each rank on its block of the window's
    points, against the plain group body on the same ranks and blocks:
    every output bit-equal on each rank, both ranks' sums and so their
    chi2, n_obs and accept bits equal, the phases' 3 + 2 per iteration
    all-reduces, no trial flagged non-finite. ``few``: every observed
    point in rank 0's block."""
    from lvt_tpu_torch.parallel import dryrun

    window = [x[0].numpy() for x in _ba_problem(
        np.random.RandomState(11), 1, m, "cpu", case)]
    cam = dict(BA_CAM, iterations=6, reprojection_th2=5.991)
    res = dryrun.spawn([dryrun.job(dryrun.ba_phases_check, window, cam=cam,
                                   device="cuda")],
                       2, device="cuda", backend="gloo")
    for (got,) in res:
        for i, (a, b) in enumerate(zip(got["phases"], got["plain"])):
            np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
        assert got["phases_collectives"] == 3 + 2 * 6
        assert got["plain_collectives"] == 4 + 2 * 6
        assert got["trial_bad"] == [0.0] * 6
    for i in (1, 2, 3):
        np.testing.assert_array_equal(res[0][0]["phases"][i],
                                      res[1][0]["phases"][i])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["predict_project", "upkeep_pre",
                                  "ba_observe"])
def test_routed_ops_under_a_group_on_the_card(cuda, name, tmp_path):
    """On a one-rank gloo group (CUDA tensors) the wrappers of
    ``track.GROUP_OPS`` launch their kernels and give their plain group
    versions' outputs bit for bit, on each routed case of TRACK_CASES."""
    import torch.distributed as dist

    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.parallel import mesh as mesh_mod

    cases = [c for c in TRACK_CASES if c[0] == name and c[1] <= 8]
    mesh_mod.init("gloo", 1, 0, f"file://{tmp_path / 'rdv'}")
    try:
        for _, s, case, kw in cases:
            args = _track_problem(np.random.RandomState(s), name, s, cuda,
                                  case, **kw)
            before = getattr(track, name).launches
            got = _track_wrapper(name, args, dist.group.WORLD)
            assert getattr(track, name).launches == before + 1
            want = _track_plain_group(name, args, dist.group.WORLD)
            _assert_outputs_equal(_leaves(got), _leaves(want),
                                  f"{name} {case}")
    finally:
        dist.destroy_process_group()


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


# ---- the tracking branch's four ops (core/track.py, csrc/track.cu)

TRACK_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, near=0.01,
                 far=500.0, min_x=0.0, max_x=1241.0, min_y=0.0, max_y=376.0)
BIG = 1.0e9


def _track_op(name):
    from lvt_tpu_torch.core import track

    return getattr(track, f"{name}_op")


def _unit_q(rs, s, spread):
    q = np.concatenate([np.ones((s, 1)), rs.randn(s, 3) * spread], -1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _store_arrays(rs, s, c, case):
    """A point store's leaves [S, c, ...]: ``case`` ``full`` (no free
    slot; also ``none_full``), ``empty`` (every slot free), ``crowded`` (a
    few free), else about half free."""
    frac = {"full": 1.0, "empty": 0.0, "crowded": 0.97}.get(
        case.removeprefix("none_"), 0.5)
    return [rs.randn(s, c, 3).astype(np.float32) * 20,
            rs.randint(-2**31, 2**31, (s, c, 8), dtype=np.int64
                       ).astype(np.int32),
            rs.randint(0, 12, (s, c)).astype(np.int32),
            rs.randint(0, 30, (s, c)).astype(np.int32),
            rs.rand(s, c) < frac]


def _top2_arrays(rs, s, n, k, conflicts=True):
    """Kernel T's outputs at one site [S, n]: integer distances in f32 (BIG
    where no candidate), candidate counts 0, 1 or more, and best indices of
    which a third fall in a few targets, so the one-to-one resolution has
    work to do."""
    n_cand = rs.choice([0, 1, 2, 3, 9], (s, n), p=[0.1, 0.15, 0.35, 0.2, 0.2])
    d1 = rs.randint(0, 90, (s, n)).astype(np.float32)
    d2 = d1 + rs.randint(0, 70, (s, n)).astype(np.float32)
    best = rs.randint(0, k, (s, n))
    if conflicts:
        crowd = rs.rand(s, n) < 0.3
        best[crowd] = rs.randint(0, max(1, k // 50), crowd.sum())
    d2[n_cand < 2] = BIG
    d1[n_cand < 1] = BIG
    best[n_cand < 1] = 0
    return [d1, d2.astype(np.float32), best.astype(np.int64),
            n_cand.astype(np.int64)]


def _ba_observe_arrays(rs, s, m, k, n, f, case):
    """ba_observe's tensors for ``s`` streams: T's dual row outputs (the
    second set's with crowded targets; ``case`` ``none``: no candidate),
    the map match's (one-to-one) matches, PnP's pose, a window of ``f``
    poses whose weights hold NaN, -0.0 and negatives, ``n`` from 0 to f
    (``empty``: 0, ``full``: f; ``finite``: no NaN), the map's masks
    (culled and recycled slots; ``n`` 0: no staged set) and frame numbers
    (BA due and not)."""
    two = [_top2_arrays(rs, s, k, k) if k else
           [np.zeros((s, 0), np.float32)] * 2 + [np.zeros((s, 0), np.int64)] * 2
           for _ in range(2)]
    if case == "none":
        two[1][3][:] = 0
        two[1][0][:] = BIG
    fout = np.stack([np.stack([two[0][i], two[1][i]], 1) for i in (0, 1)],
                    1).astype(np.float32)
    iout = np.stack([np.stack([two[0][i], two[1][i]], 1) for i in (2, 3)],
                    1).astype(np.int64)
    match_idx = np.where(rs.rand(s, m) < 0.6, -1, -2).astype(np.int64)
    for i in range(s if k else 0):
        hit = rs.choice(m, min(m, k) // 2, replace=False)
        match_idx[i, hit] = rs.choice(k, hit.size, replace=False)
    kp = rs.uniform(0, 1241, (s, k, 2)).astype(np.float32)
    obs = np.take_along_axis(kp, np.clip(match_idx, 0, max(k - 1, 0))[
        ..., None], 1) if k else np.zeros((s, m, 2), np.float32)
    weights = (match_idx >= 0).astype(np.float32)
    rkp = rs.uniform(0, 1241, (s, k, 2)).astype(np.float32)
    t = (rs.randn(s, 3) * 5).astype(np.float32)
    q = _unit_q(rs, s, 0.05)
    poses_t = (rs.randn(s, f, 3) * 5).astype(np.float32)
    poses_q = np.stack([_unit_q(rs, f, 0.05) for _ in range(s)])
    w_obs = rs.uniform(0, 1241, (s, f, m, 2)).astype(np.float32)
    w_obs_r = rs.uniform(0, 1241, (s, f, m, 2)).astype(np.float32)
    nan = 0.5 if case == "finite" else np.nan
    w_w = rs.choice([0.0, 1.0, 0.37, -2.5, -0.0, nan], (s, f, m),
                    p=[0.3, 0.4, 0.1, 0.1, 0.05, 0.05]).astype(np.float32)
    w_w_r = rs.choice([0.0, 1.0, nan, -0.0], (s, f, m),
                      p=[0.4, 0.5, 0.05, 0.05]).astype(np.float32)
    n_win = {"empty": np.zeros(s), "full": np.full(s, f)}.get(
        case, rs.randint(0, f + 1, s)).astype(np.int32)
    mvalid = rs.rand(s, m) > 0.2
    bvalid = mvalid | (rs.rand(s, m) < 0.1)
    cvalid = bvalid & (rs.rand(s, m) > 0.1)
    taken = rs.rand(s, m) < 0.1
    ptaken = rs.rand(s, m if n else 0) < 0.1
    frame = rs.choice([4, 5, 8, 12, 3, 0], s).astype(np.int32)
    return [fout, iout, match_idx, obs, weights, rkp, t, q, poses_t,
            poses_q, w_obs, w_w, w_obs_r, w_w_r, n_win, mvalid, bvalid,
            cvalid, taken, ptaken, frame]


def _track_problem(rs, name, s, device, case="random", m=1024, k=1536,
                   n=1024, rgbd=False, policy=1, staged_threshold=2, f=4):
    """Seeded inputs of one of TRACK_OPS for ``s`` streams, as the tracking
    step gives them, in the op's argument order. ``case``: the stores'
    occupancy (``_store_arrays``: ``full``, ``empty``, ``crowded``) or
    ``none`` (no promotion, no triangulation candidate; ``none_full``
    beside full stores); ba_observe: ``_ba_observe_arrays``' (``f`` poses,
    K = 0: no right camera)."""
    cam = [float(TRACK_CAM[key]) for key in (
        "fx", "fy", "cx", "cy", "near", "far", "min_x", "max_x", "min_y",
        "max_y")]
    t = (rs.randn(s, 3) * 5).astype(np.float32)
    q = _unit_q(rs, s, 0.05)
    is_init = rs.rand(s) < 0.25
    is_init[1:2] = True
    is_init[0] = case == "init"
    if name == "ba_observe":
        arrays = _ba_observe_arrays(rs, s, m, k, n, f, case)
        scalars = [0.6, 30.0, 4]
    elif name == "predict_project":
        lq, av = _unit_q(rs, s, 0.05), _unit_q(rs, s, 0.02)
        lp = (t + rs.randn(s, 3)).astype(np.float32)
        lv = (rs.randn(s, 3) * 0.5).astype(np.float32)
        # stream 2: the angular velocity is the rotation since the last
        # frame (slerp's near-parallel branch); stream 3: its negation
        for i, sign in ((2, 1.0), (3, -1.0)):
            if i < s:
                lq_inv = lq[i] * np.array([1, -1, -1, -1], np.float32)
                av[i] = sign * _qmul(q[i], lq_inv)
        cam_pts = rs.uniform([-80, -30, -5], [80, 30, 120], (s, m, 3))
        cam_pts[:, :8, 2] = [0.0, 1e-13, -1e-13, 0.01, 500.0, -0.0, 1e-30,
                             600.0][:min(8, m)]
        pos = (cam_pts + t[:, None]).astype(np.float32)
        arrays = [lq, lp, lv, av, t, q, is_init, pos, rs.rand(s, m) > 0.1]
        scalars = [cam]
    elif name == "upkeep_pre":
        store = _store_arrays(rs, s, m, case)
        if case == "cull":   # counters about the cull's threshold of 10
            store[2] = rs.randint(8, 11, (s, m)).astype(np.int32)
        match_idx = np.where(rs.rand(s, m) < 0.5, -1, -2).astype(np.int64)
        fm = np.zeros((s, k), bool)
        for i in range(s):
            hit = rs.choice(m, min(m, k) // 2, replace=False)
            match_idx[i, hit] = rs.choice(k, hit.size, replace=False)
            fm[i, match_idx[i, hit]] = True
        fvalid = rs.rand(s, k) > 0.1
        staged_pos = (rs.uniform([-80, -30, -5], [80, 30, 120], (s, n, 3))
                      + t[:, None]).astype(np.float32)
        arrays = [store[2], store[3], store[4], match_idx, fm & fvalid,
                  fvalid, t, q, is_init, staged_pos, rs.rand(s, n) > 0.3]
        scalars = [10, cam]
    elif name == "staged_promote":
        top2 = _top2_arrays(rs, s, n, k)
        if case.startswith("none"):
            top2[3][:] = 0
        staged = _store_arrays(rs, s, n, "random")
        staged[2] = rs.randint(0, 3, (s, n)).astype(np.int32)
        staged[4] = rs.rand(s, n) > 0.3
        mp = _store_arrays(rs, s, m, case)
        map_size = np.array([rs.choice([mp[4][i].sum(), 100, 400])
                             for i in range(s)], np.int64)
        arrays = [*top2, *staged, rs.rand(s, k) > 0.7, map_size, *mp]
        scalars = [0.8, 30.0, staged_threshold, 250]
    else:
        kp = np.stack([rs.uniform(0, 1241, (s, k)),
                       rs.uniform(0, 376, (s, k))], -1).astype(np.float32)
        z = rs.uniform(2.0, 300.0, (s, k))
        disp = TRACK_CAM["fx"] * 0.537165718864 / z
        rkp = (kp - np.stack([disp, np.zeros_like(disp)], -1)
               + rs.randn(s, k, 2) * 0.4).astype(np.float32)
        rkp[rs.rand(s, k) < 0.1] += 8.0
        top2 = _top2_arrays(rs, s, k, k, conflicts=False)
        keep = rs.rand(s, k) < 0.8
        top2[2] = np.where(keep, np.arange(k), top2[2]).astype(np.int64)
        top2[2][top2[3] < 1] = 0
        depth = np.where(rs.rand(s, k) < 0.1, 0.0,
                         rs.uniform(0.3, 10.0, (s, k))).astype(np.float32)
        if rgbd:
            top2 = [x[:, :0] for x in top2]
            rkp = rkp[:, :0]
        else:
            depth = depth[:, :0]
        last = np.stack([np.full(s, 1e9), rs.uniform(100, 600, s),
                         rs.uniform(100, 600, s)], -1).astype(np.float32)
        count = rs.randint(0, 700, s).astype(np.int64)
        if case.startswith("none"):
            is_init[:] = False
            policy = 1
            count[:] = 10**6
        arrays = [*top2, kp, rkp, depth, rs.rand(s, k) > 0.1,
                  rs.randint(-2**31, 2**31, (s, k, 8), dtype=np.int64
                             ).astype(np.int32), t, q,
                  *_store_arrays(rs, s, m, case),
                  *_store_arrays(rs, s, n, case), last, count, is_init]
        scalars = [rgbd, cam + [0.6, 30.0, 0.537165718864, 5.991],
                   [policy, staged_threshold, 250]]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays] + scalars


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], np.float32)


def _track_wrapper(name, args, group=None):
    """The single-stream wrapper of op ``name`` (core/track.py) on stream 0
    of the op's arguments ``args``, with ``group`` if given (the ops of
    ``track.GROUP_OPS``)."""
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.core.features import FrameFeatures
    from lvt_tpu_torch.core.motion import MotionState
    from lvt_tpu_torch.core.state import PointStore

    a = [x[0] if isinstance(x, torch.Tensor) else x for x in args]
    cam = dict(TRACK_CAM)
    if name == "ba_observe":
        from lvt_tpu_torch.core.state import ObsWindow

        right = a[0].shape[-1] > 0
        return track.ba_observe(
            (a[0], a[1]) if right else None, a[2], a[3], a[4],
            a[5] if right else None, Pose(a[6], a[7]), ObsWindow(*a[8:15]),
            *a[15:19], a[19] if a[19].shape[0] else None, a[20],
            ratio_threshold=a[21], abs_threshold=a[22], local_ba_every=a[23],
            group=group)
    if name == "predict_project":
        return track.predict_project(MotionState(*a[:4]), Pose(a[4], a[5]),
                                     a[6], a[7], a[8], cam, group)
    if name == "upkeep_pre":
        store = PointStore(a[9].new_zeros((a[0].shape[0], 3)), None, a[0],
                           a[1], a[2])
        staged = (PointStore(a[9], None, None, None, a[10])
                  if a[9].shape[0] else None)
        return track.upkeep_pre(store, a[3], a[4], a[5], Pose(a[6], a[7]),
                                a[8], staged, a[11], cam, group)
    if name == "staged_promote":
        return track.staged_promote(
            a[0:4], PointStore(*a[4:9]), a[9], a[10], PointStore(*a[11:16]),
            ratio_threshold=a[16], abs_threshold=a[17],
            staged_threshold=a[18], map_soft_cap=a[19])
    rgbd, fl, ints = a[24:27]
    zero = a[4][:, 0] * 0
    left = FrameFeatures(a[4], a[8], zero, a[6] if rgbd else zero, a[7])
    right = None if rgbd else FrameFeatures(a[5], a[8], zero, zero, a[7])
    prm = track.TriangulationParams(*fl[10:14], *ints)
    return track.triangulate_insert(
        None if rgbd else a[0:4], left, right, Pose(a[9], a[10]),
        PointStore(*a[11:16]), PointStore(*a[16:21]), a[21], a[22], a[23],
        cam, prm)


def _track_plain_group(name, args, group):
    """The plain version with ``group`` of one of ``track.GROUP_OPS`` on
    stream 0 of the op's arguments ``args``, as its wrapper's result."""
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.core.motion import MotionState
    from lvt_tpu_torch.core.state import ObsWindow, PointStore

    a = [x[0] if isinstance(x, torch.Tensor) else x for x in args]
    cam = dict(TRACK_CAM)
    if name == "ba_observe":
        return track.ba_observe_plain(
            top2._unpack(a[0], a[1])[1], a[2], a[3], a[4], a[5],
            Pose(a[6], a[7]), ObsWindow(*a[8:15]), *a[15:19],
            a[19] if a[19].shape[0] else None, a[20], ratio_threshold=a[21],
            abs_threshold=a[22], local_ba_every=a[23])
    if name == "predict_project":
        return track.predict_project_plain(
            MotionState(*a[:4]), Pose(a[4], a[5]), a[6], a[7], a[8], cam)
    store = PointStore(a[9].new_zeros((a[0].shape[0], 3)), None, a[0], a[1],
                       a[2])
    return track.upkeep_pre_plain(store, a[3], a[4], a[5], Pose(a[6], a[7]),
                                  a[8], a[9], a[10], a[11], cam, group)


def _track_plain(name, args):
    """The op's plain version stream by stream (its CPU kernel, on the
    tensors' own device)."""
    from lvt_tpu_torch.core import track

    n_tensors = sum(isinstance(x, torch.Tensor) for x in args)
    flat = getattr(track, f"_{name}_flat")
    return kernels.per_stream(flat, n_tensors, args)


def _assert_outputs_equal(got, want, label=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (label, i)
        assert torch.equal(g, w) or (
            g.is_floating_point() and torch.equal(g.isnan(), w.isnan())
            and torch.equal(g.nan_to_num(), w.nan_to_num())), (
            f"{label}: output {i} differs in "
            f"{int((g != w).sum())} of {g.numel()} elements")


TRACK_CASES = [
    ("predict_project", 1, "random", {}), ("predict_project", 8, "init", {}),
    ("predict_project", 8, "random", {"m": 4096}),
    ("upkeep_pre", 1, "random", {}), ("upkeep_pre", 8, "random", {}),
    ("upkeep_pre", 8, "full", {"n": 0}), ("upkeep_pre", 2, "random",
                                          {"m": 8192, "k": 2048}),
    # upkeep_pre: the init frame, path 5's map without a staged set,
    # counters at the cull's threshold, and tiles of both point axes
    ("upkeep_pre", 8, "init", {}),
    ("upkeep_pre", 1, "random", {"m": 4096, "k": 896, "n": 0}),
    ("upkeep_pre", 8, "cull", {}),
    ("upkeep_pre", 2, "cull", {"m": 3000, "k": 2048, "n": 2500}),
    ("staged_promote", 1, "random", {}), ("staged_promote", 8, "random", {}),
    ("staged_promote", 8, "full", {}), ("staged_promote", 8, "empty", {}),
    ("staged_promote", 8, "crowded", {}), ("staged_promote", 8, "none", {}),
    ("staged_promote", 2, "random", {"m": 50, "k": 300, "n": 400}),
    ("triangulate_insert", 1, "random", {}),
    ("triangulate_insert", 8, "random", {}),
    ("triangulate_insert", 8, "full", {}),
    ("triangulate_insert", 8, "empty", {}),
    ("triangulate_insert", 8, "crowded", {}),
    ("triangulate_insert", 8, "none", {}),
    ("triangulate_insert", 2, "random", {"m": 50, "k": 300, "n": 40}),
    ("triangulate_insert", 8, "random", {"policy": 2}),
    ("triangulate_insert", 8, "random", {"policy": 3, "m": 4096}),
    ("triangulate_insert", 8, "random", {"staged_threshold": 0, "m": 4096,
                                         "k": 896}),
    ("triangulate_insert", 1, "random", {"rgbd": True, "policy": 2,
                                         "staged_threshold": 0, "m": 8192,
                                         "k": 1024}),
    ("triangulate_insert", 8, "random", {"rgbd": True, "k": 1024}),
    # the cluster kernels (staged_promote, triangulate_insert): more streams
    # than path 3's, K at _require_k's bound, a map smaller than the
    # cluster's blocks (the last ranges empty), no candidate beside full
    # stores, and row widths that are 16-byte multiples and that are not
    *((name, s, "random", {}) for name in CLUSTER_OPS for s in (16, 20)),
    *((name, 2, "random", {"k": 2048}) for name in CLUSTER_OPS),
    *((name, 2, "random", {"m": 9, "k": 10, "n": 3})
      for name in CLUSTER_OPS),
    *((name, 2, "none_full", {}) for name in CLUSTER_OPS),
    *((name, 3, "random", {"m": 64, "k": 128, "n": 32})
      for name in CLUSTER_OPS),
    *((name, 3, "random", {"m": 51, "k": 301, "n": 41})
      for name in CLUSTER_OPS),
    # ba_observe: path 2's window (F = 4, M = 1024, K = 1536), an empty and
    # a full window, no candidate, no staged set, no right camera, F from
    # 1 to 8, M past a block's threads, K at the bound, S up to 20
    ("ba_observe", 1, "random", {}), ("ba_observe", 8, "random", {}),
    ("ba_observe", 8, "empty", {}), ("ba_observe", 8, "full", {}),
    ("ba_observe", 8, "none", {}), ("ba_observe", 2, "random", {"n": 0}),
    ("ba_observe", 3, "random", {"k": 0}),
    ("ba_observe", 3, "random", {"f": 1}),
    ("ba_observe", 2, "full", {"f": 8, "m": 3000}),
    ("ba_observe", 2, "random", {"k": 2048, "m": 64}),
    ("ba_observe", 20, "random", {"f": 2, "m": 300, "k": 200}),
]
# the cluster kernels' cases held at every cluster size the wrapper can
# choose (core/track.py CLUSTERS)
CLUSTER_CASES = [c for c in TRACK_CASES if c[0] in CLUSTER_OPS
                 and c[1] <= 8
                 and c[2] in ("random", "full", "none", "none_full")]


def _case_id(c):
    name, s, case, kw = c
    return "-".join([name, f"s{s}", case,
                     *(f"{k}{v}" for k, v in sorted(kw.items()))])


@pytest.mark.cuda
@pytest.mark.parametrize("c", TRACK_CASES, ids=[_case_id(c) for c in
                                                TRACK_CASES])
def test_track_kernel_matches_plain(cuda, c):
    """Each of the tracking branch's kernels against its plain version on
    the card, every output bit-equal (NaN where the plain version has
    one), and each stream of an S-stream launch bit-equal to its own S =
    1 launch; the stores' edges: no free slot, every slot free, fewer
    free slots than new points, no candidate, more candidates than map
    slots."""
    name, s, case, kw = c
    args = _track_problem(np.random.RandomState(len(name) + s), name, s,
                          cuda, case, **kw)
    op = _track_op(name)
    got = op(*args)
    _assert_outputs_equal(got, _track_plain(name, args), name)
    for i in range(s):
        alone = op(*(x[i:i + 1] if isinstance(x, torch.Tensor) else x
                     for x in args))
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"{name} stream {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("c", CLUSTER_CASES, ids=[_case_id(c) for c in
                                                  CLUSTER_CASES])
def test_track_cluster_kernel_at_every_cluster_size(cuda, monkeypatch, c,
                                                     cluster):
    """``staged_promote`` and ``triangulate_insert`` launched with each
    cluster size the wrapper may choose (``track.cluster_size``), every
    output bit-equal to the plain version's, each stream to its S = 1
    launch; a size whose blocks cannot hold the shape is refused."""
    from lvt_tpu_torch.core import track

    monkeypatch.setattr(track, "cluster_size", lambda *a, **kw: cluster)
    name, s, case, kw = c
    args = _track_problem(np.random.RandomState(len(name) + s), name, s,
                          cuda, case, **kw)
    op = _track_op(name)
    if name == "staged_promote":   # (K, M, N, rgbd)
        dims = (args[9].shape[1], args[11].shape[1], args[0].shape[1], 0)
    else:
        dims = (args[4].shape[1], args[11].shape[1], args[16].shape[1],
                int(args[24]))
    if not kernels.lib().lvt_track_max_clusters(CLUSTER_OPS.index(name),
                                                cluster, *dims):
        with pytest.raises(RuntimeError, match="failed to launch"):
            op(*args)
        return
    got = op(*args)
    _assert_outputs_equal(got, _track_plain(name, args), f"{name} C={cluster}")
    for i in range(s):
        alone = op(*(x[i:i + 1] if isinstance(x, torch.Tensor) else x
                     for x in args))
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"{name} C={cluster} stream {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CLUSTER_OPS)
def test_track_cluster_kernel_reads_rows_at_any_alignment(cuda, name):
    """The cluster kernels on inputs whose rows start 4 bytes past a
    16-byte boundary (each tensor a view one element into its storage:
    descriptors read word by word) give the bits of the aligned inputs."""
    args = _track_problem(np.random.RandomState(9), name, 3, cuda,
                          m=64, k=128, n=32)
    shifted = [torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
               .view_as(x).copy_(x) if isinstance(x, torch.Tensor) else x
               for x in args]
    assert shifted[4].data_ptr() % 16 == 4
    op = _track_op(name)
    _assert_outputs_equal(op(*shifted), op(*args), name)
    _assert_outputs_equal(op(*shifted), _track_plain(name, args), name)


@pytest.mark.cuda
def test_track_cluster_size_fits_the_streams(cuda):
    """The wrapper's choice: 8 blocks a stream at path 1's and path 3's
    shapes, and at 20 streams; every choice runs S clusters at once or is
    the largest that runs."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core import track

    for name in CLUSTER_OPS:
        for s in (1, 8, 20):
            c = track.cluster_size(name, 0, s, 1536, 1024, 1024)
            assert c == 8, (name, s, c)
            fit = kernels.lib().lvt_track_max_clusters(
                CLUSTER_OPS.index(name), c, 1536, 1024, 1024, 0)
            assert fit >= s, (name, s, fit)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRACK_OPS)
def test_track_op_vmap_rule_launches_once(cuda, name):
    """Under ``torch.func.vmap`` over 3 streams the op launches once, and
    gives each stream the bits of its S = 1 call."""
    from lvt_tpu_torch.core import track

    args = _track_problem(np.random.RandomState(7), name, 3, cuda)
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    rest = args[len(tensors):]
    op = _track_op(name)
    wrapper = getattr(track, name)
    before = wrapper.launches
    got = torch.func.vmap(lambda *a: op(*(x[None] for x in a), *rest))(
        *tensors)
    assert wrapper.launches == before + 1
    for i in range(3):
        alone = op(*(x[i:i + 1] for x in tensors), *rest)
        _assert_outputs_equal([x[i, 0] for x in got], [x[0] for x in alone],
                              f"{name} stream {i}")


@pytest.mark.cuda
def test_track_ops_capture_in_a_graph(cuda):
    """The four launches captured in a CUDA graph and replayed give the
    eager launches' bits."""
    ops = [(_track_op(name), _track_problem(np.random.RandomState(3), name,
                                            2, cuda)) for name in TRACK_OPS]
    eager = [op(*args) for op, args in ops]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [op(*args) for op, args in ops]
    graph.replay()
    torch.cuda.synchronize()
    for (name, got), want in zip(zip(TRACK_OPS, outs), eager):
        _assert_outputs_equal(got, want, name)


# ---- corner selection (ops/detect.py, csrc/select.cu) and the map match's
# acceptance (ops/matching.py, csrc/track.cu's map_accept_kernel)

def sparse_map(rs, b, h, w, density=0.04, top=120):
    """NMS-like [B, H, W] maps: integer scores at a few pixels, zero
    elsewhere (what kernel A's NMS leaves on uint8 frames)."""
    keep = rs.rand(b, h, w) < density
    return np.where(keep, rs.randint(1, top, (b, h, w)), 0).astype(np.float32)


def _select_config(name):
    """(config, frame dtype) of each path's selection: path 1's KITTI
    (uint8, dithered), path 2's dense KITTI (subpixel on the raw map),
    path 4's default 640x480, TUM fr1's one cell of 307,200 px keeping
    1000, EuRoC's rectified float frames (no dither)."""
    from lvt_tpu_torch import configs
    from lvt_tpu_torch.config import VOConfig

    if name == "kitti":
        return configs.kitti_config(), "uint8"
    if name == "kitti-dense":
        return configs.kitti_ba_dense_config(), "uint8"
    if name == "rgbd":
        return VOConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                        baseline=0.1, img_width=640, img_height=480), "uint8"
    if name == "tum":
        return configs.tum_rgbd_config(1), "uint8"
    return configs.euroc_config(), "float32"


SELECT_CASES = [("kitti", 2, "frames"), ("kitti", 16, "frames"),
                ("kitti", 32, "frames"), ("kitti", 3, "fallback"),
                ("kitti", 2, "plateau"), ("kitti-dense", 2, "frames"),
                ("kitti-dense", 16, "frames"), ("kitti-dense", 3, "fallback"),
                ("rgbd", 4, "frames"), ("tum", 1, "frames"),
                ("tum", 8, "frames"), ("tum", 3, "fallback"),
                ("euroc", 2, "frames"), ("euroc", 2, "fallback")]


def select_problem(rs, name, b, kind, device):
    """The op's arguments for ``b`` images at a path's shape: kernel A's
    maps of random frames (``frames``), sparse maps whose images differ in
    strength so that some take the low-corner fallback and some not
    (``fallback``), or a plateau of equal scores wider than a cell keeps
    (``plateau``); in the dense mode kernel B's planes of the frames (else
    random words), from which the op reads each slot's descriptor."""
    config, dtype = _select_config(name)
    h, w = config.img_height, config.img_width
    subpixel = config.descriptor_mode == "dense"
    if kind == "frames":
        imgs = torch.from_numpy(_frames(rs, b, h, w)).to(device)
        if dtype == "float32":
            imgs = imgs.float() + torch.from_numpy(
                rs.rand(b, h, w).astype(np.float32)).to(device)
        maps = (perception.perception_maps_batched(imgs) if subpixel
                else perception.perception_patch_maps_batched(imgs))
        nms, raw = (maps[1], maps[0]) if subpixel else (maps[0], maps[1])
        planes = maps[2]
    else:
        planes = torch.from_numpy(rs.randint(
            -2**31, 2**31, (b, 8, h, w), dtype=np.int64).astype(np.int32)
        ).to(device)
        if kind == "fallback":
            # every other image too sparse to reach the low-corner count
            nms = np.stack([sparse_map(rs, 1, h, w, (2e-4, 4e-3)[i % 2])[0]
                            for i in range(b)])
        else:
            nms = np.zeros((b, h, w), np.float32)
            nms[:, 8:300:2, 4:1200:2] = 40.0
            nms[:, 10:200:8, 9:900:6] = 55.0
        if dtype == "float32":
            nms = nms * rs.uniform(0.5, 1.5, nms.shape).astype(np.float32)
        nms = torch.from_numpy(nms).to(device)
        raw = nms + 1.0
    raw = raw if subpixel else nms.new_zeros((0,))
    planes = planes if subpixel else planes.new_zeros((0,))
    return (nms.contiguous(), raw.contiguous(), planes.contiguous(),
            float(config.agast_threshold), config.detection_cell_size,
            config.max_keypoints_per_cell, config.corners_low_threshold,
            dtype == "uint8", config.kp_capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SELECT_CASES,
                         ids=["-".join(map(str, c)) for c in SELECT_CASES])
def test_select_kernel_matches_plain(cuda, case):
    """Kernel CS against its plain version (the torch ops on the card),
    every slot of every output bit-equal (the dense mode's descriptors
    too), one launch; each image alone equal to its slot rows of the
    batch."""
    from lvt_tpu_torch.ops import detect

    name, b, kind = case
    args = select_problem(np.random.RandomState(b), name, b, kind, cuda)
    before = detect.select_slots.launches
    got = detect.select_corners_op(*args)
    torch.cuda.synchronize()
    assert detect.select_slots.launches == before + 1
    _assert_outputs_equal(got, detect.select_corners_plain(*args),
                          f"select_corners {case}")
    if kind == "fallback":   # both branches occur
        t, _ = detect._thresholds(args[3])
        strong = ((got[4] > t) & got[5]).sum(1)
        assert (strong < args[6]).any() and (strong >= args[6]).any()
    if args[2].numel():
        assert got[9].any() and (got[5] & ~got[9]).any()
    for i in range(b):
        alone = detect.select_corners_op(
            *(x[i:i + 1] if x.numel() else x for x in args[:3]), *args[3:])
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"select_corners image {i}")


# (B, H, W, cell, keep, density, dither, raw map): the selection's edges
SELECT_EDGES = {
    "one-block-cell": (2, 1, 200, 64, 20, 0.2, True, False),
    "rows-fewer-than-the-cluster": (2, 5, 300, 64, 30, 0.1, True, True),
    "keep-more-than-a-block-holds": (3, 64, 96, 32, 200, 0.3, True, False),
    "16-images": (16, 120, 256, 64, 40, 0.05, True, False),
    "ties-at-0": (2, 64, 96, 32, 60, 0.01, False, False),
    "ties-at-0-raw": (2, 64, 96, 32, 60, 0.01, False, True),
    "ties-at-0-wide-cells": (2, 128, 192, 64, 40, 0.002, False, False),
    "dense-bin": (2, 128, 256, 128, 100, 0.4, True, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SELECT_EDGES))
def test_select_kernel_at_its_edges(cuda, case):
    """The cluster kernel at the edges of its design, every slot bit-equal
    to the plain version: a cell of one row (one block of the cluster
    holds it all), fewer rows than blocks, more kept than a block holds
    pixels (k = 200 of a 32 x 32 cell, 128 px a block), 16 images in one
    launch, and no dither with fewer non-zero pixels than a cell keeps
    (ties at 0, cut lowest index first across the blocks, in narrow and
    wide cells), and a dense first bin (more passes); with the raw map
    also the dense mode's descriptors from random planes."""
    from lvt_tpu_torch.ops import detect

    b, h, w, cell, keep, density, dither, subpixel = SELECT_EDGES[case]
    rs = np.random.RandomState(len(case))
    nms = sparse_map(rs, b, h, w, density)
    if case == "dense-bin":   # scores spread over [32, 64): one top bin
        nms = np.where(nms > 0, rs.uniform(32, 64, nms.shape), 0)
    nms = torch.from_numpy(nms.astype(np.float32)).to(cuda)
    raw = nms + 0.5 if subpixel else nms.new_zeros((0,))
    planes = (torch.from_numpy(rs.randint(-2**31, 2**31, (b, 8, h, w),
                                          dtype=np.int64).astype(np.int32))
              .to(cuda) if subpixel else nms.new_zeros((0,), dtype=torch.int32))
    ncells = -(-h // min(cell, h)) * -(-w // min(cell, w))
    cap = -(-ncells * keep // 128) * 128
    args = (nms, raw, planes, 20.0, cell, keep, 40, dither, cap)
    got = detect.select_corners_op(*args)
    torch.cuda.synchronize()
    _assert_outputs_equal(got, detect.select_corners_plain(*args),
                          f"select_corners {case}")
    for i in (0, b - 1):
        alone = detect.select_corners_op(
            *(x[i:i + 1] if x.numel() else x for x in args[:3]), *args[3:])
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"select_corners {case} image {i}")


@pytest.mark.cuda
def test_select_kernel_geometry_runs_in_one_wave(cuda):
    """Path 1's KITTI pair (20 cells) and TUM fr1's one cell at 1 and 8
    images fit the card at once at the kernel's shared memory with blocks
    of 512 threads (cudaOccupancyMaxActiveClusters), which the wrapper
    takes for them; path 3's 16 images (160 clusters) do not, and take
    256; both block sizes give the plain version's bits there; a cell too
    large for 16 blocks is refused with the bounds the geometry entry
    reports."""
    import ctypes

    from lvt_tpu_torch import configs
    from lvt_tpu_torch.ops import detect

    for config, b in ((configs.kitti_config(), 2),
                      (configs.tum_rgbd_config(1), 1),
                      (configs.tum_rgbd_config(1), 8),
                      (configs.kitti_config(), 16)):
        dims = (b, config.img_height, config.img_width,
                config.detection_cell_size, config.max_keypoints_per_cell,
                config.kp_capacity)
        geo = (ctypes.c_int * 7)()
        assert kernels.lib().lvt_select_geometry(*dims[1:], geo) == 0
        assert geo[1] == 8 and geo[6] == 512
        fit = kernels.lib().lvt_select_max_clusters(*dims, 512)
        threads = detect.select_threads(torch.cuda.current_device(), *dims)
        assert (fit >= b * geo[0]) == (b < 16), (config.img_width, b, fit)
        assert threads == (512 if b < 16 else 256)
    args = select_problem(np.random.RandomState(5), "kitti", 16, "frames",
                          cuda)
    want = detect.select_corners_plain(*args)
    for threads in (512, 256):
        detect.select_threads.cache_clear()
        real = kernels.lib().lvt_select_max_clusters
        kernels.lib().lvt_select_max_clusters = (
            lambda *a, n=10 ** 6 if threads == 512 else 0: n)
        try:
            got = detect.select_corners_op(*args)
            torch.cuda.synchronize()
        finally:
            kernels.lib().lvt_select_max_clusters = real
            detect.select_threads.cache_clear()
        _assert_outputs_equal(got, want, f"select_corners {threads} threads")
    nms = torch.zeros((1, 4000, 4000), device=cuda)
    with pytest.raises(ValueError, match="a cluster of at most 16 blocks"):
        detect.select_corners_op(nms, nms.new_zeros((0,)),
                                 nms.new_zeros((0,), dtype=torch.int32),
                                 20.0, 4000, 100, 40, True, 128)


def top2_out(rs, m, k, n_cand, visible):
    """One radius's top-2 as kernel T gives it: d1 <= d2 small integers
    (ties across queries), hamming.BIG where there is no candidate, best a
    feature index, n_cand 0, 1 or more; none for invisible queries."""
    n = np.where(visible, n_cand, 0).astype(np.int64)
    d1 = rs.randint(0, 12, m).astype(np.float32) * 4
    d2 = d1 + rs.randint(0, 40, m).astype(np.float32)
    best = rs.randint(0, k, m).astype(np.int64)
    d1 = np.where(n >= 1, d1, hamming.BIG).astype(np.float32)
    d2 = np.where(n >= 2, d2, hamming.BIG).astype(np.float32)
    return d1, d2, np.where(n >= 1, best, 0), n


def accept_problem(rs, m, k, case):
    """Kernel T's outputs at both radii, visibility, and the features'
    validity and keypoints, for a map match whose narrow radius suffices
    (``narrow``) or leaves the retry its turn (``wide``)."""
    visible = rs.rand(m) > 0.2
    n_a = rs.choice([0, 1, 2, 3, 7], m, p=[0.3, 0.2, 0.2, 0.2, 0.1])
    if case == "wide":
        n_a = np.where(rs.rand(m) < 0.8, 0, n_a)
    n_b = np.maximum(n_a, rs.choice([0, 1, 2, 5], m))
    narrow = top2_out(rs, m, k, n_a, visible)
    wide = top2_out(rs, m, k, n_b, visible)
    # a few queries share a feature and a distance: the lower query wins
    narrow[2][:6] = 5
    narrow[0][:6] = np.where(narrow[3][:6] > 0, 8.0, hamming.BIG)
    kp = rs.uniform(0, 300, (k, 2)).astype(np.float32)
    valid = rs.rand(k) > 0.1
    return narrow, wide, visible, valid, kp


def accept_edge(prob, edge):
    """``accept_problem``'s problem at an edge of map_accept_kernel's order:
    ``invisible`` (no query in view, so T gives none a candidate), ``ties``
    (every fifth query on feature 5 at distance 8, both radii: the lowest
    query wins) or ``best_k`` (every seventh query accepted at target K,
    the resolution's extra slot: counted, never claimed, K - 1's
    keypoint); any other edge leaves it as it is."""
    narrow, wide, visible, valid, kp = prob
    m, k = visible.shape[0], kp.shape[0]
    big = np.float32(hamming.BIG)
    if edge == "invisible":
        visible = np.zeros(m, bool)
        none = (np.full(m, big), np.full(m, big), np.zeros(m, np.int64),
                np.zeros(m, np.int64))
        return none, none, visible, valid, kp
    if edge in ("ties", "best_k"):
        at = np.arange(0, m, 5) if edge == "ties" else np.arange(1, m, 7)
        target, d1 = (5, 8.0) if edge == "ties" else (k, 4.0)
        narrow, wide = ([x.copy() for x in narrow], [x.copy() for x in wide])
        for d1s, d2s, best, n_cand in (narrow, wide):
            d1s[at], d2s[at], best[at], n_cand[at] = d1, big, target, 1
        narrow, wide = tuple(narrow), tuple(wide)
    return narrow, wide, visible, valid, kp


def accept_args(rs, s, m, k, device, cases=("narrow", "wide"), edge=None):
    """The map_accept op's tensors for ``s`` streams (their cases in
    turn, each at ``accept_edge``'s ``edge``): fout, iout (kernel T's
    layout), visible, feat_valid, feat_kp."""
    probs = [accept_edge(accept_problem(rs, m, k, cases[i % len(cases)]),
                         edge) for i in range(s)]
    packed = [top2._pack(tuple(map(torch.from_numpy, p[0])),
                         tuple(map(torch.from_numpy, p[1]))) for p in probs]
    return [torch.stack([p[j] for p in packed]).to(device)
            for j in (0, 1)] + [
        torch.from_numpy(np.stack([p[i] for p in probs])).to(device)
        for i in (2, 3, 4)]


# (S, M, K) and (S, M, K, edge): accept_edge's edges, and stream 0's
# narrow count at the retry's threshold (``retry_at``: the narrow radius
# used) and one below it (``retry_below``: the wide retry taken)
ACCEPT_CASES = [(1, 1024, 1536), (8, 1024, 1536), (16, 1024, 1536),
                (2, 4096, 896), (1, 8192, 1024), (8, 8192, 1024),
                (4, 50, 300), (1, 1024, 1536, "retry_at"),
                (8, 1024, 1536, "retry_below"), (8, 1024, 1536, "invisible"),
                (8, 1024, 1536, "ties"), (8, 1024, 1536, "best_k"),
                (2, 4096, 896, "best_k"), (2, 8192, 1024, "ties"),
                (4, 50, 300, "best_k")]


def accept_retry(args, edge, m):
    """map_accept's retry threshold for ACCEPT_CASES' edge: stream 0's
    narrow count (``retry_at``) or one more (``retry_below``), else the
    tests' m / 25."""
    from lvt_tpu_torch.ops import matching

    if edge not in ("retry_at", "retry_below"):
        return max(1, m // 25)
    narrow = matching._map_accept_flat(*(x[0].cpu() for x in args), 0.8,
                                       30.0, 0)[4]
    return int(narrow) + (edge == "retry_below")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ACCEPT_CASES,
                         ids=["-".join(["s%d-m%d-k%d" % c[:3], *c[3:]])
                              for c in ACCEPT_CASES])
def test_map_accept_kernel_matches_plain(cuda, shape):
    """Kernel MM against its plain version on the card, every output
    bit-equal, at the paths' shapes (S = 1, 8, 16 at KITTI's 1024 x 1536;
    EuRoC's 4096 x 896; TUM's 8192 x 1024; more features than queries),
    narrow and wide streams in turn, and at the edges of the kernel's
    order (the retry's threshold, no query visible, ties on one feature,
    a best of K); each stream equal to its S = 1 launch."""
    from lvt_tpu_torch.ops import matching

    s, m, k, *edge = shape
    edge = edge[0] if edge else None
    args = accept_args(np.random.RandomState(m + s), s, m, k, cuda,
                       edge=edge)
    scalars = (0.8, 30.0, accept_retry(args, edge, m))
    before = matching.map_accept.launches
    got = matching.map_accept_op(*args, *scalars)
    torch.cuda.synchronize()
    assert matching.map_accept.launches == before + 1
    want = kernels.per_stream(matching._map_accept_flat, 5,
                              [*args, *scalars])
    _assert_outputs_equal(got, want, f"map_accept {shape}")
    if edge in ("retry_at", "retry_below"):
        assert bool(got[5][0]) == (edge == "retry_below")
    for i in range(s):
        alone = matching.map_accept_op(*(x[i:i + 1] for x in args), *scalars)
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"map_accept stream {i}")


@pytest.mark.cuda
def test_map_accept_refuses_more_features_than_a_block_holds(cuda):
    """The kernel gives each thread two features: K = 2049 is refused
    before a launch (K <= 2048 is kernel T's bound too)."""
    from lvt_tpu_torch.ops import matching

    args = accept_args(np.random.RandomState(1), 1, 64, 2049, cuda)
    before = matching.map_accept.launches
    with pytest.raises(ValueError, match="2048"):
        matching.map_accept_op(*args, 0.8, 30.0, 10)
    assert matching.map_accept.launches == before


@pytest.mark.cuda
def test_map_accept_vmap_rule_launches_once(cuda):
    """Under ``torch.func.vmap`` over 3 streams the op launches once, and
    gives each stream the bits of its S = 1 call."""
    from lvt_tpu_torch.ops import matching

    args = accept_args(np.random.RandomState(3), 3, 1024, 1536, cuda)
    scalars = (0.8, 30.0, 40)
    before = matching.map_accept.launches
    got = torch.func.vmap(lambda *a: matching.map_accept_op(
        *(x[None] for x in a), *scalars))(*args)
    assert matching.map_accept.launches == before + 1
    for i in range(3):
        alone = matching.map_accept_op(*(x[i:i + 1] for x in args), *scalars)
        _assert_outputs_equal([x[i, 0] for x in got], [x[0] for x in alone],
                              f"stream {i}")


@pytest.mark.cuda
def test_select_and_accept_capture_in_a_graph(cuda):
    """Both launches captured in a CUDA graph (the selection's memset node
    with it) and replayed twice give the eager launches' bits."""
    from lvt_tpu_torch.ops import detect, matching

    sel = select_problem(np.random.RandomState(1), "kitti", 2, "frames",
                         cuda)
    acc = accept_args(np.random.RandomState(2), 2, 1024, 1536, cuda)
    eager = (detect.select_corners_op(*sel),
             matching.map_accept_op(*acc, 0.8, 30.0, 40))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (detect.select_corners_op(*sel),
                matching.map_accept_op(*acc, 0.8, 30.0, 40))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            _assert_outputs_equal(got, want, "replay")


# ---- the step's tail (core/tail.py, csrc/tail.cu's step_tail_kernel) and
# the runner's copy of the state (core/graphs.py, copy_leaves_kernel)

TAIL_MIN_MATCHES = 10


def tail_problem(rs, s, device, m=1024, n=1024, k=1536, f=0, ba=None,
                 statuses=(1, 2, 3)):
    """Seeded arguments of the tail's kernel (``tail._launch``) for ``s``
    streams (the state's leaves, the tracked values', the TailInputs;
    lists of [S, ...] tensors), as the step gives them: stores about half
    full, a BA window of ``f`` poses ([0]-sized at 0), local BA's flag
    where ``ba`` (default: f > 0), stream i's status ``statuses[i % len]``
    (1 init, 2 tracking, 3 lost), and its match count from none to most of
    the map (every third stream under TAIL_MIN_MATCHES); the observations
    and distances fractional, so the means' sums round."""
    from lvt_tpu_torch.core import tail

    ba = f > 0 if ba is None else ba
    f32 = np.float32

    def state_like():
        return [*_store_arrays(rs, s, m, "random"),
                *_store_arrays(rs, s, n, "random"),
                rs.randn(s, 3).astype(f32), _unit_q(rs, s, 0.1),
                _unit_q(rs, s, 0.1), rs.randn(s, 3).astype(f32),
                rs.randn(s, 3).astype(f32), _unit_q(rs, s, 0.05),
                (rs.rand(s, 3) * 500).astype(f32),
                rs.randint(0, 1000, s).astype(np.int32),
                np.array([statuses[i % len(statuses)] for i in range(s)],
                         np.int32),
                rs.randn(s, f, 3).astype(f32),
                _unit_q(rs, s * f, 0.1).reshape(s, f, 4),
                (rs.rand(s, f, m, 2) * 900).astype(f32),
                (rs.rand(s, f, m) < 0.5).astype(f32),
                (rs.rand(s, f, m, 2) * 900).astype(f32),
                (rs.rand(s, f, m) < 0.3).astype(f32),
                rs.randint(0, f + 1, s).astype(np.int32)]

    frac = np.array([(0.005, 0.4, 0.9)[i % 3] for i in range(s)])
    matched = rs.rand(s, m) < frac[:, None]
    idx = np.where(matched, rs.randint(0, k, (s, m)), -1).astype(np.int64)
    inputs = [rs.randint(0, 12, (s, m)).astype(np.int32),
              rs.randint(0, 300, (s, m)).astype(np.int32), idx,
              (rs.randint(0, 90, (s, m)) + rs.rand(s, m)).astype(f32),
              np.where(rs.rand(s, m) < 0.2, BIG,
                       rs.randint(0, 160, (s, m)) + rs.rand(s, m)
                       ).astype(f32),
              np.where(matched[..., None], rs.rand(s, m, 2) * [1241, 376],
                       np.nan).astype(f32),
              rs.rand(s, k) < 0.8, matched.sum(1).astype(np.int64),
              rs.randint(0, m + 1, s).astype(np.int64),
              rs.randint(0, m + 1, s).astype(np.int64),
              rs.randint(0, 400, s).astype(np.int64), rs.rand(s) < 0.5,
              rs.rand(s) < 0.5 if ba else np.zeros((s, 0), bool)]
    to = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
          for x in (*state_like(), *state_like(), *inputs)]
    n_leaves = len(tail.PATHS)
    return to[:n_leaves], to[n_leaves:2 * n_leaves], to[2 * n_leaves:]


def _tail_plain(args):
    """The tail's plain version stream by stream (``tail._plain_streams``,
    on the tensors' own device)."""
    from lvt_tpu_torch.core import tail

    return tail._plain_streams(*args, TAIL_MIN_MATCHES)


def _tail_stream(args, i):
    return [[x[i:i + 1] for x in xs] for xs in args]


def _tail_inputs(values, lead) -> "TailInputs":
    """TailInputs of ``tail_problem``'s inputs for a launch over ``lead``
    (() or (S,)): the no-BA placeholder, one axis more than ``lead``,
    becomes None."""
    from lvt_tpu_torch.core import tail

    *rest, ba = values
    return tail.TailInputs(*rest, None if ba.dim() > len(lead) else ba)


def _tail_launch(args, lead):
    """One launch of the tail's kernel on ``tail_problem``'s lists (a
    stream axis: ``lead`` (S,))."""
    from lvt_tpu_torch.core import tail

    return tail._launch(*args[:2], _tail_inputs(args[2], lead),
                        TAIL_MIN_MATCHES, lead)


# (streams, problem keywords): paths 1 (BA off), 2 (a window of 4), 3 and
# 8d (8 streams), 4 (RGB-D: K = 1000), 5 (M = 4096, K = 896), 7 tum's M =
# 8192, twice that (16384: 8 slots a thread), a map whose threads stream
# their slots in batches (M = 40000), 20 streams, and sizes that are no
# multiple of a 16-byte unit
TAIL_CASES = [
    (1, {}), (1, {"f": 4}), (8, {}), (8, {"f": 4}), (1, {"k": 1000}),
    (1, {"m": 4096, "k": 896}), (8, {"m": 4096, "k": 896}),
    (2, {"m": 8192, "n": 8192, "k": 1000}),
    (2, {"m": 16384, "n": 16384, "k": 1000}),
    (1, {"m": 40000, "n": 64, "k": 1000}), (20, {}), (20, {"f": 4}),
    (3, {"m": 51, "n": 41, "k": 301, "f": 3}), (3, {"m": 1, "n": 0, "k": 5}),
    (3, {"f": 4, "ba": False}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("s,kw", TAIL_CASES,
                         ids=["-".join([f"s{s}", *(f"{k}{v}" for k, v in
                                                    sorted(kw.items()))])
                              for s, kw in TAIL_CASES])
def test_step_tail_kernel_matches_plain(cuda, s, kw):
    """The tail's kernel against its plain version on the card, every
    output bit-equal (NaN where the plain version has one), and each
    stream of the S-stream launch bit-equal to its own S = 1 launch: every
    status, match counts on both sides of the threshold, BA windows of 0,
    3 and 4 poses, unaligned leaves, maps of any size (states whose units
    the cluster holds over its barrier, 4 or 8 a thread, and larger ones
    whose rest streams after it)."""
    args = tail_problem(np.random.RandomState(s), s, cuda, **kw)
    got = _tail_launch(args, (s,))
    _assert_outputs_equal(got, _tail_plain(args), "step_tail")
    for i in range(s):
        alone = _tail_launch(_tail_stream(args, i), (1,))
        _assert_outputs_equal([x[0] for x in alone], [x[i] for x in got],
                              f"step_tail stream {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0, 4])
def test_step_tail_one_stream_launches_without_the_op(cuda, f):
    """``tail.step_tail`` on one stream's tensors launches the kernel
    without a stream axis in or out: one launch, the bits of an S = 1
    launch with the axis, every output with the one stream's shape."""
    from lvt_tpu_torch.core import tail
    from lvt_tpu_torch.core.state import VOState
    from lvt_tpu_torch.tree import from_leaves, leaves

    args = tail_problem(np.random.RandomState(7 + f), 3, cuda, f=f)
    for i in range(3):
        state, new, inputs = ([x[i] for x in xs] for xs in args)
        *rest, ba = inputs
        inp = tail.TailInputs(*rest, ba if f else None)
        before = tail.step_tail.launches
        got = tail.step_tail(from_leaves(tail._TEMPLATE, state),
                             from_leaves(tail._TEMPLATE, new), inp,
                             TAIL_MIN_MATCHES)
        assert tail.step_tail.launches == before + 1
        assert isinstance(got[0], VOState)
        flat = [*leaves(got[0]), *got[1], *got[2]]
        want = _tail_launch(_tail_stream(args, i), (1,))
        assert [x.shape for x in flat] == [x.shape[1:] for x in want]
        _assert_outputs_equal(flat, [x[0] for x in want],
                              f"step_tail stream {i}")


def _tail_state(args, i=0):
    from lvt_tpu_torch.core import tail
    from lvt_tpu_torch.tree import from_leaves

    return from_leaves(tail._TEMPLATE, [x[i] for x in args[0]])


@pytest.mark.cuda
def test_copy_leaves_kernel_copies_every_leaf(cuda):
    """The runner's copy on the card: one launch for a VOState's 26
    leaves, every byte of each (leaves of 0 elements, of 12 bytes and at
    offsets that are no multiple of 16 included); more leaves than a
    launch takes are refused, with no launch."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import leaves, tree_map

    args = tail_problem(np.random.RandomState(1), 2, cuda, m=51, n=41,
                        k=301, f=3)
    src = _tail_state(args)
    dst = tree_map(torch.zeros_like, src)
    before = graphs.copy_leaves.launches
    graphs.copy_leaves(dst, src)
    assert graphs.copy_leaves.launches == before + 1
    for d, s in zip(leaves(dst), leaves(src)):
        assert torch.equal(d.nan_to_num(), s.nan_to_num())
    # sources and buffers at odd offsets into larger storages
    store = torch.arange(8199, dtype=torch.int32, device=cuda).to(torch.uint8)
    out = torch.zeros(8199, dtype=torch.uint8, device=cuda)
    graphs.copy_leaves(Pose(out[3:4003], out[4100:8196]),
                       Pose(store[1:4001], store[4099:8195]))
    assert torch.equal(out[3:4003], store[1:4001])
    assert torch.equal(out[4100:8196], store[4099:8195])
    per = tail.tail_shape()[0]
    tree = collections.namedtuple("Leaves", [f"x{i}" for i in range(per + 3)])
    many = tree(*(torch.full((5,), i, dtype=torch.int32, device=cuda)
                  for i in range(per + 3)))
    into = tree_map(torch.zeros_like, many)
    before = graphs.copy_leaves.launches
    with pytest.raises(ValueError, match="leaves exceed"):
        graphs.copy_leaves(into, many)
    assert graphs.copy_leaves.launches == before
    assert not any(x.any() for x in into)


@pytest.mark.cuda
def test_copy_leaves_reads_every_source_before_writing(cuda):
    """A source that is also a buffer (two leaves swapped) is cloned before
    the one launch, so every element is read before it is written."""
    from lvt_tpu_torch.core import graphs

    a = torch.arange(70000, dtype=torch.float32, device=cuda)
    b = -a
    graphs.copy_leaves(Pose(a, b), Pose(b, a))
    assert torch.equal(a, torch.arange(70000, dtype=torch.float32,
                                       device=cuda).neg())
    assert torch.equal(b, torch.arange(70000, dtype=torch.float32,
                                       device=cuda))


@pytest.mark.cuda
def test_step_tail_and_copy_capture_in_a_graph(cuda):
    """The tail's launch and the copy captured in a CUDA graph and
    replayed give the eager launches' bits."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    args = tail_problem(np.random.RandomState(3), 2, cuda, f=4)
    eager = _tail_launch(args, (2,))
    buf = tree_map(torch.zeros_like, from_leaves(tail._TEMPLATE, args[0]))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _tail_launch(args, (2,))
        graphs.copy_leaves(buf, from_leaves(tail._TEMPLATE,
                                            outs[:len(tail.PATHS)]))
    graph.replay()
    torch.cuda.synchronize()
    _assert_outputs_equal(outs, eager, "step_tail")
    _assert_outputs_equal(leaves(buf), eager[:len(tail.PATHS)],
                          "copy_leaves")


def _tail_aliased(new, buffers, alias):
    """The tracked values ``new`` with leaves that alias the runner's
    ``buffers``: the staged set as the buffers themselves ("same"), or the
    map's counter and age from each other's buffers and, where M = N, the
    map's and staged set's validity too ("swapped": other addresses, which
    the kernel reads before its barrier)."""
    if alias == "same":
        return new._replace(staged=buffers.staged)
    if alias != "swapped":
        return new
    out = new._replace(map=new.map._replace(counter=buffers.map.age,
                                            age=buffers.map.counter))
    if buffers.map.valid.shape == buffers.staged.valid.shape:
        out = out._replace(
            map=out.map._replace(valid=buffers.staged.valid),
            staged=out.staged._replace(valid=buffers.map.valid))
    return out


def _table_counter(epilogue) -> int:
    """The runner's counter: the first 8 bytes of its chunk table."""
    return int(epilogue.table[:8].view(torch.int64).cpu())


# (streams, 0: one stream without a stream axis; reset; alias; frames in
# the chunk; problem keywords): path 1's state (6802 units a stream, 4 a
# thread), path 2's (BA: 12953, 8 a thread) and path 5's (M = 4096, no
# staged set: 13586), and M = 16384 (108562 units: the rest streams)
EPILOGUE_CASES = [
    (0, False, "none", 1, {}), (0, False, "same", 16, {"f": 4}),
    (0, False, "swapped", 2, {"m": 51, "n": 41, "k": 301, "f": 3}),
    (1, True, "none", 2, {}), (3, True, "swapped", 2,
                               {"m": 40, "n": 40, "k": 30, "f": 2}),
    (8, True, "same", 16, {}), (8, False, "none", 16, {"f": 4}),
    (20, True, "none", 2, {"f": 4}), (20, False, "swapped", 1, {}),
    (1, False, "swapped", 2, {"f": 4}),
    (1, True, "swapped", 2, {"m": 4096, "n": 0, "k": 896}),
    (2, True, "same", 16, {"m": 16384, "n": 16384, "k": 1000}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("s,reset,alias,frames,kw", EPILOGUE_CASES,
                         ids=[f"s{s}-{'reset' if r else 'noreset'}-{a}-n{f}"
                              f"{'-m' + str(kw['m']) if 'm' in kw else ''}"
                              for s, r, a, f, kw in EPILOGUE_CASES])
def test_step_tail_ends_the_frame_as_the_plain_tail_and_the_copies(
        cuda, s, reset, alias, frames, kw):
    """The kernel inside a runner's frame (core/graphs.py::Epilogue), frame
    after frame of a chunk, against the plain tail of the same buffers
    followed by the runner's copies: the buffers bit-equal (NaN for NaN)
    to the plain new state, after ``tail.reset_lost`` where the runner
    resets; row i of the chunk's rows to the plain pose and metrics; frame
    i + 1 of the chunk's two inputs in the input buffers; the counter i +
    1. New values that alias the buffers (the same buffer, or swapped:
    nothing is cloned) included; one stream without a stream axis and
    1-20 streams; states held over the barrier and a state that
    streams."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    n_streams = max(s, 1)
    args = tail_problem(np.random.RandomState(30 + s), n_streams, cuda, **kw)
    if s == 0:
        args = [[x[0] for x in xs] for xs in args]
    lead = (s,) if s else ()
    buffers = from_leaves(tail._TEMPLATE, [x.clone() for x in args[0]])
    new_vals = from_leaves(tail._TEMPLATE, args[1])
    fresh = (from_leaves(tail._TEMPLATE, [x[0].clone() for x in
                                          tail_problem(np.random.RandomState(
                                              5), 1, cuda, **kw)[0]])
             if reset else None)
    rs = np.random.RandomState(frames)
    chunk = [torch.from_numpy(rs.randint(0, 255, (frames, 37, 41),
                                         dtype=np.uint8)).to(cuda),
             torch.from_numpy(rs.randn(frames, 5).astype(np.float32))
             .to(cuda)]
    epilogue = graphs.Epilogue(buffers, [torch.empty_like(x[0])
                                         for x in chunk], reset=fresh)
    rows = epilogue.start(chunk)
    for i in range(frames):
        before = tree_map(torch.clone, buffers)
        plain = [x.unsqueeze(0) if not s else x for x in leaves(before)]
        lists = [plain, [x.unsqueeze(0) if not s else x for x in leaves(
            _tail_aliased(new_vals, before, alias))],
                 [x.unsqueeze(0) if not s else x for x in args[2]]]
        want = [x[0] if not s else x for x in _tail_plain(lists)]
        want_state, pose, metrics = tail._unpack(before, want)
        if reset:
            want_state = tail.reset_lost(want_state, fresh)
        before_launches = tail.step_tail.launches
        out = tail._launch(leaves(buffers), leaves(_tail_aliased(
            new_vals, buffers, alias)), _tail_inputs(args[2], lead),
            TAIL_MIN_MATCHES, lead, epilogue)
        assert out is None and epilogue.fused
        assert tail.step_tail.launches == before_launches + 1
        torch.cuda.synchronize()
        _assert_outputs_equal(leaves(buffers), leaves(want_state),
                              f"frame {i} state")
        _assert_outputs_equal([x[i] for x in graphs._rows_of(rows)],
                              [*pose, *metrics], f"frame {i} rows")
        for buf, x in zip(epilogue.inputs, chunk):
            assert torch.equal(buf, x[min(i + 1, frames - 1)])
        assert _table_counter(epilogue) == i + 1


@pytest.mark.cuda
def test_step_tail_refuses_overlap_past_what_it_holds(cuda):
    """A state whose units the kernel does not hold over its barrier (M =
    16384: the rest streams after it) with a source that overlaps another
    of the runner's buffers: refused before the launch (nothing cloned,
    nothing written, the counter where it was); the same state whose
    sources are their own buffers ends the frame."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    args = tail_problem(np.random.RandomState(9), 1, cuda, m=16384,
                        n=16384, k=1000)
    buffers = from_leaves(tail._TEMPLATE, [x.clone() for x in args[0]])
    new_vals = from_leaves(tail._TEMPLATE, args[1])
    chunk = [torch.zeros((2, 1, 7), dtype=torch.uint8, device=cuda)]
    epilogue = graphs.Epilogue(buffers, [torch.empty_like(chunk[0][0])])
    epilogue.start(chunk)
    before = tree_map(torch.clone, buffers)
    launches = tail.step_tail.launches
    with pytest.raises(ValueError, match="overlaps another"):
        tail._launch(leaves(buffers), leaves(_tail_aliased(
            new_vals, buffers, "swapped")), _tail_inputs(args[2], (1,)),
            TAIL_MIN_MATCHES, (1,), epilogue)
    assert tail.step_tail.launches == launches
    _assert_outputs_equal(leaves(buffers), leaves(before), "untouched")
    assert _table_counter(epilogue) == 0
    tail._launch(leaves(buffers), leaves(_tail_aliased(
        new_vals, buffers, "same")), _tail_inputs(args[2], (1,)),
        TAIL_MIN_MATCHES, (1,), epilogue)
    assert tail.step_tail.launches == launches + 1
    assert _table_counter(epilogue) == 1


@pytest.mark.cuda
def test_step_tail_ending_frames_captures_in_a_graph(cuda):
    """One frame's launch inside a runner's frame captured in a CUDA graph
    and replayed for a chunk of 16 frames (after one start) gives the
    eager launches' bits: the buffers, every row, the inputs; the graph
    replays no start, and replays past the chunk's end write no row."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves

    args = tail_problem(np.random.RandomState(8), 8, cuda, f=4)
    rs = np.random.RandomState(3)
    chunk = [torch.from_numpy(rs.randint(0, 255, (16, 8, 64, 48),
                                         dtype=np.uint8)).to(cuda)]
    fresh = from_leaves(tail._TEMPLATE, [x[0].clone() for x in args[0]])
    runs = []
    for mode in ("eager", "graph"):
        buffers = from_leaves(tail._TEMPLATE, [x.clone() for x in args[0]])
        epilogue = graphs.Epilogue(buffers, [torch.empty_like(chunk[0][0])],
                                   reset=fresh)

        def frame():
            tail._launch(leaves(buffers), args[1],
                         _tail_inputs(args[2], (8,)), TAIL_MIN_MATCHES,
                         (8,), epilogue)

        rows = epilogue.start(chunk)
        if mode == "graph":
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                frame()
            for _ in range(16):
                graph.replay()
        else:
            for _ in range(16):
                frame()
        torch.cuda.synchronize()
        runs.append([x.clone() for x in (*leaves(buffers),
                                         *graphs._rows_of(rows),
                                         epilogue.inputs[0])])
        if mode == "graph":
            graph.replay()         # past the chunk's end: no row written
            torch.cuda.synchronize()
            for a, b in zip(runs[-1][len(tail.PATHS):-1],
                            graphs._rows_of(rows)):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
    _assert_outputs_equal(runs[1], runs[0], "graph against eager")
    assert torch.equal(runs[1][-1], chunk[0][15])


@pytest.mark.cuda
@pytest.mark.parametrize("alias", ["none", "same", "swapped"])
def test_copy_leaves_ends_a_frame_as_the_cpu_does(cuda, alias):
    """The end of a frame whose tail ran as torch ops (a group's, or a step
    without the tail): ``Epilogue.finish`` on the card (one copy_leaves
    launch: the reset, the state, the rows by the counter, the next
    frame's inputs) against the same on the CPU, over a chunk of 3 frames:
    the buffers, every row and the input buffers bit-equal, the counter
    3."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    args = tail_problem(np.random.RandomState(4), 3, "cpu", m=40, n=40,
                        k=30, f=2)
    chunk = [torch.arange(3 * 7 * 5, dtype=torch.float32).reshape(3, 7, 5),
             torch.arange(3 * 11, dtype=torch.uint8).reshape(3, 11)]
    fresh = from_leaves(tail._TEMPLATE, [x[0].clone() for x in args[1]])
    out = {}
    for dev in ("cpu", cuda):
        to = lambda x: x.to(dev, copy=True)  # noqa: E731
        buffers = from_leaves(tail._TEMPLATE, [to(x) for x in args[0]])
        epilogue = graphs.Epilogue(buffers, [to(x[0]) * 0 for x in chunk],
                                   reset=tree_map(to, fresh))
        rows = epilogue.start([to(x) for x in chunk])
        before = graphs.copy_leaves.launches
        for _ in range(3):
            state, pose, metrics = tail._unpack(
                buffers, tail._plain_streams(leaves(buffers),
                                             [to(x) for x in args[1]],
                                             [to(x) for x in args[2]],
                                             TAIL_MIN_MATCHES))
            epilogue.finish(_tail_aliased(state, buffers, alias), pose,
                            metrics)
        if dev != "cpu":
            assert graphs.copy_leaves.launches == before + 3
            assert _table_counter(epilogue) == 3
        out[str(dev)] = [x.cpu() for x in (*leaves(buffers),
                                            *graphs._rows_of(rows),
                                            *epilogue.inputs)]
    _assert_outputs_equal(out["cuda"], out["cpu"], "the frame's end")
