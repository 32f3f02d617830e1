"""PnP's whole solve as one op, ``lvt_tpu_torch::pnp_solve``, and the
sharded solve's phases, ``lvt_tpu_torch::pnp_phase``, on the CPU (where
each is its plain version stream by stream; the CUDA kernel of
csrc/pnp_lm.cu is held against them in tests/test_torch_cuda.py).

Tolerances:
  * the op against lvt_tpu's solve_pnp on the same numpy inputs: pose
    within 1e-4 m and 1e-4 rad, inlier mask and count equal (the LM
    iterations reduce over the points in other orders, so the poses agree
    to float32 rounding, not bit for bit; tests/test_torch_solver.py's
    bounds);
  * the op under ``torch.func.vmap`` over 3 streams against the
    per-stream calls, the op against ``solve_pnp_plain``, and the phases
    composed with the all-reduces as identities (no group, and a
    one-rank gloo group) against the op: bit-equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.solver.pnp import solve_pnp as jx_solve_pnp
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops.collectives import all_reduce
from lvt_tpu_torch.parallel import mesh as mesh_mod
from lvt_tpu_torch.solver import pnp
from tests.test_torch_cuda import PNP_CAM as CAM, _pnp_problem
from tests.test_torch_system import share_the_cores  # noqa: F401


def _streams(seed: int, s: int, m: int, n_out=None):
    """[S, ...] CPU tensors of (t, q, points, obs, weights) from a seed
    (tests/test_torch_cuda.py's problem: an eighth of the points
    outliers unless ``n_out`` says otherwise)."""
    return _pnp_problem(np.random.RandomState(seed), s, m, "cpu", n_out)


def _angle(a, b) -> float:
    rel = quat.multiply(quat.normalize(a.double()),
                        quat.conjugate(quat.normalize(b.double())))
    return float(2 * torch.atan2(rel[1:].norm(), rel[0].abs()))


def _outputs(res: pnp.PnPResult):
    return (*res.pose, res.inlier_mask, res.inlier_count, res.chi2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_out", [0, 30], ids=["clean", "outliers"])
def test_pnp_solve_op_matches_lvt_tpu(seed, n_out):
    args = _streams(seed, 1, 256, n_out)
    got = pnp.pnp_solve(*args, **CAM)
    t0, q0, pts, uv, w = (jnp.asarray(x[0].numpy()) for x in args)
    want = jx_solve_pnp(JxPose(t0, q0), pts, uv, w, **CAM)
    t, q, inlier, count, chi2 = (x[0] for x in got)
    assert float(np.linalg.norm(t.numpy() - np.asarray(want.pose.t))) < 1e-4
    assert _angle(q, torch.from_numpy(np.array(want.pose.q))) < 1e-4
    assert int(count) == int(want.inlier_count) == int(inlier.sum())
    np.testing.assert_array_equal(inlier.numpy(), np.asarray(want.inlier_mask))
    assert chi2.dtype == torch.float32 and count.dtype == torch.int64
    # the outliers were demoted
    assert int(count) <= int(args[4].sum()) - n_out // 2


def test_pnp_solve_op_is_the_plain_version_stream_by_stream():
    """At S = 3 the op's CPU kernel, the entry point solve_pnp and
    solve_pnp_plain give one stream the same bits."""
    args = _streams(3, 3, 200)
    got = pnp.pnp_solve(*args, **CAM)
    for i in range(3):
        pose = Pose(args[0][i], args[1][i])
        rest = [x[i] for x in args[2:]]
        for res in (pnp.solve_pnp(pose, *rest, **CAM),
                    pnp.solve_pnp_plain(pose, *rest, **CAM)):
            for a, b in zip(_outputs(res), got):
                assert torch.equal(a, b[i])


def test_vmap_over_streams_is_the_per_stream_calls():
    """solve_pnp under torch.func.vmap over 3 streams (the multi-stream
    step) reaches the op's batching rule: every output bit-equal to the
    stream's own call, and no vmap fallback."""
    args = _streams(6, 3, 180)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = torch.func.vmap(lambda t, q, *a: _outputs(pnp.solve_pnp(
                Pose(t, q), *a, **CAM)))(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [w for w in caught if "fallback" in str(w.message)]
    for i in range(3):
        one = pnp.solve_pnp(Pose(args[0][i], args[1][i]),
                            *(x[i] for x in args[2:]), **CAM)
        for a, b in zip(res, _outputs(one)):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("kind", ["solve", "setup", "normal", "trial",
                                  "final"])
def test_fake_registration_shapes(kind):
    """Under fake tensors (what graph capture tooling and torch.func trace
    with) each op gives its outputs' shapes and types without running."""
    s, m = 4, 50
    with FakeTensorMode():
        if kind == "solve":
            out = pnp.pnp_solve(torch.empty(s, 3), torch.empty(s, 4),
                                torch.empty(s, m, 3), torch.empty(s, m, 2),
                                torch.empty(s, m), **CAM)
            want = [((s, 3), torch.float32), ((s, 4), torch.float32),
                    ((s, m), torch.bool), ((s,), torch.int64),
                    ((s,), torch.float32)]
        else:
            k = {"setup": pnp.K_SETUP, "normal": pnp.K_NORMAL,
                 "trial": pnp.K_TRIAL, "final": pnp.K_FINAL}[kind]
            tot_a = (torch.empty(s, pnp.TOT_A[k], dtype=torch.float64)
                     if k in pnp.TOT_A else None)
            out = pnp.pnp_phase(k, 1, torch.empty(s, pnp.NSTATE),
                                torch.empty(s, m), torch.empty(s, m, 3),
                                torch.empty(s, m, 2), tot_a,
                                torch.empty(s, dtype=torch.float64), **CAM)
            want = [((s, pnp.NSTATE), torch.float32), ((s, m), torch.float32),
                    ((s, pnp.PART_A[k]), torch.float64),
                    ((s,), torch.float64)]
    assert [(tuple(x.shape), x.dtype) for x in out] == want


@pytest.mark.parametrize("m,n_out", [(256, 30), (97, 0)])
def test_phases_with_identity_all_reduces_are_the_fused_op(m, n_out):
    """The sharded solve's N_PHASES phases with no group (every all-reduce
    the identity), alone and under vmap over 2 streams: every output
    bit-equal to the fused op's."""
    args = _streams(m, 2, m, n_out)
    fused = pnp.pnp_solve(*args, **CAM)
    one = pnp.solve_pnp_phases(Pose(args[0][0], args[1][0]),
                               *(x[0] for x in args[2:]), **CAM)
    for a, b in zip(_outputs(one), fused):
        assert torch.equal(a, b[0])
    res = torch.func.vmap(lambda t, q, *a: _outputs(pnp.solve_pnp_phases(
        Pose(t, q), *a, **CAM)))(*args)
    for a, b in zip(res, fused):
        assert torch.equal(a, b)


def test_phases_on_a_one_rank_group_are_the_fused_op(tmp_path):
    """solve_pnp with a one-rank gloo group: the phases and their 25
    all-reduces (the float64 partials summed over one rank), every output
    bit-equal to the unsharded op."""
    args = _streams(21, 1, 256)
    want = pnp.pnp_solve(*args, **CAM)
    mesh_mod.init("gloo", 1, 0, f"file://{tmp_path / 'rdv'}")
    try:
        calls = all_reduce.calls
        res = pnp.solve_pnp(Pose(args[0][0], args[1][0]),
                            *(x[0] for x in args[2:]), **CAM,
                            group=dist.group.WORLD)
        assert all_reduce.calls - calls == 25
    finally:
        dist.destroy_process_group()
    for a, b in zip(_outputs(res), want):
        assert torch.equal(a, b[0])


def test_the_cpu_launches_no_kernel():
    """On the CPU the wrappers' launch counts stand still."""
    args = _streams(9, 1, 64)
    before = (pnp.pnp_solve.launches, pnp.pnp_phase.launches,
              pnp.normal_equations.launches, pnp.stream_sum.launches)
    pnp.solve_pnp(Pose(args[0][0], args[1][0]), *(x[0] for x in args[2:]),
                  **CAM)
    pnp.solve_pnp_phases(Pose(args[0][0], args[1][0]),
                         *(x[0] for x in args[2:]), **CAM)
    assert (pnp.pnp_solve.launches, pnp.pnp_phase.launches,
            pnp.normal_equations.launches, pnp.stream_sum.launches) == before


# ---- the premises of csrc/pnp_lm.cu's schedule

def _one_sweep_solve(pose, points, obs, weights, *, fx, fy, cx, cy,
                     reprojection_th2=5.991):
    """The fused kernel's schedule in torch ops: one sweep over the points
    per LM iteration, at the trial pose, giving the trial chi-square and
    [H | g] there (but in a pass's last iteration); the accept test keeps
    the trial's [H | g] for the next step, a rejection the old one.
    Returns the result and the rejected steps of each pass."""
    pb = pnp._problem(points, obs, fx, fy, cx, cy, reprojection_th2)
    three = pnp.scalar(3.0, points)
    r_wc, t_wc = pnp._initial(pose)
    w_mask = weights.to(points.dtype)
    rejected = []
    for _ in range(pnp.N_PASSES):
        proj = pb.project(r_wc, t_wc)
        hg, h_diag = pb.normal_equations(proj, w_mask)
        lam, nu = pnp._lam0(h_diag), torch.tensor(2.0)
        chi2, e2 = pb.chi2(proj[3], w_mask), proj[3]
        n_rejected = 0
        for it in range(pnp.N_ITERS_PER_PASS):
            r_new, t_new, finite = pb.step(r_wc, t_wc, lam, hg)
            proj_new = pb.project(r_new, t_new)   # the iteration's one sweep
            chi2_new = pb.chi2(proj_new[3], w_mask)
            more = it + 1 < pnp.N_ITERS_PER_PASS
            hg_new = pb.normal_equations(proj_new, w_mask)[0] if more else None
            if bool((chi2_new < chi2) & finite):
                r_wc, t_wc, chi2, e2 = r_new, t_new, chi2_new, proj_new[3]
                lam, nu = lam / three, torch.tensor(2.0)
                hg = hg_new
            else:
                lam, nu = lam * nu, nu * 2.0
                n_rejected += 1
        rejected.append(n_rejected)
        w_mask = w_mask * (e2 <= pb.delta2)
    inlier = w_mask > 0
    return (pnp.PnPResult(pnp._final(r_wc, t_wc), inlier, inlier.sum(), chi2),
            rejected)


def _assert_same_solve(got: pnp.PnPResult, want: pnp.PnPResult):
    for a, b in zip(_outputs(got), _outputs(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("seed,rejects", [(0, False), (3, False),
                                          (5, False), (1, True), (2, True),
                                          (4, True)])
@pytest.mark.parametrize("n_out", [0, 30], ids=["clean", "outliers"])
def test_one_sweep_schedule_is_the_plain_solve(seed, rejects, n_out):
    """[H | g] taken at the trial projection and selected on accept, the
    last iteration of a pass adding none: bit-equal to solve_pnp_plain;
    the ``rejects`` seeds reject at least one step in each pass."""
    t, q, pts, obs, w = (x[0] for x in _streams(seed, 1, 256, n_out))
    got, rejected = _one_sweep_solve(Pose(t, q), pts, obs, w, **CAM)
    _assert_same_solve(got, pnp.solve_pnp_plain(Pose(t, q), pts, obs, w,
                                                **CAM))
    if rejects:
        assert min(rejected) >= 1, rejected


@pytest.mark.parametrize("seed", [1, 3])
def test_one_sweep_schedule_on_a_singular_system(seed):
    """Every point on one ray from the initial camera centre, at one
    observed pixel (H rank-deficient): the schedule is bit-equal to
    solve_pnp_plain and rejects steps in both passes."""
    t, q, pts, obs, w = (x[0] for x in _streams(seed, 1, 64, 0))
    s = torch.linspace(0.5, 3.0, pts.shape[0])[:, None]
    pts = t + s * (pts[:1] - t)
    obs = obs[:1].expand_as(obs).contiguous()
    w = torch.ones_like(w)
    got, rejected = _one_sweep_solve(Pose(t, q), pts, obs, w, **CAM)
    _assert_same_solve(got, pnp.solve_pnp_plain(Pose(t, q), pts, obs, w,
                                                **CAM))
    assert min(rejected) >= 1, rejected


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_equations_are_not_symmetric_to_the_bit(seed):
    """Why the kernel sums all 42 entries of [H | g] and not H's upper
    triangle: jw_i = jac_i * w is rounded to float32 before its exact
    float64 product with jac_j, so H[i][j] and H[j][i] add other products
    (most of them differ), and H rounded to float32 is not symmetric, in
    the kernel's sums (modelled here in float64) as in the plain
    version's."""
    rs = np.random.RandomState(seed)
    jac = (rs.randn(1024, 2, 6) * [1e3, 1e3, 3e2, 5e2, 8e2, 4e2]).astype(
        np.float32)
    w = rs.rand(1024).astype(np.float32)
    jw = (jac * w[:, None, None]).astype(np.float32)
    terms = (jw.astype(np.float64)[..., :, None]
             * jac.astype(np.float64)[..., None, :])
    assert (terms != np.swapaxes(terms, -1, -2)).mean() > 0.5
    h = terms.sum((0, 1)).astype(np.float32)
    assert not np.array_equal(h, h.T)
    np.testing.assert_allclose(h, h.T, rtol=1e-6, atol=0)
    hg = pnp.normal_equations_plain(*map(torch.from_numpy, (
        jac, w, rs.randn(1024, 2).astype(np.float32))))[0]
    assert not torch.equal(hg[:, :6], hg[:, :6].T)
