"""Local BA's whole body as one op, ``lvt_tpu_torch::ba_refine``, on the
CPU, where it is its plain version stream by stream
(``bundle.refine_structure_plain``: the torch ops of the gate, the
refinement and the writeback test); the CUDA kernel of csrc/ba.cu is held
against it bit for bit in tests/test_torch_cuda.py and by chip_smoke.py.

Tolerances:
  * the op against the plain body, and ``step._refine_structure`` against
    both: bit-equal (positions, chi2, n_obs, the accept bits);
  * the port's ``_local_ba_update`` with the window full against lvt_tpu's
    on the same numpy inputs: the window bit-equal; points within 1e-2 m
    (tests/test_torch_bundle.py's bound: the port sums in float64 and
    rounds once, lvt_tpu in float32 in XLA's order, and the Schur solve
    amplifies that rounding); the writeback decided alike for all but 1%
    of the refined points; untouched points bit-equal;
  * the op under ``torch.func.vmap`` over 2 streams against each stream
    alone, and the step with a one-rank gloo group (the launches of the
    sharded body's phases and their all-reduces) against the op:
    bit-equal;
  * the sharded body's phases (``refine_structure_phases``: the op
    ``lvt_tpu_torch::ba_phase``, each phase's torch ops on the CPU) with
    identity all-reduces against the plain body on every window here, cut
    to 3-8 observed points or to 5 points, and at 0 iterations: bit-equal;
    under vmap against each stream alone: bit-equal; ``opcheck`` of every
    phase;
  * right-camera observations with a baseline of 0: refused by the op and
    its plain version with one ValueError, as lvt_tpu's gate asserts;
  * the kernel's premise, that every sum over the points may be taken as
    float64 partials over C contiguous slices of the points added in rank
    order (csrc/ba.cu: one partial per block of a stream's cluster), for
    C = 1, 4, 8 and 16 on every window here: those rounded once equal
    ``_einsum64`` / ``_sum64`` over all the points bit for bit wherever
    the sum's terms cancel by less than 2^20 (a float64 sum then keeps
    more than 30 bits, and its order moves no float32); a few of h_cc's
    entries cancel by 2^26 or more and round to a neighbouring float32 in
    another order (so do they between the card's einsum and the CPU's),
    but the body's outputs with every such sum taken in slices are the
    plain version's, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lvt_tpu.config import VOConfig as JxVOConfig
from lvt_tpu.core import state as jx_state
from lvt_tpu.core import step as jx_step
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.solver import bundle as jx_bundle
from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import state, step
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import hamming
from lvt_tpu_torch.parallel import mesh as mesh_mod
from lvt_tpu_torch.solver import bundle
from lvt_tpu_torch.solver.pnp import _cauchy_weights
from test_bundle import BASELINE, CX, CY, FX, FY, make_ba_problem
from test_torch_system import share_the_cores  # noqa: F401

CAM = dict(fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE)
ITERS = 6


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _window(case: str, seed: int = 42, m: int = 200):
    """A stereo BA window from ``make_ba_problem`` (F = 4 poses, M points
    8-30 m deep) as numpy arrays (t, q, pos, obs, w, obs_r, w_r):
    ``noisy`` 0.5 px noise; ``outliers`` 20 points 120 px off in the left
    image; ``masked`` 50 points unobserved; ``exact`` none of it. A fifth
    of the right observations missing in all but ``exact``."""
    rng = np.random.RandomState(seed)
    noise = {"exact": 0.0, "outliers": 0.2}.get(case, 0.5)
    _, _, poses_n, pts_n, obs, obs_r, w = make_ba_problem(
        rng, m=m, pixel_noise=noise)
    obs, obs_r, w = (np.asarray(x).copy() for x in (obs, obs_r, w))
    w_r = w.copy()
    if case != "exact":
        w_r[rng.rand(*w.shape) < 0.2] = 0.0
    if case == "outliers":
        obs[:, :20] += 120.0
    if case == "masked":
        obs[:, :50] = 1e5
        w[:, :50] = 0.0
        w_r[:, :50] = 0.0
    return (np.asarray(poses_n.t), np.asarray(poses_n.q), np.asarray(pts_n),
            obs, w, obs_r, w_r)


def _plain(args):
    t, q, *rest = args
    return bundle.refine_structure_plain(Pose(t, q), *rest, iterations=ITERS,
                                         reprojection_th2=5.991, **CAM)


def _op(args):
    t, q, *rest = args
    return bundle.ba_refine(Pose(t, q), *rest, iterations=ITERS,
                            reprojection_th2=5.991, **CAM)


def jx_ba_observations(row_b, match_idx, right_kp, ratio, abs_th):
    """lvt_tpu's BA row match after its top-2 (``row_b``: d1, d2, best,
    n_cand of the map-matched features; ``ops/hamming.py``'s acceptance and
    one-to-one resolution, as its ``row_match`` runs them) and the right
    observations it gathers at each map slot (lvt_tpu/core/step.py:
    506-508): (obs_r_new, w_r_new)."""
    from lvt_tpu.ops import hamming as jx_hamming

    d1, d2, best, n_cand = (jnp.asarray(np.asarray(x)) for x in row_b)
    k = d1.shape[0]
    idx = jx_hamming.accept_matches(d1, d2, best, n_cand, ratio, abs_th)
    idx = jx_hamming.resolve_one_to_one(idx, d1, k)
    mi = jnp.asarray(np.asarray(match_idx))
    r_idx = idx[jnp.clip(mi, 0, k - 1)]
    obs_r = jnp.asarray(np.asarray(right_kp))[jnp.clip(r_idx, 0, k - 1)]
    return obs_r, ((mi >= 0) & (r_idx >= 0)).astype(jnp.float32)


def _config(cls):
    return cls(fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE, img_width=640,
               img_height=480, max_map_points=200, max_staged_points=64,
               local_ba_window=4, local_ba_every=4,
               local_ba_iterations=ITERS)


@pytest.mark.parametrize("case", ["exact", "noisy", "outliers", "masked"])
def test_op_on_the_cpu_is_the_plain_body(case):
    args = [_t(x) for x in _window(case)]
    got = _op(args)
    want = _plain(args)
    assert [x.dtype for x in got] == [torch.float32, torch.float32,
                                      torch.int64, torch.bool]
    assert got[0].shape == (200, 3) and got[3].shape == (ITERS,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    t, q, *rest = args
    assert torch.equal(step._refine_structure(Pose(t, q), *rest,
                                              _config(VOConfig)), want[0])
    moved = (want[0] != args[2]).any(-1)
    assert int(moved.sum()) > (50 if case != "exact" else 0)
    if case == "masked":   # unobserved points keep their bits
        assert not moved[:50].any()


@pytest.mark.parametrize("case", ["noisy", "outliers"])
def test_ba_update_matches_lvt_tpu(case):
    """lvt_tpu's ``_local_ba_update`` (the ``run`` branch of its lax.cond)
    and the port's on the same window, which fills with this frame at
    frame 8 (BA's schedule: window 4, every 4); the port's takes the BA
    row match's top-2, lvt_tpu's the right observations its step gathers
    from the same top-2 (``jx_ba_observations``)."""
    t, q, pos, obs, w, obs_r, w_r = _window(case, seed=7)
    f, m = w.shape
    # the window before this frame: a stale frame, then frames 0 .. F - 2
    pad = lambda x: np.concatenate([np.zeros_like(x[:1]) + 3.0, x[:-1]])  # noqa: E731
    old = dict(poses_t=pad(t), poses_q=pad(q), obs=pad(obs), w=pad(w),
               obs_r=pad(obs_r), w_r=pad(w_r))
    desc = np.zeros((m, 8), np.uint32)
    counters = np.zeros(m, np.int32)
    valid = np.ones(m, bool)
    invalid = np.zeros(m, bool)
    # this frame: slot j matched to feature j where observed, and the BA
    # row match's top-2 that pairs feature j with right feature j (its
    # right observation) where the right camera observed it
    seen, seen_r = w[-1] > 0, w_r[-1] > 0
    match_idx = np.where(seen, np.arange(m), -1).astype(np.int64)
    big = np.float32(hamming.BIG)
    row_b = (np.where(seen_r, 0.0, big).astype(np.float32),
             np.full(m, big, np.float32), np.arange(m, dtype=np.int64),
             seen_r.astype(np.int64))
    fout = np.stack([np.stack([row_b[0], row_b[0]]),
                     np.stack([row_b[1], row_b[1]])])
    iout = np.stack([np.stack([row_b[2], row_b[2]]),
                     np.stack([row_b[3], row_b[3]])])
    cfg = _config(VOConfig)
    obs_r_new, w_r_new = jx_ba_observations(
        row_b, match_idx, obs_r[-1], cfg.triangulation_ratio_test_threshold,
        cfg.descriptor_matching_threshold)
    np.testing.assert_array_equal(np.asarray(w_r_new), w_r[-1])

    jx = jx_step._local_ba_update(
        jx_state.ObsWindow(**{k: jnp.asarray(v) for k, v in old.items()},
                           n=jnp.asarray(f - 1, jnp.int32)),
        jx_state.PointStore(jnp.asarray(pos), jnp.asarray(desc),
                            jnp.asarray(counters), jnp.asarray(counters),
                            jnp.asarray(valid)),
        JxPose(jnp.asarray(t[-1]), jnp.asarray(q[-1])),
        jnp.asarray(obs[-1]), jnp.asarray(w[-1]), obs_r_new, w_r_new,
        jnp.asarray(invalid), jnp.asarray(8, jnp.int32),
        _config(JxVOConfig))
    pt = step._local_ba_update(
        state.ObsWindow(**{k: _t(v) for k, v in old.items()},
                        n=torch.tensor(f - 1, dtype=torch.int32)),
        state.PointStore(_t(pos), _t(desc.view(np.int32)), _t(counters),
                         _t(counters), _t(valid)),
        Pose(_t(t[-1]), _t(q[-1])), _t(obs[-1]), _t(w[-1]),
        (_t(fout), _t(iout)), _t(match_idx), _t(obs_r[-1]), _t(valid),
        _t(valid), _t(invalid), None, torch.tensor(8, dtype=torch.int32),
        cfg)
    assert bool(pt[3])
    for name in ("poses_t", "poses_q", "obs", "w", "obs_r", "w_r"):
        np.testing.assert_array_equal(getattr(pt[0], name).numpy(),
                                      np.asarray(getattr(jx[0], name)), name)
    got, want = pt[2].numpy(), np.asarray(jx[2])
    moved_p = (got != pos).any(1)
    moved_j = (want != pos).any(1)
    assert moved_j.sum() > 50
    assert int((moved_p != moved_j).sum()) <= 0.01 * moved_j.sum()
    np.testing.assert_allclose(got, want, atol=1e-2)
    np.testing.assert_array_equal(got[~moved_p & ~moved_j],
                                  pos[~moved_p & ~moved_j])


def test_vmap_rule_two_streams_equal_each_alone():
    a, b = ([_t(x) for x in _window(c, seed=s)]
            for c, s in (("noisy", 1), ("outliers", 2)))
    stacked = [torch.stack(x) for x in zip(a, b)]
    got = torch.func.vmap(lambda t, q, *r: _op((t, q, *r)))(*stacked)
    for i, args in enumerate((a, b)):
        for g, w in zip(got, _op(args)):
            assert torch.equal(g[i], w)


def test_fake_tensors_and_the_op_registration():
    """``torch.library.opcheck`` on the op (its schema, the fake kernel's
    shapes and dtypes against the CPU kernel's, autograd registration)."""
    args = [_t(x)[None] for x in _window("noisy", m=48)]
    torch.library.opcheck(
        bundle.ba_refine_op,
        (*args, FX, FY, CX, CY, BASELINE, 5.991, ITERS),
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))


def test_group_body_of_one_rank_is_the_op(tmp_path, monkeypatch):
    """With a one-rank gloo group the step runs the sharded body's phases
    (``bundle.refine_structure_phases``: ``n_phases`` calls of the op
    ``ba_phase``) and their 3 + 2 per iteration all-reduces; on one rank
    that is the op's result bit for bit."""
    from lvt_tpu_torch.ops.collectives import all_reduce

    args = [_t(x) for x in _window("outliers", seed=3)]
    t, q, *rest = args
    calls, real = [], bundle.ba_phase_op
    monkeypatch.setattr(bundle, "ba_phase_op",
                        lambda *a: calls.append(a[0]) or real(*a))
    mesh_mod.init("gloo", 1, 0, f"file://{tmp_path / 'rdv'}")
    try:
        before = all_reduce.calls
        got = step._refine_structure(Pose(t, q), *rest, _config(VOConfig),
                                     group=dist.group.WORLD)
        n_coll = all_reduce.calls - before
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, _op(args)[0])
    assert calls == [bundle.K_GATE1, bundle.K_GATE2, bundle.K_SETUP,
                     *[bundle.K_SUMS, bundle.K_TRIAL] * ITERS,
                     bundle.K_FINAL]
    assert len(calls) == bundle.n_phases(ITERS)
    assert n_coll == 3 + 2 * ITERS


def test_a_window_without_a_baseline_is_refused_as_in_lvt_tpu():
    """Right-camera observations beside a baseline of 0 (what the step
    passes for an RGB-D config with local BA and no baseline: right weights
    all 0): the op refuses them with the plain version's ValueError, and
    lvt_tpu's gate asserts; the card's op raises the same error
    (tests/test_torch_cuda.py)."""
    t, q, pos, obs, w, obs_r, w_r = _window("noisy", m=48)
    w_r = np.zeros_like(w_r)
    args = [_t(x) for x in (pos, obs, w, obs_r, w_r)]
    kw = dict(CAM, baseline=0.0, iterations=ITERS, reprojection_th2=5.991)
    for fn in (bundle.ba_refine, bundle.refine_structure_plain):
        with pytest.raises(ValueError, match="nonzero baseline"):
            fn(Pose(_t(t), _t(q)), *args, **kw)
    with pytest.raises(AssertionError):
        jx_bundle.chi2_gate_weights(
            JxPose(jnp.asarray(t), jnp.asarray(q)), jnp.asarray(pos),
            jnp.asarray(obs), jnp.asarray(w), fx=FX, fy=FY, cx=CX, cy=CY,
            baseline=0.0, obs_right=jnp.asarray(obs_r),
            w_right=jnp.asarray(w_r))


def test_rgbd_local_ba_leaves_the_map_as_it_was():
    """An RGB-D config with local BA (a baseline, no right camera): the
    step passes right weights all 0, so the op refines no point, and every
    frame's pose and the final map are those of the same config without
    BA, bit for bit (the card: tests/test_torch_cuda.py)."""
    from lvt_tpu.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.core.system import SensorType, VOSystem
    from test_torch_multistream import WORLD, _config as ms_config, _u8

    seq = list(SyntheticWorld(**WORLD).rgbd_sequence(7, speed=0.3))
    gray = np.stack([_u8(g) for g, _, _ in seq])
    depth = np.stack([d.astype(np.float32) for _, d, _ in seq])
    runs = []
    for window in (4, 0):
        cfg = ms_config(triangulation_policy=2).replace(
            local_ba_window=window, local_ba_every=2)
        vo = VOSystem(cfg, SensorType.RGBD, device="cpu")
        poses, _ = vo.track_chunk(gray, depth)
        runs.append((poses, vo.state.map))
    (p_ba, map_ba), (p_off, map_off) = runs
    assert torch.equal(p_ba.t, p_off.t) and torch.equal(p_ba.q, p_off.q)
    assert torch.equal(map_ba.pos, map_off.pos)
    assert torch.equal(map_ba.valid, map_off.valid)
    assert int(map_ba.valid.sum()) > 100


def _jacobians(r_wc, p_l, p, inv_z):
    """refine_window's block_jacobians: (jc [F, M, 2, 6], jp [F, M, 2, 3])."""
    x, y = p[..., 0], p[..., 1]
    fxz, fyz = FX * inv_z, FY * inv_z
    zeros = torch.zeros_like(fxz)
    dpi = torch.stack([torch.stack([fxz, zeros, -fxz * x * inv_z], -1),
                       torch.stack([zeros, fyz, -fyz * y * inv_z], -1)], -2)
    dp_dxi = torch.cat([torch.eye(3).expand(*p_l.shape[:-1], 3, 3),
                        -bundle._skew(p_l)], dim=-1)
    return (bundle._einsum64("fmij,fmjk->fmik", dpi, dp_dxi),
            bundle._einsum64("fmij,fjk->fmik", dpi, r_wc))


def _sums_over_points(args):
    """BA's sums over the points of a window at its starting state, as the
    plain version takes them: the contractions ((equation, operands), the
    point axis named m) of h_cc, g_c, the Schur term and g_red's, and the
    [F, M] terms that chi2_gate_weights and the robust chi-square sum."""
    t, q, pos, obs, w, obs_r, w_r = args
    poses = Pose(t, q)
    w, w_r = bundle.chi2_gate_weights(poses, pos, obs, w, obs_right=obs_r,
                                      w_right=w_r, **CAM)
    r_wc, t_wc = bundle._poses_to_w2c(poses)
    p_l = bundle._camera_points(r_wc, t_wc, pos)
    delta2 = torch.tensor(5.991)
    contractions, terms = [], []
    h_cp = h_pp = g_p = 0.0
    for obs_b, w_b, x_off in bundle._blocks(obs, w, BASELINE, obs_r, w_r):
        r, p, inv_z = bundle._project(p_l, x_off, obs_b, FX, FY, CX, CY)
        e2 = bundle._sq(r)
        wr = w_b * _cauchy_weights(e2, delta2)
        jc, jp = _jacobians(r_wc, p_l, p, inv_z)
        jc_w = jc * wr[..., None, None]
        contractions += [("fmki,fmkj->fij", (jc_w, jc)),
                         ("fmki,fmk->fi", (jc_w, r))]
        h_cp = h_cp + bundle._einsum64("fmki,fmkj->fmij", jc_w, jp)
        h_pp = h_pp + bundle._einsum64("fmki,fmkj,fm->mij", jp, jp, wr)
        g_p = g_p + bundle._einsum64("fmki,fmk,fm->mi", jp, r, wr)
        terms += [w_b, w_b * e2, w_b * delta2 * torch.log1p(e2 / delta2)]
    a = bundle._einsum64("fmij,mjk->fmik", h_cp,
                         bundle._inv33(h_pp, torch.tensor(1e-4)))
    contractions += [("fmik,gmjk->fgij", (a, h_cp)), ("fmik,mk->fi", (a, g_p))]
    return contractions, terms


def _in_slices(equation, operands, c, wide=bundle._wide):
    """The contraction as float64 partials over c contiguous slices of the
    points (rank r: [r M / c, (r + 1) M / c)), added in rank order, not
    rounded."""
    subs = equation.split("->")[0].split(",")
    m = operands[0].shape[subs[0].index("m")]
    total = 0.0
    for r in range(c):
        lo, hi = r * m // c, (r + 1) * m // c
        total = total + wide(equation, *(
            x.narrow(sub.index("m"), lo, hi - lo)
            for x, sub in zip(operands, subs)))
    return total


CASES = ("exact", "noisy", "outliers", "masked")


@pytest.mark.parametrize("c", [1, 4, 8, 16])
def test_partials_over_point_slices_round_to_the_plain_sums(c):
    """The premise of local BA's kernel (a cluster of c blocks per stream,
    each summing its slice of the points in float64, the partials added in
    rank order and rounded once), sum by sum: on every window of this
    file, the gate's moments and the robust chi-square equal the plain
    version's ``_sum64``, and every entry of h_cc, g_c, the Schur term and
    g_red's equals its ``_einsum64`` where its terms cancel by less than
    2^20 (nearly all of them)."""
    held = total = 0
    for case in CASES:
        contractions, terms = _sums_over_points(
            [_t(x) for x in _window(case)])
        for equation, operands in contractions:
            want = bundle._einsum64(equation, *operands)
            got = _in_slices(equation, operands, c).float()
            assert bool(want.abs().amax() > 0), (case, equation)
            mag = bundle._wide(equation, *(x.abs() for x in operands))
            kept = mag < 2.0 ** 20 * bundle._wide(equation, *operands).abs()
            assert torch.equal(got[kept], want[kept]), (case, equation, c)
            held += int(kept.sum())
            total += want.numel()
        for x in terms:
            assert torch.equal(_in_slices("fm->", (x,), c).float(),
                               bundle._sum64(x)), (case, c)
    assert held >= 0.9 * total, (held, total)


@pytest.mark.parametrize("c", [1, 4, 8, 16])
def test_the_body_with_point_slice_partials_is_the_plain_body(c,
                                                              monkeypatch):
    """The plain body with every one of refine_window's sums over the
    points (h_cc, g_c, the Schur term, g_red's) taken as float64 partials
    over c slices of the points in rank order, as the kernel takes them:
    its outputs (positions, chi2, n_obs, the accept bits) are the plain
    version's bit for bit on every window of this file, the entries that
    cancel by 2^26 or more included."""
    wide = bundle._wide

    def in_slices(equation, *operands):
        subs, out = equation.split("->")
        if "m" in out or not all("m" in x for x in subs.split(",")):
            return wide(equation, *operands)
        return _in_slices(equation, operands, c, wide)

    for case in CASES:
        args = [_t(x) for x in _window(case)]
        want = _plain(args)
        with monkeypatch.context() as patch:
            patch.setattr(bundle, "_wide", in_slices)
            got = _plain(args)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, c)


# ---- the sharded body's phases: lvt_tpu_torch::ba_phase


def _phases(args, iterations=ITERS):
    t, q, *rest = args
    return bundle.refine_structure_phases(
        Pose(t, q), *rest, iterations=iterations, reprojection_th2=5.991,
        **CAM)


def _few_points(args, k):
    """The window with its observations cut to its first k observed
    points (chip_smoke.py's few_ba_points)."""
    w, w_r = args[4], args[6]
    seen = ((w > 0) | (w_r > 0)).any(0)
    keep = (seen & (torch.cumsum(seen.int(), -1) <= k)).float()[None]
    return [*args[:4], w * keep, args[5], w_r * keep]


def _first_points(args, m):
    """The window cut to its first m points."""
    t, q, pos, obs, w, obs_r, w_r = args
    return [t, q, pos[:m], obs[:, :m], w[:, :m], obs_r[:, :m], w_r[:, :m]]


PHASE_CASES = ([(case, "whole", ITERS) for case in CASES]
               + [("outliers", f"few{k}", ITERS) for k in (3, 5, 8)]
               + [("noisy", "first5", ITERS), ("noisy", "whole", 0),
                  ("masked", "few8", 0)])


@pytest.mark.parametrize("case,cut,iterations", PHASE_CASES)
def test_phases_with_identity_all_reduces_are_the_plain_body(case, cut,
                                                             iterations):
    """The phases, each launch's partial sums passed on as they are (the
    all-reduce of one rank), give the plain body's outputs bit for bit:
    positions, chi2, n_obs and the accept bits."""
    args = [_t(x) for x in _window(case)]
    if cut.startswith("few"):
        args = _few_points(args, int(cut[3:]))
    elif cut.startswith("first"):
        args = _first_points(args, int(cut[5:]))
    t, q, *rest = args
    want = bundle.refine_structure_plain(
        Pose(t, q), *rest, iterations=iterations, reprojection_th2=5.991,
        **CAM)
    got = _phases(args, iterations).outputs()
    assert [x.dtype for x in got] == [torch.float32, torch.float32,
                                      torch.int64, torch.bool]
    assert got[3].shape == (iterations,)
    for g, w in zip(got, want):
        assert torch.equal(g, w), case


def test_phases_under_vmap_equal_each_stream_alone():
    a, b = ([_t(x) for x in _window(c, seed=s)]
            for c, s in (("noisy", 1), ("outliers", 2)))
    stacked = [torch.stack(x) for x in zip(a, b)]
    got = torch.func.vmap(lambda *x: _phases(x).outputs())(*stacked)
    for i, args in enumerate((a, b)):
        for g, w in zip(got, _phases(args).outputs()):
            assert torch.equal(g[i], w)


def _phase_calls():
    """The op's arguments at each phase of one window's body (M = 48, 2
    iterations), by kind: the first call of each."""
    seen, real = {}, bundle.ba_phase_op

    def record(*a):
        seen.setdefault(a[0], a)
        return real(*a)

    bundle.ba_phase_op = record
    try:
        _phases([_t(x) for x in _window("noisy", m=48)], 2)
    finally:
        bundle.ba_phase_op = real
    return seen


@pytest.mark.parametrize("kind", range(6))
def test_phase_op_registration(kind):
    """``torch.library.opcheck`` on each phase of the op (its schema, the
    fake kernel's shapes and dtypes against the CPU kernel's, autograd
    registration), on the arguments the body gave it."""
    args = _phase_calls()[kind]
    torch.library.opcheck(
        bundle.ba_phase_op, args,
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))
    state, scratch, part, out = bundle.ba_phase_op(*args)
    f, m = args[7].shape[1:3]
    assert state.shape == (1, bundle.state_size(f, 2))
    assert part.shape == (1, bundle.part_size(kind, f))
    assert part.dtype == torch.float64
    keeps = kind in (bundle.K_SETUP, bundle.K_SUMS, bundle.K_TRIAL)
    assert scratch.shape == (1, m * bundle.scratch_per_point(f) * keeps)
    assert out.shape == (1, m if kind == bundle.K_FINAL else 0, 3)
