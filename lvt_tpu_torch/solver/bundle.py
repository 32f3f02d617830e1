"""Windowed bundle adjustment: joint refinement of the last F camera poses
and the M map points they observe, with the point block eliminated by the
Schur complement:

    S       = H_cc - H_cp H_pp^-1 H_cp^T          (reduced camera system)
    g_red   = g_c  - H_cp H_pp^-1 g_p
    dc      = solve(S, -g_red);   dp_m = -H_pp_m^-1 (g_p_m + H_cp[:,m]^T dc)

Port of lvt_tpu/solver/bundle.py. Stereo observations pin the scale gauge;
Cauchy-robust, LM-damped, the oldest pose fixed. ``lax.fori_loop`` becomes
a Python loop of predicated iterations: a rejected step keeps the state
and only adapts lambda. ``torch.linalg.solve_ex`` skips the error check
(no host sync); a singular system gives a non-finite step, which the
accept test rejects, as in JAX. The card and the CPU round alike:
divisors are device scalars, 3-vector products are written out
(``se3.matvec``), and every sum over points, every contraction and the
reduced solve run in float64 and round once to float32 (:func:`_einsum64`).
lvt_tpu sums in float32, so the port differs from it by float32 rounding,
which this ill-conditioned solve amplifies.

With a ``group`` (lvt_tpu's ``psum_axis``: the points are this rank's
block of a map sharded over the group's ranks), every sum over the points
is summed across the ranks before its one rounding: the float64 partials
of the gate's moments, of the robust chi-square, of ``h_cc`` and ``g_c``
and of the Schur terms go to the group together, one collective per use,
and are rounded to float32 after it (:func:`_round_sums`); the
observation count is a ``psum``. The per-point blocks (``h_pp``,
``h_cp``, the point updates) stay local, and the reduced camera solve
runs on every rank alike. On one rank the result is the unsharded bits.

Local BA's whole body (the gate, the refinement and the writeback test of
core/step.py) is the custom op ``lvt_tpu_torch::ba_refine`` over a leading
stream axis S, built as PnP's solve is (solver/pnp.py):

* CUDA: one launch of the hand-written kernel of ``csrc/ba.cu`` for all S
  streams, one thread-block cluster per stream running the whole body on
  chip, its blocks splitting the points and adding their sums over
  distributed shared memory in rank order (lvt_tpu runs it as XLA ops; it
  is not a TPU kernel);
* CPU: :func:`refine_structure_plain` stream by stream, the torch ops this
  module has always run; on the card it is a reference for the tests and
  chip_smoke.py, and the body of the sharded step (``group``), whose sums
  go to the group between its ops;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.device import scalar
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose, matvec
from lvt_tpu_torch.ops.collectives import psum_if
from lvt_tpu_torch.solver.pnp import _cauchy_weights, _retract


def _wide(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of float32 operands in float64, not rounded."""
    return torch.einsum(equation, *(x.double() for x in operands))


def _einsum64(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of float32 operands accumulated in float64 and
    rounded once to float32. A float32 sum over many terms depends on the
    order the device sums in; in float64 the order moves the result by
    ~1e-16 relative, so after the one rounding the card and the CPU agree
    except where the exact sum lies that close to a float32 rounding
    boundary. With float32 sums the Schur solve amplified that order noise
    until the port's refined points left lvt_tpu's by up to 1.2e-2 m."""
    return _wide(equation, *operands).float()


def _sum64(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.sum(dim)`` accumulated in float64, rounded once to float32 (see
    :func:`_einsum64`)."""
    x = x.double()
    return (x.sum() if dim is None else x.sum(dim)).float()


def _solve64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve(a, b)`` in float64 with no error check (no host sync): an LU
    with partial pivoting, then two triangular solves. The LU factors a
    batch of two systems, ``a`` and the identity beside it: on the card a
    batch takes cuBLAS's batched LU, as the S streams of the vmapped
    multi-stream step do; and the triangular solves are cuBLAS's too.
    cuSOLVER, which takes one system alone (``solve_ex``), captures
    stream-ordered allocations of its own into a CUDA graph, and an IF
    node's body (core/graphs.py::cond) may not hold those. On the CPU all
    of it is LAPACK's, system by system."""
    a64 = a.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    lu, pivots, _ = torch.linalg.lu_factor_ex(torch.stack([a64, eye]))
    p, low, up = torch.lu_unpack(lu[0], pivots[0])
    y = torch.linalg.solve_triangular(low, p.mT @ b.double()[:, None],
                                      upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(up, y, upper=True)[:, 0]


def _round_sums(parts: list, group) -> list:
    """Float64 partial sums rounded once to float32, each first summed over
    ``group`` (one collective for all of them) when there is one."""
    if group is None:
        return [p.float() for p in parts]
    flat = psum_if(torch.cat([p.reshape(-1) for p in parts]), group)
    return [x.reshape(p.shape).float()
            for x, p in zip(flat.split([p.numel() for p in parts]), parts)]


class BAResult(NamedTuple):
    poses: Pose            # [F] refined camera-in-world poses
    points: torch.Tensor   # [M, 3] refined world points
    chi2: torch.Tensor     # robust total error after refinement
    n_obs: torch.Tensor    # observations used
    accepted: torch.Tensor  # [iterations] bool: the steps taken


def _poses_to_w2c(poses: Pose):
    r_wc = quat.to_matrix(poses.q).transpose(-1, -2)     # [F, 3, 3]
    return r_wc, -matvec(r_wc, poses.t)


def _w2c_to_poses(r_wc, t_wc) -> Pose:
    r_cw = r_wc.transpose(-1, -2)
    return Pose(-matvec(r_cw, t_wc), quat.from_matrix(r_cw))


def _inv33(m, damp):
    """Batched inverse of (m + damp*I) via the adjugate."""
    m = m + damp * torch.eye(3, dtype=m.dtype, device=m.device)
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = scalar(1.0, det) / torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _skew(p):
    """[..., 3, 3] cross-product matrix."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], -1),
        torch.stack([z, zeros, -x], -1),
        torch.stack([-y, x, zeros], -1),
    ], -2)


def _camera_points(r_wc, t_wc, points):
    """[F, M, 3] left-camera coordinates of every point in every pose."""
    return matvec(r_wc[:, None], points[None]) + t_wc[:, None, :]


def _project(p_l, x_off: float, obs_b, fx, fy, cx, cy):
    """Residuals [F, M, 2] of one observation block whose camera sits at
    x_off in the left frame, with the camera point and 1/z they came from."""
    p = p_l if x_off == 0.0 else torch.stack(
        [p_l[..., 0] + x_off, p_l[..., 1], p_l[..., 2]], -1)
    z = p[..., 2]
    inv_z = scalar(1.0, z) / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * p[..., 0] * inv_z + cx
    v = fy * p[..., 1] * inv_z + cy
    return torch.stack([u, v], -1) - obs_b, p, inv_z


def _sq(r):
    """Squared norm of [..., 2] residuals."""
    return r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]


def _check_stereo(w_right, baseline) -> None:
    """Right-camera observations need their weights and a stereo baseline
    (lvt_tpu asserts the same)."""
    if w_right is None or not baseline:
        raise ValueError("right-camera observations need w_right and a "
                         "nonzero baseline")


def _blocks(obs, w, baseline, obs_right, w_right):
    """Observation blocks: (pixels, weights, camera x-offset)."""
    blocks = [(obs, w.float(), 0.0)]
    if obs_right is not None:
        _check_stereo(w_right, baseline)
        blocks.append((obs_right, w_right.float(), -float(baseline)))
    return blocks


# the chi-square gate's floor (chi2_gate_weights' default, which the step
# and local BA's kernel use)
GATE_TH2 = 0.5


def chi2_gate_weights(
    poses: Pose,           # [F] camera-in-world (left camera)
    points: torch.Tensor,  # [M, 3]
    obs: torch.Tensor,     # [F, M, 2]
    w: torch.Tensor,       # [F, M]
    *, fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: torch.Tensor | None = None,
    w_right: torch.Tensor | None = None,
    gate_th2: float = GATE_TH2,
    group=None,
):
    """Per-observation chi-square gate at the current state, before BA:
    gate = max(gate_th2, 3 * trimmed mean of e2), the trimmed mean over
    observations with e2 <= 4 * plain mean. Cuts mismatched associations
    while noise passes. With ``group`` the moments are sums over the whole
    sharded map. Returns gated (w, w_right)."""
    r_wc, t_wc = _poses_to_w2c(poses)
    p_l = _camera_points(r_wc, t_wc, points)
    blocks = _blocks(obs, w, baseline, obs_right, w_right)
    e2_all = [_sq(_project(p_l, x_off, obs_b, fx, fy, cx, cy)[0])
              for obs_b, _, x_off in blocks]
    w_all = [w_b for _, w_b, _ in blocks]

    def mean_e2(weights):
        sums = _round_sums([x.double().sum() for x in (
            *weights, *(wb * e2 for wb, e2 in zip(weights, e2_all)))], group)
        nb = len(weights)
        n = torch.clamp(sum(sums[:nb]), min=1.0)
        return sum(sums[nb:]) / n

    m1 = mean_e2(w_all)
    trim = [wb * (e2 <= 4.0 * m1) for wb, e2 in zip(w_all, e2_all)]
    gate = torch.clamp(3.0 * mean_e2(trim), min=gate_th2)

    gated = [wb * (e2 <= gate) for wb, e2 in zip(w_all, e2_all)]
    return gated[0], (gated[1] if obs_right is not None else None)


def weighted_point_e2(
    poses: Pose, points: torch.Tensor, obs: torch.Tensor, w: torch.Tensor,
    *, fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: torch.Tensor | None = None,
    w_right: torch.Tensor | None = None,
) -> torch.Tensor:
    """[M] per-point weighted sum of squared reprojection errors over the
    window, both stereo blocks: the accept test of the BA writeback."""
    r_wc, t_wc = _poses_to_w2c(poses)
    p_l = _camera_points(r_wc, t_wc, points)
    total = 0.0
    for obs_b, w_b, x_off in _blocks(obs, w, baseline, obs_right, w_right):
        r = _project(p_l, x_off, obs_b, fx, fy, cx, cy)[0]
        total = total + _sum64(w_b * _sq(r), 0)
    return total


class _BAState(NamedTuple):
    r_wc: torch.Tensor    # [F, 3, 3]
    t_wc: torch.Tensor    # [F, 3]
    points: torch.Tensor  # [M, 3]
    lam: torch.Tensor
    nu: torch.Tensor
    chi2: torch.Tensor


def refine_window(
    poses: Pose,           # [F] camera-in-world (left camera)
    points: torch.Tensor,  # [M, 3]
    obs: torch.Tensor,     # [F, M, 2] left-camera pixel observations
    w: torch.Tensor,       # [F, M] observation validity (0/1)
    *, fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: torch.Tensor | None = None,   # [F, M, 2] right-camera pixels
    w_right: torch.Tensor | None = None,     # [F, M]
    iterations: int = 8,
    reprojection_th2: float = 5.991,
    n_fixed_poses: int = 1,
    group=None,
) -> BAResult:
    """LM-damped Schur-complement BA over an F-pose window; with ``group``
    over a map sharded across the group's ranks (module docstring)."""
    f_dim = obs.shape[0]
    dev, dtype = points.device, points.dtype
    delta2 = scalar(reprojection_th2, points)   # divisors: see device.scalar
    three = scalar(3.0, points)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    same_pose = torch.eye(f_dim, dtype=torch.bool, device=dev)[:, :, None, None]
    fix = torch.arange(6 * f_dim, device=dev) < 6 * n_fixed_poses
    fix_rc = fix[:, None] | fix[None, :]
    eye_flat = torch.eye(6 * f_dim, dtype=dtype, device=dev)
    blocks = _blocks(obs, w, baseline, obs_right, w_right)

    def robust_chi2(r_wc, t_wc, pts):
        p_l = _camera_points(r_wc, t_wc, pts)
        parts = []
        for obs_b, w_b, x_off in blocks:
            e2 = _sq(_project(p_l, x_off, obs_b, fx, fy, cx, cy)[0])
            parts.append((w_b * delta2 * torch.log1p(e2 / delta2))
                         .double().sum())
        total = 0.0
        for part in _round_sums(parts, group):
            total = total + part
        return total

    def block_jacobians(r_wc, p_l, p, inv_z):
        """(jc [F,M,2,6], jp [F,M,2,3]) for one observation block."""
        x, y = p[..., 0], p[..., 1]
        fxz = fx * inv_z
        fyz = fy * inv_z
        zeros = torch.zeros_like(fxz)
        dpi = torch.stack([                 # d(pixel)/d(camera point)
            torch.stack([fxz, zeros, -fxz * x * inv_z], -1),
            torch.stack([zeros, fyz, -fyz * y * inv_z], -1),
        ], -2)
        # dp/dxi = [I | -[p_l]x] (the pose perturbation acts on the left frame)
        dp_dxi = torch.cat([eye3.expand(*p_l.shape[:-1], 3, 3), -_skew(p_l)],
                           dim=-1)
        jc = _einsum64("fmij,fmjk->fmik", dpi, dp_dxi)
        jp = _einsum64("fmij,fjk->fmik", dpi, r_wc)
        return jc, jp

    def iteration(s: _BAState) -> tuple[_BAState, torch.Tensor]:
        h_cp = h_pp = g_p = 0.0
        cam_parts = []     # per block: h_cc's and g_c's float64 partials
        p_l = _camera_points(s.r_wc, s.t_wc, s.points)
        for obs_b, w_b, x_off in blocks:
            r, p, inv_z = _project(p_l, x_off, obs_b, fx, fy, cx, cy)
            wr = w_b * _cauchy_weights(_sq(r), delta2)
            jc, jp = block_jacobians(s.r_wc, p_l, p, inv_z)
            jc_w = jc * wr[..., None, None]
            cam_parts += [_wide("fmki,fmkj->fij", jc_w, jc),
                          _wide("fmki,fmk->fi", jc_w, r)]
            h_cp = h_cp + _einsum64("fmki,fmkj->fmij", jc_w, jp)
            h_pp = h_pp + _einsum64("fmki,fmkj,fm->mij", jp, jp, wr)
            g_p = g_p + _einsum64("fmki,fmk,fm->mi", jp, r, wr)

        hpp_inv = _inv33(h_pp, s.lam)                              # [M, 3, 3]
        # Schur complement onto the camera block
        hcp_hppinv = _einsum64("fmij,mjk->fmik", h_cp, hpp_inv)
        *cam, sc_part, g_part = _round_sums(
            cam_parts + [_wide("fmik,gmjk->fgij", hcp_hppinv, h_cp),
                         _wide("fmik,mk->fi", hcp_hppinv, g_p)], group)
        h_cc = g_c = 0.0
        for hcc_b, gc_b in zip(cam[0::2], cam[1::2]):
            h_cc = h_cc + hcc_b
            g_c = g_c + gc_b
        sc = -sc_part
        diag = h_cc + s.lam * eye6
        sc = torch.where(same_pose, sc + diag[:, None], sc)
        g_red = g_c - g_part

        # gauge fix: the n_fixed_poses oldest poses held (identity rows and
        # columns, zero right-hand side)
        s_flat = sc.permute(0, 2, 1, 3).reshape(6 * f_dim, 6 * f_dim)
        s_flat = torch.where(fix_rc, eye_flat, s_flat)
        g_flat = torch.where(fix, 0.0, g_red.reshape(6 * f_dim))
        dc = _solve64(s_flat, -g_flat)
        dc = dc.float().reshape(f_dim, 6)
        dp = -_einsum64("mij,mj->mi", hpp_inv,
                        g_p + _einsum64("fmij,fi->mj", h_cp, dc))

        r_new, t_new = _retract(s.r_wc, s.t_wc, dc)
        pts_new = s.points + dp
        chi2_new = robust_chi2(r_new, t_new, pts_new)
        ok = ((chi2_new < s.chi2) & torch.isfinite(dc).all()
              & torch.isfinite(dp).all())
        return _BAState(
            r_wc=torch.where(ok, r_new, s.r_wc),
            t_wc=torch.where(ok, t_new, s.t_wc),
            points=torch.where(ok, pts_new, s.points),
            lam=torch.where(ok, s.lam / three, s.lam * s.nu),
            nu=torch.where(ok, 2.0, s.nu * 2.0),
            chi2=torch.where(ok, chi2_new, s.chi2),
        ), ok

    r_wc, t_wc = _poses_to_w2c(poses)
    state = _BAState(r_wc, t_wc, points,
                     lam=torch.full((), 1e-4, dtype=dtype, device=dev),
                     nu=torch.full((), 2.0, dtype=dtype, device=dev),
                     chi2=robust_chi2(r_wc, t_wc, points))
    accepted = []
    for _ in range(iterations):
        state, ok = iteration(state)
        accepted.append(ok)
    return BAResult(
        poses=_w2c_to_poses(state.r_wc, state.t_wc),
        points=state.points,
        chi2=state.chi2,
        n_obs=psum_if(sum((w_b > 0).sum() for _, w_b, _ in blocks), group),
        accepted=(torch.stack(accepted) if accepted else
                  torch.zeros(0, dtype=torch.bool, device=dev)),
    )


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def refine_structure_plain(poses: Pose, pos, obs, w, obs_r, w_r, *, fx, fy,
                           cx, cy, baseline, iterations, reprojection_th2,
                           group=None):
    """Local BA's body as torch ops: chi-square gate, refine, then keep a
    refined point only inside a relative trust region (10% of its distance
    to the newest camera + 0.5 m) and only if it fits the gated
    observations better under the original window poses. Returns
    (positions [M, 3], the refinement's chi2, its n_obs and its accept
    bits [iterations]). The CPU kernel of ``lvt_tpu_torch::ba_refine``, and
    with a ``group`` the sharded step's body."""
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy)
    stereo = dict(baseline=baseline, obs_right=obs_r)
    w, w_r = chi2_gate_weights(poses, pos, obs, w, w_right=w_r, group=group,
                               **stereo, **cam)
    # only points with >= 2 left observations and >= 1 stereo pair
    n_l = (w > 0).sum(0)
    n_s = ((w > 0) & (w_r > 0)).sum(0)
    use = ((n_l >= 2) & (n_s >= 1)).float()
    w, w_r = w * use[None], w_r * use[None]
    res = refine_window(
        poses, pos, obs, w, w_right=w_r, **stereo, **cam,
        iterations=iterations, reprojection_th2=reprojection_th2,
        n_fixed_poses=1, group=group)
    dist = _norm3(pos - poses.t[-1][None])
    ok = (use > 0) & (_norm3(res.points - pos) <= 0.1 * dist + 0.5)
    e2_old = weighted_point_e2(poses, pos, obs, w, w_right=w_r, **stereo,
                               **cam)
    e2_new = weighted_point_e2(poses, res.points, obs, w, w_right=w_r,
                               **stereo, **cam)
    ok = ok & (e2_new <= e2_old)
    return (torch.where(ok[:, None], res.points, pos), res.chi2, res.n_obs,
            res.accepted)


# ---- the fused body: lvt_tpu_torch::ba_refine


@torch.library.custom_op("lvt_tpu_torch::ba_refine", mutates_args=(),
                         device_types="cuda")
def ba_refine_op(t: torch.Tensor, q: torch.Tensor, pos: torch.Tensor,
                 obs: torch.Tensor, w: torch.Tensor, obs_r: torch.Tensor,
                 w_r: torch.Tensor, fx: float, fy: float, cx: float,
                 cy: float, baseline: float, th2: float, iterations: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """S streams' local BA bodies: window poses t [S, F, 3], q [S, F, 4],
    map positions pos [S, M, 3], observations obs, obs_r [S, F, M, 2] and
    weights w, w_r [S, F, M] float32, the camera, the stereo baseline,
    reprojection_th2 and the LM iterations -> positions [S, M, 3], chi2
    [S] float32, n_obs [S] int64, accept bits [S, iterations] bool.

    CUDA: one launch of ``csrc/ba.cu``'s kernel for all streams (one
    cluster of blocks per stream; every order fixed by F, M and the cluster
    size, whatever S). A window of more than the kernel's static limit of
    poses raises, and so does a launch the card refuses."""
    s, f, m = obs.shape[:3]
    dev = pos.device
    for x, name, shape in ((t, "t", (s, f, 3)), (q, "q", (s, f, 4)),
                           (pos, "pos", (s, m, 3)),
                           (obs, "obs", (s, f, m, 2)), (w, "w", (s, f, m)),
                           (obs_r, "obs_r", (s, f, m, 2)),
                           (w_r, "w_r", (s, f, m))):
        kernels.require(x, name, torch.float32, shape, dev)
    lib = kernels.lib()
    if not 1 <= f <= lib.lvt_ba_max_window():
        raise ValueError(f"ba_refine: a window of {f} poses; the kernel "
                         f"takes 1 to {lib.lvt_ba_max_window()}")
    # the plain version's refusal (its _blocks), on the card as on the CPU
    _check_stereo(w_r, baseline)
    if iterations < 0:
        raise ValueError(f"ba_refine: {iterations} iterations")
    f32 = dict(dtype=torch.float32, device=dev)
    # outputs and scratch allocated before the launch: inside a CUDA graph's
    # capture they come from the graph's pool, and the launch itself
    # allocates nothing (an IF node's body may hold no allocation)
    scratch = torch.empty((s, m * lib.lvt_ba_scratch_per_point(f)), **f32)
    out = torch.empty((s, m, 3), **f32)
    chi2 = torch.empty((s,), **f32)
    n_obs = torch.empty((s,), dtype=torch.int64, device=dev)
    accepted = torch.empty((s, iterations), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.lvt_ba_refine(
            t.data_ptr(), q.data_ptr(), pos.data_ptr(), obs.data_ptr(),
            w.data_ptr(), obs_r.data_ptr(), w_r.data_ptr(), s, f, m,
            iterations, fx, fy, cx, cy, th2, -baseline, GATE_TH2,
            scratch.data_ptr(), out.data_ptr(), chi2.data_ptr(),
            n_obs.data_ptr(), accepted.data_ptr(), kernels.stream_ptr(pos))
    kernels.check(err, "ba_refine")
    ba_refine.launches += 1
    return out, chi2, n_obs, accepted


@ba_refine_op.register_kernel("cpu")
def _ba_refine_cpu(t, q, pos, obs, w, obs_r, w_r, fx, fy, cx, cy, baseline,
                   th2, iterations):
    outs = [refine_structure_plain(
        Pose(*a[:2]), *a[2:], fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline,
        iterations=iterations, reprojection_th2=th2)
        for a in zip(t, q, pos, obs, w, obs_r, w_r)]
    return tuple(torch.stack(x) for x in zip(*outs))


@ba_refine_op.register_fake
def _ba_refine_fake(t, q, pos, obs, w, obs_r, w_r, fx, fy, cx, cy, baseline,
                    th2, iterations):
    s, m = pos.shape[:2]
    return (pos.new_empty((s, m, 3)), pos.new_empty((s,)),
            pos.new_empty((s,), dtype=torch.int64),
            pos.new_empty((s, iterations), dtype=torch.bool))


def _ba_refine_vmap(info, in_dims, t, q, pos, obs, w, obs_r, w_r, *rest):
    b = info.batch_size
    outs = ba_refine_op(*kernels.fold_streams(
        info, in_dims[:7], (t, q, pos, obs, w, obs_r, w_r)), *rest)
    return (tuple(x.view(b, x.shape[0] // b, *x.shape[1:]) for x in outs),
            (0,) * 4)


ba_refine_op.register_vmap(_ba_refine_vmap)


def ba_refine(poses: Pose, pos, obs, w, obs_r, w_r, *, fx, fy, cx, cy,
              baseline, iterations, reprojection_th2):
    """One window's local BA body (``ba_refine_op`` at S = 1): (positions
    [M, 3], chi2, n_obs, accept bits). CPU tensors take
    :func:`refine_structure_plain`, CUDA tensors one launch of the kernel
    (any other device raises), and under ``torch.func.vmap`` one launch
    serves every stream."""
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pos: expected a CUDA tensor, got {pos.device}")
    outs = ba_refine_op(
        *(x.float()[None].contiguous()
          for x in (poses.t, poses.q, pos, obs, w, obs_r, w_r)),
        float(fx), float(fy), float(cx), float(cy), float(baseline),
        float(reprojection_th2), int(iterations))
    return tuple(x[0] for x in outs)


ba_refine.launches = 0


def device_launches(device=None) -> int:
    """The kernel's launches on a CUDA ``device`` so far, as the card ran
    them: the kernel counts itself, so a CUDA graph's replays count too,
    inside an IF node's body as well (a kernel trace can lose that body's
    records). Synchronizes the device; for tests and chip_smoke.py."""
    import ctypes

    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        kernels.check(kernels.lib().lvt_ba_launches(ctypes.byref(n)),
                      "ba_refine (launch count)")
    return n.value
