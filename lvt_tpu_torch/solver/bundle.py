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
  chip_smoke.py;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis.

The sharded step's body (``group``) is the op ``lvt_tpu_torch::ba_phase``,
launched once per phase by :func:`refine_structure_phases`: the same
kernel's code split where the body sums over the points (the gate's two
moments, the weights with the first chi-square, per LM iteration its sums
and its trial step, the writeback), each phase's float64 partials
all-reduced over the group before the next phase rounds them. On the CPU
each phase is :func:`ba_phase_plain`, the plain version's torch ops split
the same way, so with identity all-reduces the phases give
:func:`refine_structure_plain`'s bits and on the card ``ba_refine``'s;
with a group, ``refine_structure_plain(group=)``'s. The plain group
version stays as the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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


def _gate_e2(r_wc, t_wc, points, blocks, fx, fy, cx, cy) -> list:
    """Each observation block's squared reprojection errors [F, M] at the
    poses (r_wc, t_wc): what the gate weighs."""
    p_l = _camera_points(r_wc, t_wc, points)
    return [_sq(_project(p_l, x_off, obs_b, fx, fy, cx, cy)[0])
            for obs_b, _, x_off in blocks]


def _gate_parts(weights, e2_all) -> list:
    """The gate's float64 moments over the points: each block's sum of
    weights, then each block's sum of weight x e2."""
    return [x.double().sum() for x in (
        *weights, *(wb * e2 for wb, e2 in zip(weights, e2_all)))]


def _mean_e2(sums) -> torch.Tensor:
    """(sum w e2) / clamp(sum w, min=1) from the rounded moments."""
    nb = len(sums) // 2
    n = torch.clamp(sum(sums[:nb]), min=1.0)
    return sum(sums[nb:]) / n


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
    blocks = _blocks(obs, w, baseline, obs_right, w_right)
    e2_all = _gate_e2(r_wc, t_wc, points, blocks, fx, fy, cx, cy)
    w_all = [w_b for _, w_b, _ in blocks]

    def mean_e2(weights):
        return _mean_e2(_round_sums(_gate_parts(weights, e2_all), group))

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


class _Window(NamedTuple):
    """One window's fixed inputs of the refinement: the observation blocks
    (pixels, weights, camera x-offset), the camera, and reprojection_th2
    as a device scalar (a divisor: see device.scalar)."""
    blocks: list
    fx: float
    fy: float
    cx: float
    cy: float
    delta2: torch.Tensor

    def chi2_parts(self, r_wc, t_wc, pts) -> list:
        """The robust chi-square's float64 partials, one per block."""
        p_l = _camera_points(r_wc, t_wc, pts)
        parts = []
        for obs_b, w_b, x_off in self.blocks:
            e2 = _sq(_project(p_l, x_off, obs_b, self.fx, self.fy, self.cx,
                              self.cy)[0])
            parts.append((w_b * self.delta2 * torch.log1p(e2 / self.delta2))
                         .double().sum())
        return parts

    def jacobians(self, r_wc, p_l, p, inv_z):
        """(jc [F,M,2,6], jp [F,M,2,3]) for one observation block."""
        x, y = p[..., 0], p[..., 1]
        fxz = self.fx * inv_z
        fyz = self.fy * inv_z
        zeros = torch.zeros_like(fxz)
        dpi = torch.stack([                 # d(pixel)/d(camera point)
            torch.stack([fxz, zeros, -fxz * x * inv_z], -1),
            torch.stack([zeros, fyz, -fyz * y * inv_z], -1),
        ], -2)
        # dp/dxi = [I | -[p_l]x] (the pose perturbation acts on the left frame)
        eye3 = torch.eye(3, dtype=p_l.dtype, device=p_l.device)
        dp_dxi = torch.cat([eye3.expand(*p_l.shape[:-1], 3, 3), -_skew(p_l)],
                           dim=-1)
        jc = _einsum64("fmij,fmjk->fmik", dpi, dp_dxi)
        jp = _einsum64("fmij,fjk->fmik", dpi, r_wc)
        return jc, jp

    def point_blocks(self, r_wc, t_wc, points, lam):
        """One iteration's per-point blocks at the state and its sums over
        the points, unrounded: (h_cp [F, M, 6, 3], h_pp^-1 [M, 3, 3], g_p
        [M, 3], h_cp h_pp^-1 [F, M, 6, 3], the sums: per block h_cc's and
        g_c's float64 partials, then the Schur term's and g_red's)."""
        h_cp = h_pp = g_p = 0.0
        sums = []     # per block: h_cc's and g_c's float64 partials
        p_l = _camera_points(r_wc, t_wc, points)
        for obs_b, w_b, x_off in self.blocks:
            r, p, inv_z = _project(p_l, x_off, obs_b, self.fx, self.fy,
                                   self.cx, self.cy)
            wr = w_b * _cauchy_weights(_sq(r), self.delta2)
            jc, jp = self.jacobians(r_wc, p_l, p, inv_z)
            jc_w = jc * wr[..., None, None]
            sums += [_wide("fmki,fmkj->fij", jc_w, jc),
                     _wide("fmki,fmk->fi", jc_w, r)]
            h_cp = h_cp + _einsum64("fmki,fmkj->fmij", jc_w, jp)
            h_pp = h_pp + _einsum64("fmki,fmkj,fm->mij", jp, jp, wr)
            g_p = g_p + _einsum64("fmki,fmk,fm->mi", jp, r, wr)

        hpp_inv = _inv33(h_pp, lam)                                # [M, 3, 3]
        # Schur complement onto the camera block
        hcp_hppinv = _einsum64("fmij,mjk->fmik", h_cp, hpp_inv)
        sums += [_wide("fmik,gmjk->fgij", hcp_hppinv, h_cp),
                 _wide("fmik,mk->fi", hcp_hppinv, g_p)]
        return h_cp, hpp_inv, g_p, hcp_hppinv, sums


def _camera_step(cam, sc_part, g_part, lam, n_fixed_poses: int):
    """The reduced camera system from the iteration's rounded sums (cam:
    per block h_cc [F, 6, 6] and g_c [F, 6]; the Schur term [F, F, 6, 6]
    and g_red's [F, 6]), the gauge fixed (the n_fixed_poses oldest poses
    held: identity rows and columns, zero right-hand side), solved: dc
    [F, 6]."""
    f_dim = g_part.shape[0]
    dev, dtype = g_part.device, g_part.dtype
    same_pose = torch.eye(f_dim, dtype=torch.bool, device=dev)[:, :, None, None]
    fix = torch.arange(6 * f_dim, device=dev) < 6 * n_fixed_poses
    fix_rc = fix[:, None] | fix[None, :]
    eye_flat = torch.eye(6 * f_dim, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    h_cc = g_c = 0.0
    for hcc_b, gc_b in zip(cam[0::2], cam[1::2]):
        h_cc = h_cc + hcc_b
        g_c = g_c + gc_b
    sc = -sc_part
    diag = h_cc + lam * eye6
    sc = torch.where(same_pose, sc + diag[:, None], sc)
    g_red = g_c - g_part
    s_flat = sc.permute(0, 2, 1, 3).reshape(6 * f_dim, 6 * f_dim)
    s_flat = torch.where(fix_rc, eye_flat, s_flat)
    g_flat = torch.where(fix, 0.0, g_red.reshape(6 * f_dim))
    dc = _solve64(s_flat, -g_flat)
    return dc.float().reshape(f_dim, 6)


def _point_step(hpp_inv, g_p, h_cp, dc):
    """dp = -h_pp^-1 (g_p + h_cp^T dc), [M, 3]."""
    return -_einsum64("mij,mj->mi", hpp_inv,
                      g_p + _einsum64("fmij,fi->mj", h_cp, dc))


def _chi2_total(parts):
    """The robust chi-square from its rounded block partials."""
    total = 0.0
    for part in parts:
        total = total + part
    return total


def _accept(s: _BAState, ok, r_new, t_new, pts_new, chi2_new) -> _BAState:
    """The LM accept test's outcome: a rejected step keeps the state and
    only adapts lambda."""
    three = scalar(3.0, s.lam)
    return _BAState(
        r_wc=torch.where(ok, r_new, s.r_wc),
        t_wc=torch.where(ok, t_new, s.t_wc),
        points=torch.where(ok, pts_new, s.points),
        lam=torch.where(ok, s.lam / three, s.lam * s.nu),
        nu=torch.where(ok, 2.0, s.nu * 2.0),
        chi2=torch.where(ok, chi2_new, s.chi2),
    )


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
    dev, dtype = points.device, points.dtype
    win = _Window(_blocks(obs, w, baseline, obs_right, w_right), fx, fy, cx,
                  cy, scalar(reprojection_th2, points))

    def robust_chi2(r_wc, t_wc, pts):
        return _chi2_total(_round_sums(win.chi2_parts(r_wc, t_wc, pts),
                                       group))

    def iteration(s: _BAState) -> tuple[_BAState, torch.Tensor]:
        h_cp, hpp_inv, g_p, _, sums = win.point_blocks(s.r_wc, s.t_wc,
                                                       s.points, s.lam)
        *cam, sc_part, g_part = _round_sums(sums, group)
        dc = _camera_step(cam, sc_part, g_part, s.lam, n_fixed_poses)
        dp = _point_step(hpp_inv, g_p, h_cp, dc)
        r_new, t_new = _retract(s.r_wc, s.t_wc, dc)
        pts_new = s.points + dp
        chi2_new = robust_chi2(r_new, t_new, pts_new)
        ok = ((chi2_new < s.chi2) & torch.isfinite(dc).all()
              & torch.isfinite(dp).all())
        return _accept(s, ok, r_new, t_new, pts_new, chi2_new), ok

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
        n_obs=psum_if(sum((w_b > 0).sum() for _, w_b, _ in win.blocks),
                      group),
        accepted=(torch.stack(accepted) if accepted else
                  torch.zeros(0, dtype=torch.bool, device=dev)),
    )


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _take_part(w, w_r):
    """The points that take part (>= 2 left observations and >= 1 stereo
    pair) as a 0/1 mask [M], and the weights cut to them."""
    n_l = (w > 0).sum(0)
    n_s = ((w > 0) & (w_r > 0)).sum(0)
    use = ((n_l >= 2) & (n_s >= 1)).float()
    return use, w * use[None], w_r * use[None]


def _keep_refined(poses: Pose, pos, refined, use, e2_old, obs, w, obs_r,
                  w_r, *, fx, fy, cx, cy, baseline):
    """The writeback: a refined point is kept where it takes part, stays
    within 10% of its distance to the newest camera + 0.5 m, and fits the
    gated observations at the original poses no worse than before."""
    dist = _norm3(pos - poses.t[-1][None])
    ok = (use > 0) & (_norm3(refined - pos) <= 0.1 * dist + 0.5)
    e2_new = weighted_point_e2(poses, refined, obs, w, w_right=w_r, fx=fx,
                               fy=fy, cx=cx, cy=cy, baseline=baseline,
                               obs_right=obs_r)
    ok = ok & (e2_new <= e2_old)
    return torch.where(ok[:, None], refined, pos)


def refine_structure_plain(poses: Pose, pos, obs, w, obs_r, w_r, *, fx, fy,
                           cx, cy, baseline, iterations, reprojection_th2,
                           group=None):
    """Local BA's body as torch ops: chi-square gate, refine, then keep a
    refined point only inside a relative trust region (10% of its distance
    to the newest camera + 0.5 m) and only if it fits the gated
    observations better under the original window poses. Returns
    (positions [M, 3], the refinement's chi2, its n_obs and its accept
    bits [iterations]). The CPU kernel of ``lvt_tpu_torch::ba_refine``; with
    a ``group`` the reference of the sharded step's body
    (:func:`refine_structure_phases`)."""
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy)
    stereo = dict(baseline=baseline, obs_right=obs_r)
    w, w_r = chi2_gate_weights(poses, pos, obs, w, w_right=w_r, group=group,
                               **stereo, **cam)
    use, w, w_r = _take_part(w, w_r)
    res = refine_window(
        poses, pos, obs, w, w_right=w_r, **stereo, **cam,
        iterations=iterations, reprojection_th2=reprojection_th2,
        n_fixed_poses=1, group=group)
    e2_old = weighted_point_e2(poses, pos, obs, w, w_right=w_r, **stereo,
                               **cam)
    return (_keep_refined(poses, pos, res.points, use, e2_old, obs, w, obs_r,
                          w_r, baseline=baseline, **cam),
            res.chi2, res.n_obs, res.accepted)


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


# ---- the sharded body's phases: lvt_tpu_torch::ba_phase

# the phases of csrc/ba.cu's ba_phase_kernel, in launch order: the gate's
# two moments, the gated weights with the first chi-square, per LM
# iteration its sums and its trial step, then the last accept test and the
# writeback. Each ends where the body sums over the points; its partial
# sums go to the all-reduce before the next phase, which rounds them.
K_GATE1, K_GATE2, K_SETUP, K_SUMS, K_TRIAL, K_FINAL = range(6)
NB = 2           # observation blocks: left, right camera
CP = 18          # a point's 6 x 3 block of h_cp per pose
SCALARS = ("lam", "nu", "chi2", "gate", "cur", "bad", "n_obs")


def iter_sums(f: int) -> int:
    """The float64 sums of one LM iteration, the free poses' only: per pair
    of free poses S's 6x6 Schur block, per block and free pose h_cc's 6x6
    and g_c's 6, per free pose g_red's 6 (csrc/ba.cu's ITER_SUMS)."""
    nf = f - 1
    return 36 * nf * nf + NB * 42 * nf + 6 * nf


def part_size(kind: int, f: int) -> int:
    """The float64 partial sums phase ``kind`` writes: the gate's moments
    (4: each block's sum of weights, then of weight x e2), the first
    chi-square's two blocks and the observation count, an iteration's sums,
    the trial chi-square's two blocks."""
    return {K_GATE1: 4, K_GATE2: 4, K_SETUP: 3, K_SUMS: iter_sums(f),
            K_TRIAL: 2, K_FINAL: 0}[kind]


def _tot_size(kind: int, it: int, f: int) -> int:
    """The all-reduced sums phase ``kind`` reads: the previous phase's."""
    if kind in (K_SUMS, K_FINAL):
        return part_size(K_SETUP if it == 0 else K_TRIAL, f)
    return {K_GATE1: 0, K_GATE2: 4, K_SETUP: 4, K_TRIAL: iter_sums(f)}[kind]


def state_size(f: int, iterations: int) -> int:
    """Floats of a stream's state row between the phases: the poses world
    to camera (original, current, trial; 12 each), the newest pose's
    position, SCALARS, and the accept bits."""
    return 36 * f + 3 + len(SCALARS) + iterations


def scratch_per_point(f: int) -> int:
    """Floats per point of a stream's scratch row (csrc/ba.cu's Scratch):
    the current and trial positions, the gated weights, the old fit, the
    mask, h_cp, h_cp h_pp^-1, g_p and h_pp^-1, each an array over the
    points."""
    return 3 + 3 + NB * f + 1 + 1 + 2 * f * CP + 3 + 9


def n_phases(iterations: int) -> int:
    """Launches of one phased BA."""
    return 4 + 2 * iterations


_POSE_FIELDS = (("r0", 9), ("t0", 3), ("r", 9), ("t", 3), ("rt", 9),
                ("tt", 3))


def _offset(f: int, name: str) -> int:
    """The offset of field ``name`` in the state row."""
    scalars = 36 * f + 3
    if name in SCALARS:
        return scalars + SCALARS.index(name)
    return {"tn": 36 * f, "acc": scalars + len(SCALARS)}[name]


def _unpack_state(st, f: int) -> dict:
    out, o = {}, 0
    for name, k in _POSE_FIELDS:
        x = st[o:o + k * f].reshape(f, k)
        out[name] = x.reshape(f, 3, 3) if k == 9 else x
        o += k * f
    out["tn"] = st[o:o + 3]
    for name in SCALARS:
        out[name] = st[_offset(f, name)]
    out["acc"] = st[_offset(f, "acc"):]
    return out


def _pack_state(st: dict) -> torch.Tensor:
    return torch.cat([st[name].reshape(-1) for name, _ in _POSE_FIELDS]
                     + [st["tn"]] + [st[k].reshape(1) for k in SCALARS]
                     + [st["acc"]])


_SCRATCH = (("pts", lambda f: 6), ("wg", lambda f: NB * f),
            ("e2_old", lambda f: 1), ("use", lambda f: 1),
            ("hcp", lambda f: f * CP), ("a", lambda f: f * CP),
            ("gp", lambda f: 3), ("hinv", lambda f: 9))


def _unpack_scratch(scratch, f: int, m: int) -> dict:
    out, o = {}, 0
    for name, rows in _SCRATCH:
        out[name] = scratch[o:o + rows(f) * m].reshape(rows(f), m)
        o += rows(f) * m
    return out


def _pack_scratch(sc: dict) -> torch.Tensor:
    return torch.cat([sc[name].reshape(-1) for name, _ in _SCRATCH])


def _pack_iter(sums) -> torch.Tensor:
    """An iteration's float64 sums (``_Window.point_blocks``) as the
    kernel lays them out: the free poses' Schur blocks (f, g), then per
    block and free pose h_cc's 36 and g_c's 6, then g_red's terms."""
    *cam, schur, gred = sums
    cams = torch.stack([torch.cat([h[1:].reshape(-1, 36), g[1:]], -1)
                        for h, g in zip(cam[0::2], cam[1::2])])
    return torch.cat([schur[1:, 1:].reshape(-1), cams.reshape(-1),
                      gred[1:].reshape(-1)])


def _unpack_iter(tot, f: int):
    """``_pack_iter``'s layout rounded, as ``_camera_step`` takes it: (per
    block h_cc [F, 6, 6] and g_c [F, 6], the Schur term [F, F, 6, 6],
    g_red's [F, 6]); the fixed pose's entries, which the gauge fix
    replaces, zero."""
    nf = f - 1
    pad = torch.nn.functional.pad
    n_s = 36 * nf * nf
    schur = pad(tot[:n_s].reshape(nf, nf, 6, 6), (0, 0, 0, 0, 1, 0, 1, 0))
    cams = tot[n_s:n_s + NB * 42 * nf].reshape(NB, nf, 42)
    cam = []
    for b in range(NB):
        cam += [pad(cams[b, :, :36].reshape(nf, 6, 6), (0, 0, 0, 0, 1, 0)),
                pad(cams[b, :, 36:], (0, 0, 1, 0))]
    gred = pad(tot[n_s + NB * 42 * nf:].reshape(nf, 6), (0, 0, 1, 0))
    return cam, schur, gred


def ba_phase_plain(kind: int, it: int, state, scratch, t, q, pos, obs, w,
                   obs_r, w_r, tot, fx, fy, cx, cy, baseline, th2,
                   iterations):
    """One stream's phase of the sharded body (the CPU kernel of
    ``lvt_tpu_torch::ba_phase``): the state row [state_size] (None for
    K_GATE1), the scratch row [M * scratch_per_point] (None before the
    iterations), the window as ``refine_structure_plain`` takes it, and
    ``tot``, the previous phase's partial sums all-reduced (float64; None
    for K_GATE1) -> (state, scratch (empty where no later phase reads
    it), part [part_size] float64, positions [M, 3] for K_FINAL, else [0,
    3]). ``it`` is the LM iteration (K_FINAL: ``iterations``). The plain
    version's operations, split at each sum over the points: composed
    with identity all-reduces they give ``refine_structure_plain``'s bits.
    The accept test's non-finite check is this rank's (its dp), as in the
    plain group version."""
    f, m = obs.shape[:2]
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy)
    blocks = _blocks(obs, w, baseline, obs_r, w_r)
    poses = Pose(t, q)
    f64 = dict(dtype=torch.float64, device=pos.device)
    part = torch.zeros(0, **f64)
    scratch_out, out = pos.new_zeros(0), pos.new_zeros((0, 3))
    rounded = None if tot is None else list(tot.float())
    if kind == K_GATE1:
        r0, t0 = _poses_to_w2c(poses)
        zero = pos.new_zeros(())
        st = dict(r0=r0, t0=t0, r=r0, t=t0, rt=torch.zeros_like(r0),
                  tt=torch.zeros_like(t0), tn=t[-1],
                  lam=torch.full((), 1e-4, dtype=pos.dtype,
                                 device=pos.device),
                  nu=torch.full((), 2.0, dtype=pos.dtype, device=pos.device),
                  acc=pos.new_zeros(iterations),
                  **dict.fromkeys(("chi2", "gate", "cur", "bad", "n_obs"),
                                  zero))
    else:
        st = _unpack_state(state, f)
    if kind in (K_GATE1, K_GATE2, K_SETUP):
        e2_all = _gate_e2(st["r0"], st["t0"], pos, blocks, **cam)
        w_all = [w_b for _, w_b, _ in blocks]
        if kind == K_GATE1:
            part = torch.stack(_gate_parts(w_all, e2_all))
        elif kind == K_GATE2:
            m1 = _mean_e2(rounded)
            trim = [wb * (e2 <= 4.0 * m1) for wb, e2 in zip(w_all, e2_all)]
            part = torch.stack(_gate_parts(trim, e2_all))
        else:
            st["gate"] = torch.clamp(3.0 * _mean_e2(rounded), min=GATE_TH2)
            use, wg, wg_r = _take_part(
                *[wb * (e2 <= st["gate"]) for wb, e2 in zip(w_all, e2_all)])
            win = _Window(_blocks(obs, wg, baseline, obs_r, wg_r), fx, fy,
                          cx, cy, scalar(th2, pos))
            n_obs = sum((w_b > 0).sum() for _, w_b, _ in win.blocks)
            part = torch.stack([*win.chi2_parts(st["r0"], st["t0"], pos),
                                n_obs.double()])
            e2_old = weighted_point_e2(poses, pos, obs, wg, w_right=wg_r,
                                       baseline=baseline, obs_right=obs_r,
                                       **cam)
            sc = dict(pts=torch.cat([pos.T, torch.zeros_like(pos.T)]),
                      wg=torch.stack([wg, wg_r]), e2_old=e2_old, use=use,
                      **{k: pos.new_zeros(rows(f) * m)
                         for k, rows in _SCRATCH[4:]})
            scratch_out = _pack_scratch(sc)
        return _pack_state(st), scratch_out, part, out

    sc = _unpack_scratch(scratch, f, m)
    wg, wg_r = sc["wg"].reshape(NB, f, m)
    win = _Window(_blocks(obs, wg, baseline, obs_r, wg_r), fx, fy, cx, cy,
                  scalar(th2, pos))
    pts = sc["pts"].reshape(2, 3, m)
    cur = st["cur"] > 0
    current = torch.where(cur, pts[1], pts[0]).T.contiguous()
    if kind in (K_SUMS, K_FINAL):
        if it == 0:   # the starting chi-square and the observation count
            st["chi2"] = _chi2_total(rounded[:2])
            st["n_obs"] = rounded[2]
        else:         # the last trial's accept test
            chi2_new = _chi2_total(rounded)
            ok = (chi2_new < st["chi2"]) & (st["bad"] == 0)
            trial = torch.where(cur, pts[0], pts[1]).T.contiguous()
            s = _accept(_BAState(st["r"], st["t"], current, st["lam"],
                                 st["nu"], st["chi2"]),
                        ok, st["rt"], st["tt"], trial, chi2_new)
            st.update(r=s.r_wc, t=s.t_wc, lam=s.lam, nu=s.nu, chi2=s.chi2,
                      cur=torch.where(ok, 1.0 - st["cur"], st["cur"]),
                      acc=torch.where(
                          torch.arange(iterations, device=pos.device)
                          == it - 1, ok.float(), st["acc"]))
            current = s.points
    if kind == K_SUMS:
        # the kernel keeps the per-point blocks in the scratch row for its
        # trial; K_TRIAL here recomputes them, so the row's fields stay as
        # K_SETUP wrote them
        sums = win.point_blocks(st["r"], st["t"], current, st["lam"])[-1]
        return _pack_state(st), _pack_scratch(sc), _pack_iter(sums), out
    if kind == K_TRIAL:
        cam_r, sc_part, g_part = _unpack_iter(tot.float(), f)
        dc = _camera_step(cam_r, sc_part, g_part, st["lam"], 1)
        # the per-point blocks recomputed at the same state rather than read
        # back from the scratch row: the contractions then see the operands
        # refine_window gives them, layout and all
        h_cp, hpp_inv, g_p, _, _ = win.point_blocks(st["r"], st["t"],
                                                    current, st["lam"])
        dp = _point_step(hpp_inv, g_p, h_cp, dc)
        st["rt"], st["tt"] = _retract(st["r"], st["t"], dc)
        trial = current + dp
        st["bad"] = (~(torch.isfinite(dc).all()
                       & torch.isfinite(dp).all())).float()
        slot = torch.where(cur, 0, 1)
        sc["pts"] = torch.where(
            torch.arange(2, device=pos.device)[:, None, None] == slot,
            trial.T[None], pts).reshape(6, m)
        part = torch.stack(win.chi2_parts(st["rt"], st["tt"], trial))
        return _pack_state(st), _pack_scratch(sc), part, out
    out = _keep_refined(poses, pos, current, sc["use"][0], sc["e2_old"][0],
                        obs, wg, obs_r, wg_r, baseline=baseline, **cam)
    return _pack_state(st), scratch_out, part, out


@torch.library.custom_op("lvt_tpu_torch::ba_phase", mutates_args=(),
                         device_types="cuda")
def ba_phase_op(kind: int, it: int, state: Optional[torch.Tensor],
                scratch: Optional[torch.Tensor], t: torch.Tensor,
                q: torch.Tensor, pos: torch.Tensor, obs: torch.Tensor,
                w: torch.Tensor, obs_r: torch.Tensor, w_r: torch.Tensor,
                tot: Optional[torch.Tensor], fx: float, fy: float, cx: float,
                cy: float, baseline: float, th2: float, iterations: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One phase of S streams' sharded BA bodies (``ba_phase_plain``'s
    arguments with a leading stream axis): state [S, state_size] float32
    (None for K_GATE1), scratch [S, M * scratch_per_point] (for K_SUMS,
    K_TRIAL and K_FINAL), the window t [S, F, 3], q [S, F, 4], pos [S, M,
    3], obs, obs_r [S, F, M, 2], w, w_r [S, F, M], tot [S, n] float64 (the
    previous phase's partials all-reduced; None for K_GATE1) -> (state,
    scratch [S, M * scratch_per_point] for K_SETUP, K_SUMS and K_TRIAL,
    else [S, 0], part [S, part_size] float64, positions [S, M, 3] for
    K_FINAL, else [S, 0, 3]).

    CUDA: one launch of ``csrc/ba.cu``'s ``ba_phase_kernel`` for all
    streams, ``ba_refine``'s cluster of blocks per stream and its code
    split at its sums over the points; each phase's partials are the
    cluster's float64 totals in rank order, rounded by the next phase. A
    window of more than the kernel's MAX_F poses raises, and so does a
    launch the card refuses."""
    s, f, m = obs.shape[:3]
    dev = pos.device
    lib = kernels.lib()
    if not 1 <= f <= lib.lvt_ba_max_window():
        raise ValueError(f"ba_phase: a window of {f} poses; the kernel "
                         f"takes 1 to {lib.lvt_ba_max_window()}")
    _check_stereo(w_r, baseline)
    if iterations < 0:
        raise ValueError(f"ba_phase: {iterations} iterations")
    _check_layout(f, iterations)
    n_scratch = m * scratch_per_point(f)
    reads = kind in (K_SUMS, K_TRIAL, K_FINAL)
    needs = dict(state=kind != K_GATE1, tot=kind != K_GATE1, scratch=reads)
    for x, name, dtype, shape in (
            (state, "state", torch.float32, (s, state_size(f, iterations))),
            (scratch, "scratch", torch.float32, (s, n_scratch)),
            (t, "t", torch.float32, (s, f, 3)),
            (q, "q", torch.float32, (s, f, 4)),
            (pos, "pos", torch.float32, (s, m, 3)),
            (obs, "obs", torch.float32, (s, f, m, 2)),
            (w, "w", torch.float32, (s, f, m)),
            (obs_r, "obs_r", torch.float32, (s, f, m, 2)),
            (w_r, "w_r", torch.float32, (s, f, m)),
            (tot, "tot", torch.float64, (s, _tot_size(kind, it, f)))):
        if x is None and needs.get(name, True):
            raise ValueError(f"ba_phase: phase {kind} needs {name}")
        if x is not None:
            kernels.require(x, name, dtype, shape, dev)
    state_out, scratch_out, part, out = _phase_outputs(kind, s, f, m,
                                                       iterations, pos)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.lvt_ba_phase(
            kind, it, t.data_ptr(), q.data_ptr(), pos.data_ptr(),
            obs.data_ptr(), w.data_ptr(), obs_r.data_ptr(), w_r.data_ptr(),
            s, f, m, iterations, fx, fy, cx, cy, th2, -baseline, GATE_TH2,
            ptr(state), state_out.data_ptr(), ptr(scratch),
            ptr(scratch_out), ptr(tot), ptr(part), ptr(out),
            kernels.stream_ptr(pos))
    kernels.check(err, "ba_phase")
    ba_phase.launches += 1
    return state_out, scratch_out, part, out


@functools.lru_cache(maxsize=None)
def _check_layout(f: int, iterations: int) -> None:
    """The kernel's state row and iteration sums are this module's."""
    import ctypes

    got = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().lvt_ba_phase_shape(f, iterations, got),
                  "ba_phase (layout)")
    want = (state_size(f, iterations), scratch_per_point(f), iter_sums(f))
    if tuple(got) != want:
        raise RuntimeError(f"ba_phase: the kernel's layout {tuple(got)} is "
                           f"not the wrapper's {want}")


def _phase_outputs(kind, s, f, m, iterations, like):
    """Empty outputs of a phase of S streams."""
    keeps = kind in (K_SETUP, K_SUMS, K_TRIAL)
    return (like.new_empty((s, state_size(f, iterations))),
            like.new_empty((s, m * scratch_per_point(f) if keeps else 0)),
            like.new_empty((s, part_size(kind, f)), dtype=torch.float64),
            like.new_empty((s, m if kind == K_FINAL else 0, 3)))


@ba_phase_op.register_kernel("cpu")
def _ba_phase_cpu(kind, it, state, scratch, t, q, pos, obs, w, obs_r, w_r,
                  tot, fx, fy, cx, cy, baseline, th2, iterations):
    none = [None] * pos.shape[0]
    outs = [ba_phase_plain(kind, it, *a, fx, fy, cx, cy, baseline, th2,
                           iterations)
            for a in zip(none if state is None else state,
                         none if scratch is None else scratch, t, q, pos,
                         obs, w, obs_r, w_r, none if tot is None else tot)]
    return tuple(torch.stack(o) for o in zip(*outs))


@ba_phase_op.register_fake
def _ba_phase_fake(kind, it, state, scratch, t, q, pos, obs, w, obs_r, w_r,
                   tot, fx, fy, cx, cy, baseline, th2, iterations):
    s, f, m = obs.shape[:3]
    return _phase_outputs(kind, s, f, m, iterations, pos)


def _ba_phase_vmap(info, in_dims, kind, it, *args):
    tensors, dims = args[:10], in_dims[2:12]
    given = [i for i, x in enumerate(tensors) if x is not None]
    folded = kernels.fold_streams(info, [dims[i] for i in given],
                                  [tensors[i] for i in given])
    flat = [None] * 10
    for i, x in zip(given, folded):
        flat[i] = x
    b = info.batch_size
    outs = ba_phase_op(kind, it, *flat, *args[10:])
    return (tuple(x.view(b, x.shape[0] // b, *x.shape[1:]) for x in outs),
            (0,) * 4)


ba_phase_op.register_vmap(_ba_phase_vmap)


def ba_phase(kind: int, it: int, state, scratch, t, q, pos, obs, w, obs_r,
             w_r, tot, *, fx, fy, cx, cy, baseline, reprojection_th2,
             iterations):
    """One phase of S streams' sharded BA bodies (``ba_phase_op``): CPU
    tensors take the plain version stream by stream, CUDA tensors one
    launch of the kernel, and under ``torch.func.vmap`` one launch serves
    every stream."""
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pos: expected a CUDA tensor, got {pos.device}")
    return ba_phase_op(kind, int(it), state, scratch, t, q, pos, obs, w,
                       obs_r, w_r, tot, float(fx), float(fy), float(cx),
                       float(cy), float(baseline), float(reprojection_th2),
                       int(iterations))


ba_phase.launches = 0


class BAPhases(NamedTuple):
    """A phased BA's result: the positions [M, 3], the last phase's state
    row, and the window's poses, which lay the row out."""
    positions: torch.Tensor
    state: torch.Tensor
    n_poses: int

    @property
    def chi2(self) -> torch.Tensor:
        return self.state[_offset(self.n_poses, "chi2")]

    @property
    def n_obs(self) -> torch.Tensor:
        return self.state[_offset(self.n_poses, "n_obs")].to(torch.int64)

    @property
    def accepted(self) -> torch.Tensor:
        return self.state[_offset(self.n_poses, "acc"):] > 0

    def outputs(self) -> tuple:
        """``refine_structure_plain``'s outputs: (positions, chi2, n_obs,
        the accept bits)."""
        return self.positions, self.chi2, self.n_obs, self.accepted


def refine_structure_phases(poses: Pose, pos, obs, w, obs_r, w_r, *, fx, fy,
                            cx, cy, baseline, iterations, reprojection_th2,
                            group=None) -> BAPhases:
    """One window's local BA body as ``n_phases(iterations)`` launches of
    ``ba_phase``, each phase's partial sums over the points all-reduced
    over ``group`` in float64 before the next (3 + 2 per iteration
    all-reduces: the gate's two moments, the first chi-square with the
    observation count, per iteration its sums and the trial chi-square).
    With None, or on one rank, every all-reduce returns its input, and the
    result is ``ba_refine``'s, bit for bit; with more ranks it is
    ``refine_structure_plain(group=)``'s. Under ``torch.func.vmap`` each
    phase is one launch for all streams. Only the positions are computed
    eagerly; ``BAPhases.outputs`` gives the rest."""
    win = [x.float()[None].contiguous()
           for x in (poses.t, poses.q, pos, obs, w, obs_r, w_r)]
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline,
              reprojection_th2=reprojection_th2, iterations=iterations)

    def phase(kind, it, state, scratch, part):
        tot = None if part is None else psum_if(part, group)
        return ba_phase(kind, it, state, scratch, *win, tot, **kw)

    state, _, part, _ = phase(K_GATE1, 0, None, None, None)
    state, _, part, _ = phase(K_GATE2, 0, state, None, part)
    state, scratch, part, _ = phase(K_SETUP, 0, state, None, part)
    for it in range(iterations):
        state, scratch, part, _ = phase(K_SUMS, it, state, scratch, part)
        state, scratch, part, _ = phase(K_TRIAL, it, state, scratch, part)
    state, _, _, out = phase(K_FINAL, iterations, state, scratch, part)
    return BAPhases(out[0], state[0], obs.shape[0])


def phase_device_launches(device=None) -> int:
    """``ba_phase``'s launches on a CUDA ``device`` so far, counted by the
    kernel itself (see :func:`device_launches`)."""
    import ctypes

    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        kernels.check(kernels.lib().lvt_ba_phase_launches(ctypes.byref(n)),
                      "ba_phase (launch count)")
    return n.value
