"""Motion-only bundle adjustment: robust Levenberg-Marquardt PnP on SE(3).

Port of lvt_tpu/solver/pnp.py: analytic 2x6 Jacobians, Cauchy weights
(delta^2 = reprojection_th2), a 6x6 normal-equation solve, 2 passes of 5
iterations, and chi-square demotion after each pass; rejected steps keep
the state and only adapt lambda, and a singular system yields a
non-finite step, which the accept test rejects, as in JAX.

The whole solve is the custom op ``lvt_tpu_torch::pnp_solve`` over a
leading stream axis S, built as kernel T's op is (ops/top2.py):

* CUDA: one launch of the hand-written kernel of ``csrc/pnp_lm.cu`` for
  all S streams, one thread block per stream running the 2 x (setup + 5
  iterations) schedule on chip, the 6x6 step by LU with partial pivoting;
  its sums over the points in an order fixed by M alone (the normal
  equations in float64, rounded once; the chi-square in float32), so a
  stream of the vmapped multi-stream step gets the bits of the same
  stream tracked alone (ROADMAP H8). lvt_tpu runs this solve as XLA ops;
  it is not a TPU kernel;
* CPU: the plain version stream by stream, ``solve_pnp_plain``: the torch
  ops this module has always run, with its two reductions the ops
  ``lvt_tpu_torch::pnp_normal_eqs`` and ``lvt_tpu_torch::stream_sum``
  (``csrc/pnp.cu`` on the card; the einsums and the sum on the CPU, so the
  CPU keeps its bits against lvt_tpu) and the step
  ``torch.linalg.solve_ex``. On the card the plain version is a
  reference for the tests and chip_smoke.py, never the main path;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis.

With a ``group`` (the points sharded over its ranks, lvt_tpu's
``axis_name``), a collective cannot run inside the kernel: the solve runs
as ``N_PHASES`` launches of the op ``lvt_tpu_torch::pnp_phase``, the same
kernel code split at each reduction over the points (the plain version's
operations, split the same way, on the CPU). Each phase writes its rank's
partial sums in float64 (the normal equations before their one rounding;
the chi-square's float32 sum, within 1.7e-6 of its exact value at 4096
points since its terms are non-negative), which are summed over the group
and rounded once by the next phase, so the shard count changes only the
order of float64 additions; on one rank the phases give ``pnp_solve``'s
bits. Per pass the diagonal and the starting chi-square, then per
iteration [H | g] and the trial chi-square, and the inlier count: 25
all-reduces per solve. The 6x6 step and the pose update run on every rank
alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.device import scalar
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose, matvec
from lvt_tpu_torch.ops.collectives import psum_if

N_PASSES = 2
N_ITERS_PER_PASS = 5
LM_TAU = 1e-5
NP = 6    # pose parameters


def normal_equations_plain(jac: torch.Tensor, w: torch.Tensor,
                           r: torch.Tensor):
    """One stream's normal equations from jac [M, 2, 6], weights w [M] and
    residuals r [M, 2]: (hg [6, 7] = [H | g] with H = sum jw^T jac and g =
    sum jw^T r for jw = jac * w, h_diag [6] = sum w jac^2). H and g come
    from one product, g as a 7th column against the residual: under vmap on
    the CPU a matrix-vector einsum sums in another order than alone, this
    matrix product in the same."""
    jw = jac * w[:, None, None]
    hg = torch.einsum("mki,mkj->ij", jw, torch.cat([jac, r[..., None]], -1))
    return hg, torch.einsum("m,mki,mki->i", w, jac, jac)


@torch.library.custom_op("lvt_tpu_torch::pnp_normal_eqs", mutates_args=(),
                         device_types="cuda")
def pnp_normal_eqs_op(jac: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                      wide: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """PnP's normal equations of S streams: jac [S, M, 2, 6], w [S, M], r
    [S, M, 2] float32 -> hg [S, 6, 7], h_diag [S, 6], float32, or with
    ``wide`` float64, on the CPU only: the float32 sums widened (the
    partials that the CPU's phases of a sharded solve add across ranks;
    on the card the phases are ``pnp_phase``'s kernel).

    CUDA: one launch of ``csrc/pnp.cu`` for all streams (one block per
    stream; its sums in an order fixed by M, whatever S); ``wide`` raises."""
    if wide:
        raise ValueError("wide: the float64 normal equations are the CPU's "
                         "only; the card's sharded solve runs pnp_phase")
    s, m = jac.shape[0], jac.shape[1]
    dev = jac.device
    kernels.require(jac, "jac", torch.float32, (s, m, 2, NP), dev)
    kernels.require(w, "w", torch.float32, (s, m), dev)
    kernels.require(r, "r", torch.float32, (s, m, 2), dev)
    hg = torch.empty((s, NP, NP + 1), dtype=torch.float32, device=dev)
    h_diag = torch.empty((s, NP), dtype=torch.float32, device=dev)
    err = kernels.lib().lvt_pnp_normal_eqs(
        jac.data_ptr(), w.data_ptr(), r.data_ptr(), s, m, hg.data_ptr(),
        h_diag.data_ptr(), kernels.stream_ptr(jac))
    kernels.check(err, "pnp_normal_eqs")
    normal_equations.launches += 1
    return hg, h_diag


@pnp_normal_eqs_op.register_kernel("cpu")
def _pnp_normal_eqs_cpu(jac, w, r, wide=False):
    outs = [normal_equations_plain(*a) for a in zip(jac, w, r)]
    hg = torch.stack([o[0] for o in outs])
    h_diag = torch.stack([o[1] for o in outs])
    return (hg.double(), h_diag.double()) if wide else (hg, h_diag)


@pnp_normal_eqs_op.register_fake
def _pnp_normal_eqs_fake(jac, w, r, wide=False):
    s = jac.shape[0]
    out = torch.float64 if wide else torch.float32
    return (jac.new_empty((s, NP, NP + 1), dtype=out),
            jac.new_empty((s, NP), dtype=out))


def _pnp_normal_eqs_vmap(info, in_dims, jac, w, r, wide=False):
    """Batching rule: vmap's axis and the stream axis fold into one
    launch (``kernels.fold_streams``); the outputs unfold to [B, S, ...]."""
    b = info.batch_size
    hg, h_diag = pnp_normal_eqs_op(
        *kernels.fold_streams(info, in_dims[:3], (jac, w, r)), wide)
    return ((hg.view(b, -1, *hg.shape[1:]), h_diag.view(b, -1, NP)), (0, 0))


pnp_normal_eqs_op.register_vmap(_pnp_normal_eqs_vmap)


@torch.library.custom_op("lvt_tpu_torch::stream_sum", mutates_args=(),
                         device_types="cuda")
def stream_sum_op(x: torch.Tensor) -> torch.Tensor:
    """Each stream's sum: x [S, N] float32 -> [S]. CUDA: one launch of
    ``csrc/pnp.cu``'s sum kernel for all streams (one block per stream, in
    an order fixed by N, whatever S)."""
    s, n = x.shape
    kernels.require(x, "x", torch.float32, (s, n))
    out = torch.empty((s,), dtype=torch.float32, device=x.device)
    err = kernels.lib().lvt_stream_sum(x.data_ptr(), s, n, out.data_ptr(),
                                       kernels.stream_ptr(x))
    kernels.check(err, "stream_sum")
    stream_sum.launches += 1
    return out


@stream_sum_op.register_kernel("cpu")
def _stream_sum_cpu(x):
    return torch.stack([row.sum() for row in x])


@stream_sum_op.register_fake
def _stream_sum_fake(x):
    return x.new_empty((x.shape[0],))


def _stream_sum_vmap(info, in_dims, x):
    out = stream_sum_op(*kernels.fold_streams(info, in_dims, (x,)))
    return out.view(info.batch_size, -1), 0


stream_sum_op.register_vmap(_stream_sum_vmap)


def stream_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x [N] (a 0-d tensor): the op at S = 1. CPU tensors take
    ``x.sum()``, CUDA tensors the kernel (any other device raises), and
    under ``torch.func.vmap`` one launch serves every stream."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    return stream_sum_op(x[None])[0]


stream_sum.launches = 0


def normal_equations(jac: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                     wide: bool = False):
    """One stream's (hg [6, 7], h_diag [6]) from jac [M, 2, 6], w [M] and r
    [M, 2] (widened to float64 with ``wide``, the CPU only): the op at
    S = 1. CPU tensors take the plain version, CUDA tensors the kernel
    (any other device raises), and under ``torch.func.vmap`` one launch
    serves every stream."""
    if jac.device.type not in ("cpu", "cuda"):
        raise ValueError(f"jac: expected a CUDA tensor, got {jac.device}")
    hg, h_diag = pnp_normal_eqs_op(jac[None], w[None], r[None], wide)
    return hg[0], h_diag[0]


normal_equations.launches = 0


class PnPResult(NamedTuple):
    pose: Pose
    inlier_mask: torch.Tensor   # [M] bool
    inlier_count: torch.Tensor  # [] int64
    chi2: torch.Tensor          # [] f32 robust total error


def _project_residuals(r_wc, t_wc, points, obs, fx, fy, cx, cy):
    p_cam = matvec(r_wc, points) + t_wc
    z = p_cam[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * p_cam[:, 0] * inv_z + cx
    v = fy * p_cam[:, 1] * inv_z + cy
    return torch.stack([u, v], -1) - obs, p_cam, inv_z


def _jacobians(p_cam, inv_z, fx, fy):
    """d(proj)/d(xi) for a left-multiplicative update of world->camera."""
    x, y = p_cam[:, 0], p_cam[:, 1]
    fxz = fx * inv_z
    fyz = fy * inv_z
    fxxz = fxz * x * inv_z
    fyyz = fyz * y * inv_z
    zeros = torch.zeros_like(fxz)
    ju = torch.stack([fxz, zeros, -fxxz, -fxxz * y, fx + fxxz * x, -fxz * y], -1)
    jv = torch.stack([zeros, fyz, -fyyz, -fy - fyyz * y, fyyz * x, fyz * x], -1)
    return torch.stack([ju, jv], -2)  # [M, 2, 6]


def _cauchy_weights(e2, delta2):
    return 1.0 / (1.0 + e2 / delta2)


def _retract(r_wc, t_wc, delta):
    """R' = exp([w]x) R, t' = exp([w]x) t + v for xi = (v, w); any leading
    batch dims (one per pose)."""
    v, w = delta[..., :3], delta[..., 3:]
    theta2 = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1] + w[..., 2] * w[..., 2]
    theta = torch.sqrt(theta2 + 1e-20)
    half = 0.5 * theta
    sinc = torch.where(theta < 1e-6, 0.5 - theta2 / scalar(48.0, theta2),
                       torch.sin(half) / theta)
    dq = torch.cat([torch.cos(half)[..., None], sinc[..., None] * w], -1)
    dr = quat.to_matrix(quat.normalize(dq))
    r_new = matvec(dr[..., None, :, :], r_wc.transpose(-1, -2)).transpose(-1, -2)
    return r_new, matvec(dr, t_wc) + v


class _Problem(NamedTuple):
    """One stream's fixed inputs of the plain version."""
    points: torch.Tensor
    obs: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    delta2: torch.Tensor   # reprojection_th2, a divisor: see device.scalar

    def project(self, r_wc, t_wc):
        """Residuals, camera points, 1 / z and squared errors at a pose."""
        r, p_cam, inv_z = _project_residuals(r_wc, t_wc, self.points,
                                             self.obs, self.fx, self.fy,
                                             self.cx, self.cy)
        return r, p_cam, inv_z, (r * r).sum(-1)

    def normal_equations(self, proj, w_mask, wide=False):
        """(hg [6, 7], h_diag [6]) at a projection, Cauchy-weighted."""
        r, p_cam, inv_z, e2 = proj
        w = w_mask * _cauchy_weights(e2, self.delta2)
        jac = _jacobians(p_cam, inv_z, self.fx, self.fy)
        return normal_equations(jac, w, r, wide)

    def chi2(self, e2, w_mask):
        """The robust chi-square's sum over the points (float32)."""
        return stream_sum(w_mask * (self.delta2
                                    * torch.log1p(e2 / self.delta2)))

    def step(self, r_wc, t_wc, lam, hg):
        """The LM step from [H | g]: the trial pose and whether the step
        is finite."""
        eye6 = torch.eye(NP, dtype=hg.dtype, device=hg.device)
        step = torch.linalg.solve_ex(hg[:, :NP] + lam * eye6, -hg[:, NP])[0]
        return (*_retract(r_wc, t_wc, step), torch.isfinite(step).all())


def _problem(points, obs, fx, fy, cx, cy, reprojection_th2) -> _Problem:
    return _Problem(points, obs, fx, fy, cx, cy,
                    scalar(reprojection_th2, points))


def _lam0(h_diag):
    return LM_TAU * h_diag.max() + 1e-12


def _initial(initial_pose: Pose):
    """(r_wc, t_wc): the world->camera transform of a camera-in-world pose."""
    r_wc = quat.to_matrix(initial_pose.q).T
    return r_wc, -matvec(r_wc, initial_pose.t)


def _final(r_wc, t_wc) -> Pose:
    r_cw = r_wc.T
    return Pose(-matvec(r_cw, t_wc), quat.from_matrix(r_cw))


class _LMState(NamedTuple):
    r_wc: torch.Tensor
    t_wc: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    chi2: torch.Tensor
    r: torch.Tensor
    p_cam: torch.Tensor
    inv_z: torch.Tensor
    e2: torch.Tensor


def solve_pnp_plain(
    initial_pose: Pose,
    points: torch.Tensor,   # [M, 3] world points (fixed)
    obs: torch.Tensor,      # [M, 2] observed pixels
    weights: torch.Tensor,  # [M] 0/1 validity of each correspondence
    *, fx, fy, cx, cy, reprojection_th2: float = 5.991,
) -> PnPResult:
    """The plain version of one stream's solve: lvt_tpu's solve_pnp as
    torch ops, its two reductions the ops ``pnp_normal_eqs`` and
    ``stream_sum``, the step ``torch.linalg.solve_ex``. The CPU kernel of
    ``lvt_tpu_torch::pnp_solve``; on the card a reference only."""
    pb = _problem(points, obs, fx, fy, cx, cy, reprojection_th2)
    three = scalar(3.0, points)

    def lm_iteration(s: _LMState, w_mask) -> _LMState:
        hg = pb.normal_equations((s.r, s.p_cam, s.inv_z, s.e2), w_mask)[0]
        r_wc_new, t_wc_new, finite = pb.step(s.r_wc, s.t_wc, s.lam, hg)
        r_new, p_new, iz_new, e2_new = pb.project(r_wc_new, t_wc_new)
        chi2_new = pb.chi2(e2_new, w_mask)
        accept = (chi2_new < s.chi2) & finite

        def sel(a, b):
            return torch.where(accept, a, b)

        return _LMState(
            r_wc=sel(r_wc_new, s.r_wc), t_wc=sel(t_wc_new, s.t_wc),
            lam=torch.where(accept, s.lam / three, s.lam * s.nu),
            nu=torch.where(accept, 2.0, s.nu * 2.0),
            chi2=sel(chi2_new, s.chi2), r=sel(r_new, s.r),
            p_cam=sel(p_new, s.p_cam), inv_z=sel(iz_new, s.inv_z),
            e2=sel(e2_new, s.e2),
        )

    def run_pass(r_wc, t_wc, w_mask) -> _LMState:
        proj = pb.project(r_wc, t_wc)
        lam0 = _lam0(pb.normal_equations(proj, w_mask)[1])
        s = _LMState(r_wc, t_wc, lam0, torch.full_like(lam0, 2.0),
                     pb.chi2(proj[3], w_mask), *proj)
        for _ in range(N_ITERS_PER_PASS):
            s = lm_iteration(s, w_mask)
        return s

    r_wc, t_wc = _initial(initial_pose)
    w_mask = weights.to(points.dtype)
    for _ in range(N_PASSES):
        s = run_pass(r_wc, t_wc, w_mask)
        r_wc, t_wc = s.r_wc, s.t_wc
        # raw chi2 > threshold leaves the next pass and the inlier count
        w_mask = w_mask * (s.e2 <= pb.delta2)

    inlier_mask = w_mask > 0
    return PnPResult(pose=_final(r_wc, t_wc), inlier_mask=inlier_mask,
                     inlier_count=inlier_mask.sum(), chi2=s.chi2)


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


# ---- the fused solve: lvt_tpu_torch::pnp_solve

@torch.library.custom_op("lvt_tpu_torch::pnp_solve", mutates_args=(),
                         device_types="cuda")
def pnp_solve_op(t: torch.Tensor, q: torch.Tensor, points: torch.Tensor,
                 obs: torch.Tensor, weights: torch.Tensor, fx: float,
                 fy: float, cx: float, cy: float, th2: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """S streams' whole solves: initial poses t [S, 3], q [S, 4], points
    [S, M, 3], obs [S, M, 2], weights [S, M] float32, the camera and
    reprojection_th2 -> t [S, 3], q [S, 4], inlier mask [S, M] bool, inlier
    count [S] int64, chi2 [S] float32.

    CUDA: one launch of ``csrc/pnp_lm.cu``'s solve for all streams (one
    block per stream; every sum in an order fixed by M, whatever S)."""
    s, m = points.shape[0], points.shape[1]
    dev = points.device
    for x, name, shape in ((t, "t", (s, 3)), (q, "q", (s, 4)),
                           (points, "points", (s, m, 3)),
                           (obs, "obs", (s, m, 2)),
                           (weights, "weights", (s, m))):
        kernels.require(x, name, torch.float32, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty((s, m), **f32)
    t_out, q_out = torch.empty((s, 3), **f32), torch.empty((s, 4), **f32)
    inlier = torch.empty((s, m), dtype=torch.bool, device=dev)
    count = torch.empty((s,), dtype=torch.int64, device=dev)
    chi2 = torch.empty((s,), **f32)
    # the launch, and the kernel's shared-memory limit that precedes it, on
    # the tensors' device, whichever is current
    with torch.cuda.device(dev):
        err = kernels.lib().lvt_pnp_solve(
            t.data_ptr(), q.data_ptr(), points.data_ptr(), obs.data_ptr(),
            weights.data_ptr(), s, m, fx, fy, cx, cy, th2,
            scratch.data_ptr(), t_out.data_ptr(), q_out.data_ptr(),
            inlier.data_ptr(), count.data_ptr(), chi2.data_ptr(),
            kernels.stream_ptr(points))
    kernels.check(err, "pnp_solve")
    pnp_solve.launches += 1
    return t_out, q_out, inlier, count, chi2


@pnp_solve_op.register_kernel("cpu")
def _pnp_solve_cpu(t, q, points, obs, weights, fx, fy, cx, cy, th2):
    outs = [solve_pnp_plain(Pose(*a[:2]), *a[2:], fx=fx, fy=fy, cx=cx,
                            cy=cy, reprojection_th2=th2)
            for a in zip(t, q, points, obs, weights)]
    return (torch.stack([o.pose.t for o in outs]),
            torch.stack([o.pose.q for o in outs]),
            torch.stack([o.inlier_mask for o in outs]),
            torch.stack([o.inlier_count for o in outs]),
            torch.stack([o.chi2 for o in outs]))


@pnp_solve_op.register_fake
def _pnp_solve_fake(t, q, points, obs, weights, fx, fy, cx, cy, th2):
    s, m = points.shape[0], points.shape[1]
    return (t.new_empty((s, 3)), t.new_empty((s, 4)),
            t.new_empty((s, m), dtype=torch.bool),
            t.new_empty((s,), dtype=torch.int64), t.new_empty((s,)))


def _unfold(b: int, outs) -> tuple:
    """Outputs of a folded launch [B * S, ...] as [B, S, ...]."""
    return tuple(x.view(b, x.shape[0] // b, *x.shape[1:]) for x in outs)


def _pnp_solve_vmap(info, in_dims, t, q, points, obs, weights, *cam):
    outs = pnp_solve_op(*kernels.fold_streams(
        info, in_dims[:5], (t, q, points, obs, weights)), *cam)
    return _unfold(info.batch_size, outs), (0,) * 5


pnp_solve_op.register_vmap(_pnp_solve_vmap)


def pnp_solve(t, q, points, obs, weights, *, fx, fy, cx, cy,
              reprojection_th2: float = 5.991):
    """S streams' solves (``pnp_solve_op``): CPU tensors take the plain
    version stream by stream, CUDA tensors one launch of the kernel, and
    under ``torch.func.vmap`` one launch serves every stream."""
    _check_device(points, "points")
    return pnp_solve_op(t, q, points, obs, weights, float(fx), float(fy),
                        float(cx), float(cy), float(reprojection_th2))


pnp_solve.launches = 0


# ---- the sharded solve's phases: lvt_tpu_torch::pnp_phase

# the state row between the phases and its fields (csrc/pnp_lm.cu)
NSTATE = 36
S_T, S_Q, S_R, S_TW, S_LAM, S_NU, S_CHI2 = 0, 3, 7, 16, 19, 20, 21
S_TR_R, S_TR_T, S_TR_OK = 22, 31, 34
K_SETUP, K_NORMAL, K_TRIAL, K_FINAL = range(4)
# the partial sums a phase writes for the all-reduce after it
PART_A = {K_SETUP: NP, K_NORMAL: NP * (NP + 1), K_TRIAL: 0, K_FINAL: 0}
# ... and the summed ones it reads (the diagonal; [H | g])
TOT_A = {K_NORMAL: NP, K_TRIAL: NP * (NP + 1)}
# launches of one sharded solve: per pass a setup, then 5 x (normal, trial)
N_PHASES = N_PASSES * (1 + 2 * N_ITERS_PER_PASS) + 1


def _unpack(state):
    st = dict(t=state[S_T:S_Q], q=state[S_Q:S_R],
              r_wc=state[S_R:S_TW].reshape(3, 3), t_wc=state[S_TW:S_LAM],
              tr_r=state[S_TR_R:S_TR_T].reshape(3, 3),
              tr_t=state[S_TR_T:S_TR_OK], tr_ok=state[S_TR_OK] != 0)
    st.update(lam=state[S_LAM], nu=state[S_NU], chi2=state[S_CHI2])
    return st


def _pack(st) -> torch.Tensor:
    one = lambda x: x.reshape(-1)  # noqa: E731
    return torch.cat([st["t"], st["q"], one(st["r_wc"]), st["t_wc"],
                      one(st["lam"]), one(st["nu"]), one(st["chi2"]),
                      one(st["tr_r"]), st["tr_t"],
                      one(st["tr_ok"].to(st["t"].dtype)),
                      st["t"].new_zeros(NSTATE - S_TR_OK - 1)])


def pnp_phase_plain(kind: int, flag: int, state, w, points, obs, tot_a,
                    tot_b, fx, fy, cx, cy, th2):
    """One stream's phase of the sharded solve (the CPU kernel of
    ``lvt_tpu_torch::pnp_phase``): state [NSTATE], w [M] -> (state, w,
    part_a [PART_A[kind]] float64, part_b [] float64). The plain version's
    operations, split at each reduction over the points: composed with the
    all-reduces as identities they give ``solve_pnp_plain``'s bits."""
    pb = _problem(points, obs, fx, fy, cx, cy, th2)
    st = _unpack(state)
    if kind == K_SETUP and flag == 0:
        st["r_wc"], st["t_wc"] = _initial(Pose(st["t"], st["q"]))
    elif kind == K_NORMAL and flag:
        st["lam"] = _lam0(tot_a.float())
        st["nu"] = torch.full_like(st["lam"], 2.0)
        st["chi2"] = tot_b.float()
    elif kind == K_TRIAL:
        hg = tot_a.float().view(NP, NP + 1)
        st["tr_r"], st["tr_t"], st["tr_ok"] = pb.step(st["r_wc"], st["t_wc"],
                                                     st["lam"], hg)
    else:
        chi2_new = tot_b.float()
        accept = (chi2_new < st["chi2"]) & st["tr_ok"]
        three = scalar(3.0, points)
        st["lam"] = torch.where(accept, st["lam"] / three,
                                st["lam"] * st["nu"])
        st["nu"] = torch.where(accept, 2.0, st["nu"] * 2.0)
        st["chi2"] = torch.where(accept, chi2_new, st["chi2"])
        st["r_wc"] = torch.where(accept, st["tr_r"], st["r_wc"])
        st["t_wc"] = torch.where(accept, st["tr_t"], st["t_wc"])

    part_a = points.new_zeros(PART_A[kind], dtype=torch.float64)
    part_b = points.new_zeros((), dtype=torch.float64)
    if kind == K_TRIAL:
        e2 = pb.project(st["tr_r"], st["tr_t"])[3]
        part_b = pb.chi2(e2, w).double()
    else:
        proj = pb.project(st["r_wc"], st["t_wc"])
        if kind == K_FINAL or (kind == K_SETUP and flag):
            w = w * (proj[3] <= pb.delta2)
        if kind == K_SETUP:
            part_a = pb.normal_equations(proj, w, wide=True)[1]
            part_b = pb.chi2(proj[3], w).double()
        elif kind == K_NORMAL:
            part_a = pb.normal_equations(proj, w, wide=True)[0].reshape(-1)
        else:
            part_b = (w > 0).sum().double()
            st["t"], st["q"] = _final(st["r_wc"], st["t_wc"])
    return _pack(st), w, part_a, part_b


@torch.library.custom_op("lvt_tpu_torch::pnp_phase", mutates_args=(),
                         device_types="cuda")
def pnp_phase_op(kind: int, flag: int, state: torch.Tensor, w: torch.Tensor,
                 points: torch.Tensor, obs: torch.Tensor,
                 tot_a: Optional[torch.Tensor],
                 tot_b: Optional[torch.Tensor],
                 fx: float, fy: float, cx: float, cy: float, th2: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One phase of S streams' sharded solves: state [S, NSTATE], w
    [S, M] float32, points [S, M, 3], obs [S, M, 2]; tot_a [S, 6 or 42]
    and tot_b [S] float64, the all-reduced partials the phase reads (None
    where it reads none) -> (state, w, part_a [S, PART_A[kind]], part_b
    [S]), the partials float64.

    CUDA: one launch of ``csrc/pnp_lm.cu``'s phase kernel for all streams,
    the fused solve's code split at its reductions."""
    s, m = points.shape[0], points.shape[1]
    dev = points.device
    for x, name, dtype, shape in (
            (state, "state", torch.float32, (s, NSTATE)),
            (w, "w", torch.float32, (s, m)),
            (points, "points", torch.float32, (s, m, 3)),
            (obs, "obs", torch.float32, (s, m, 2)),
            (tot_a, "tot_a", torch.float64, (s, TOT_A.get(kind, 0))),
            (tot_b, "tot_b", torch.float64, (s,))):
        if x is not None:
            kernels.require(x, name, dtype, shape, dev)
    state_out = torch.empty_like(state)
    w_out = torch.empty_like(w)
    part_a = torch.empty((s, PART_A[kind]), dtype=torch.float64, device=dev)
    part_b = torch.empty((s,), dtype=torch.float64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = kernels.lib().lvt_pnp_phase(
        kind, flag, state.data_ptr(), state_out.data_ptr(), w.data_ptr(),
        w_out.data_ptr(), points.data_ptr(), obs.data_ptr(), s, m, fx, fy,
        cx, cy, th2, ptr(tot_a), ptr(tot_b), part_a.data_ptr(),
        part_b.data_ptr(), kernels.stream_ptr(points))
    kernels.check(err, "pnp_phase")
    pnp_phase.launches += 1
    return state_out, w_out, part_a, part_b


@pnp_phase_op.register_kernel("cpu")
def _pnp_phase_cpu(kind, flag, state, w, points, obs, tot_a, tot_b, fx, fy,
                   cx, cy, th2):
    none = [None] * state.shape[0]
    outs = [pnp_phase_plain(kind, flag, *a, fx, fy, cx, cy, th2)
            for a in zip(state, w, points, obs,
                         none if tot_a is None else tot_a,
                         none if tot_b is None else tot_b)]
    return tuple(torch.stack(o) for o in zip(*outs))


@pnp_phase_op.register_fake
def _pnp_phase_fake(kind, flag, state, w, points, obs, tot_a, tot_b, fx, fy,
                    cx, cy, th2):
    s = state.shape[0]
    return (torch.empty_like(state), torch.empty_like(w),
            state.new_empty((s, PART_A[kind]), dtype=torch.float64),
            state.new_empty((s,), dtype=torch.float64))


def _pnp_phase_vmap(info, in_dims, kind, flag, *args):
    tensors, dims = args[:6], in_dims[2:8]
    given = [i for i, x in enumerate(tensors) if x is not None]
    folded = kernels.fold_streams(info, [dims[i] for i in given],
                                  [tensors[i] for i in given])
    flat = [None] * 6
    for i, x in zip(given, folded):
        flat[i] = x
    outs = pnp_phase_op(kind, flag, *flat, *args[6:])
    return _unfold(info.batch_size, outs), (0,) * 4


pnp_phase_op.register_vmap(_pnp_phase_vmap)


def pnp_phase(kind: int, flag: int, state, w, points, obs, tot_a, tot_b,
              *, fx, fy, cx, cy, reprojection_th2: float = 5.991):
    """One phase of S streams' sharded solves (``pnp_phase_op``): CPU
    tensors take the plain version stream by stream, CUDA tensors one
    launch of the kernel, and under ``torch.func.vmap`` one launch serves
    every stream."""
    _check_device(points, "points")
    return pnp_phase_op(kind, int(flag), state, w, points, obs, tot_a, tot_b,
                        float(fx), float(fy), float(cx), float(cy),
                        float(reprojection_th2))


pnp_phase.launches = 0


def solve_pnp_phases(initial_pose: Pose, points, obs, weights, *, fx, fy,
                     cx, cy, reprojection_th2: float = 5.991,
                     group=None) -> PnPResult:
    """One stream's solve as N_PHASES launches of ``pnp_phase``, each
    partial sum over the points all-reduced over ``group`` in float64
    between them (25 all-reduces; with None, or on one rank, they return
    their input, and the result is ``pnp_solve``'s, bit for bit)."""
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, reprojection_th2=reprojection_th2)
    pts, ob = points[None].contiguous(), obs[None].contiguous()

    def phase(kind, flag, state, w, tot_a=None, tot_b=None):
        return pnp_phase(kind, flag, state, w, pts, ob, tot_a, tot_b, **cam)

    def total(x):
        return psum_if(x, group)

    pose = torch.cat([initial_pose.t, initial_pose.q])
    state = torch.cat([pose, pose.new_zeros(NSTATE - pose.shape[0])])[None]
    w, tot_b = weights.to(points.dtype)[None].contiguous(), None
    for p in range(N_PASSES):
        state, w, h_diag, chi2 = phase(K_SETUP, p, state, w, tot_b=tot_b)
        h_diag, tot_b = total(h_diag), total(chi2)
        for i in range(N_ITERS_PER_PASS):
            state, w, hg, _ = phase(K_NORMAL, i == 0, state, w,
                                    h_diag if i == 0 else None, tot_b)
            state, w, _, chi2 = phase(K_TRIAL, 0, state, w, total(hg))
            tot_b = total(chi2)
    state, w, _, count = phase(K_FINAL, 0, state, w, tot_b=tot_b)
    return PnPResult(pose=Pose(state[0, S_T:S_Q], state[0, S_Q:S_R]),
                     inlier_mask=w[0] > 0,
                     inlier_count=total(count)[0].to(torch.int64),
                     chi2=state[0, S_CHI2])


def solve_pnp(
    initial_pose: Pose,
    points: torch.Tensor,   # [M, 3] world points (fixed)
    obs: torch.Tensor,      # [M, 2] observed pixels
    weights: torch.Tensor,  # [M] 0/1 validity of each correspondence
    *, fx, fy, cx, cy, reprojection_th2: float = 5.991, group=None,
) -> PnPResult:
    """Robust LM PnP with the reference's 2 x 5 + outlier-demotion
    schedule: one launch of ``pnp_solve`` (under vmap, one for all
    streams). With ``group``, the points are this rank's block of a set
    sharded over the group's ranks, and the solve runs as the phases of
    ``solve_pnp_phases``, every reduction over the points summed across
    the group."""
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, reprojection_th2=reprojection_th2)
    if group is not None:
        return solve_pnp_phases(initial_pose, points, obs, weights,
                                group=group, **cam)
    t, q, inlier, count, chi2 = pnp_solve(
        initial_pose.t[None].contiguous(), initial_pose.q[None].contiguous(),
        points[None].contiguous(), obs[None].contiguous(),
        weights.to(points.dtype)[None].contiguous(), **cam)
    return PnPResult(Pose(t[0], q[0]), inlier[0], count[0], chi2[0])
