"""Motion-only bundle adjustment: robust Levenberg-Marquardt PnP on SE(3).

Port of lvt_tpu/solver/pnp.py: analytic 2x6 Jacobians,
Cauchy weights (delta^2 = reprojection_th2), a 6x6 normal-equation solve,
2 passes of 5 iterations, and chi-square demotion after each pass. The
iteration loop is a Python loop of fixed length; rejected steps keep the
state and only adapt lambda. ``torch.linalg.solve_ex`` skips the error
check (no host sync); a singular system yields a non-finite step, which
the accept test rejects, as in JAX.

The solver's two reductions over the points, the normal equations (H, g
and H's diagonal) and the robust chi-square's sum, are the custom ops
``lvt_tpu_torch::pnp_normal_eqs`` and ``lvt_tpu_torch::stream_sum`` over a
leading stream axis S, built as kernel T's op is (ops/top2.py):

* CUDA: one launch of a hand-written kernel of ``csrc/pnp.cu`` for all S
  streams, one block per stream, each summing in an order fixed by M
  alone (the normal equations in float64, rounded once; the chi-square in
  float32), so a stream of the vmapped multi-stream step gets the bits of
  the same stream tracked alone (ROADMAP H8). They are not TPU kernels:
  lvt_tpu sums these with XLA ops (lvt_tpu/solver/pnp.py:148, 155-156);
* CPU: the plain versions stream by stream, the einsums and the sum this
  module used before the ops, so the CPU keeps its bits against lvt_tpu;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis.

With a ``group`` (the points sharded over its ranks, lvt_tpu's
``axis_name``), every reduction over the points is summed across the
ranks, in this order: each rank's normal equations come out of the op
``wide``, as float64 partial sums before their one rounding (CUDA: the
kernel's float64 sums; CPU: the float32 plain version, widened, so the CPU
keeps lvt_tpu's bits), are summed over the group in float64 and then
rounded once to float32; the shard count then changes only the order of
float64 additions. The chi-square's partial is the float32 sum the op
already gives (its terms are non-negative, so nothing cancels and the
partial is within 1.7e-6 of its exact value at 4096 points), summed over
the group in float64 and rounded once, so the order in which the ranks
are added moves the total by float64 rounding only. On one rank both are
the unsharded bits. The inlier count is a ``psum``; the 6x6 solve and the
pose update run on every rank alike, so the LM loop needs no other
communication.
"""

from __future__ import annotations

from typing import NamedTuple

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
    ``wide`` float64: the sums before their rounding to float32 (the
    partials that a sharded solve adds across its ranks).

    CUDA: one launch of ``csrc/pnp.cu`` for all streams (one block per
    stream; its sums in an order fixed by M, whatever S)."""
    s, m = jac.shape[0], jac.shape[1]
    dev = jac.device
    kernels.require(jac, "jac", torch.float32, (s, m, 2, NP), dev)
    kernels.require(w, "w", torch.float32, (s, m), dev)
    kernels.require(r, "r", torch.float32, (s, m, 2), dev)
    out = torch.float64 if wide else torch.float32
    hg = torch.empty((s, NP, NP + 1), dtype=out, device=dev)
    h_diag = torch.empty((s, NP), dtype=out, device=dev)
    err = kernels.lib().lvt_pnp_normal_eqs(
        jac.data_ptr(), w.data_ptr(), r.data_ptr(), s, m, hg.data_ptr(),
        h_diag.data_ptr(), int(wide), kernels.stream_ptr(jac))
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
    [M, 2] (float64 partial sums with ``wide``): the op at S = 1. CPU
    tensors take the plain version, CUDA tensors the kernel (any other
    device raises), and under ``torch.func.vmap`` one launch serves every
    stream."""
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


def solve_pnp(
    initial_pose: Pose,
    points: torch.Tensor,   # [M, 3] world points (fixed)
    obs: torch.Tensor,      # [M, 2] observed pixels
    weights: torch.Tensor,  # [M] 0/1 validity of each correspondence
    *, fx, fy, cx, cy, reprojection_th2: float = 5.991, group=None,
) -> PnPResult:
    """Robust LM PnP with the reference's 2 x 5 + outlier-demotion
    schedule. With ``group``, the points are this rank's block of a set
    sharded over the group's ranks, and every reduction over them is
    summed across the group (the module docstring gives the order)."""
    delta2 = scalar(reprojection_th2, points)   # a divisor: see device.scalar
    three = scalar(3.0, points)
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)

    def project(r_wc, t_wc):
        r, p_cam, inv_z = _project_residuals(r_wc, t_wc, points, obs,
                                             fx, fy, cx, cy)
        return r, p_cam, inv_z, (r * r).sum(-1)

    def total(x):
        """A partial sum over this rank's points, summed over the group in
        float64 and rounded once."""
        return x if group is None else psum_if(x.double(), group).float()

    def robust_chi2(e2, w_mask):
        return total(stream_sum(w_mask * (delta2 * torch.log1p(e2 / delta2))))

    def lm_iteration(s: _LMState, w_mask) -> _LMState:
        w = w_mask * _cauchy_weights(s.e2, delta2)
        jac = _jacobians(s.p_cam, s.inv_z, fx, fy)
        hg = total(normal_equations(jac, w, s.r, wide=group is not None)[0])
        h, g = hg[:, :6], hg[:, 6]
        step = torch.linalg.solve_ex(h + s.lam * eye6, -g)[0]
        r_wc_new, t_wc_new = _retract(s.r_wc, s.t_wc, step)
        r_new, p_new, iz_new, e2_new = project(r_wc_new, t_wc_new)
        chi2_new = robust_chi2(e2_new, w_mask)
        accept = (chi2_new < s.chi2) & torch.isfinite(step).all()

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
        r, p_cam, inv_z, e2 = project(r_wc, t_wc)
        w = w_mask * _cauchy_weights(e2, delta2)
        jac = _jacobians(p_cam, inv_z, fx, fy)
        h_diag = total(normal_equations(jac, w, r, wide=group is not None)[1])
        lam0 = LM_TAU * h_diag.max() + 1e-12
        s = _LMState(r_wc, t_wc, lam0, torch.full_like(lam0, 2.0),
                     robust_chi2(e2, w_mask), r, p_cam, inv_z, e2)
        for _ in range(N_ITERS_PER_PASS):
            s = lm_iteration(s, w_mask)
        return s

    r_cw = quat.to_matrix(initial_pose.q)
    r_wc = r_cw.T
    t_wc = -matvec(r_wc, initial_pose.t)
    w_mask = weights.to(points.dtype)
    for _ in range(N_PASSES):
        s = run_pass(r_wc, t_wc, w_mask)
        r_wc, t_wc = s.r_wc, s.t_wc
        # raw chi2 > threshold leaves the next pass and the inlier count
        w_mask = w_mask * (s.e2 <= delta2)

    inlier_mask = w_mask > 0
    r_cw = r_wc.T
    return PnPResult(
        pose=Pose(-matvec(r_cw, t_wc), quat.from_matrix(r_cw)),
        inlier_mask=inlier_mask,
        inlier_count=psum_if(inlier_mask.sum(), group),
        chi2=s.chi2,
    )
