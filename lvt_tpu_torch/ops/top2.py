"""Kernel T: masked dual top-2 of Hamming distances under radius or
row-window masks, straight from descriptors, for one stream or a batch of
streams in one launch. In the row modes the kernel computes each query's
window of target rows from its keypoint (lvt_tpu's ``row_match``), and the
dual row mode serves two query sets over the same window in one launch
(lvt_tpu's one row Hamming matrix for both row matches).

Port of lvt_tpu/ops/top2_pallas.py (``masked_dual_top2``) together with the
Hamming matrix it reads (``ops/hamming.py::hamming_matrix``, XLA's work in
lvt_tpu). The kernel is the custom op ``lvt_tpu_torch::hamming_top2`` over
a leading stream axis S:

* CUDA: one launch of the hand-written kernel ``csrc/top2.cu`` for all S
  streams (grid (row blocks, S)); it computes each candidate's distance in
  registers, so the [M, K] matrix never exists;
* CPU: :func:`hamming_top2_plain` over the stream axis: the matrix, then
  :func:`masked_dual_top2_plain`, which materialises the candidate masks
  and runs ``hamming.masked_top2_int`` (the XLA path of ops/matching.py);
* fake (meta) tensors: the output shapes;
* ``torch.func.vmap``: a batching rule that folds vmap's batch axis into
  the stream axis, so the vmapped multi-stream step (parallel/
  multistream.py, lvt_tpu's ``jax.vmap(track_features)``) reaches the
  kernel once for all streams. A ``data_ptr()`` launch cannot run under
  vmap: a batched tensor has no storage of its own.

:func:`hamming_top2` is the single-stream call (S = 1) every site uses.
"""

from __future__ import annotations

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.ops import hamming

COL_BITS = 11
MAX_K = 1 << COL_BITS   # keys are d << 11 | col, so K <= 2048
_MODES = {"dual": 0, "single": 1, "row": 2, "row_dual": 3}
ROW_MODES = (_MODES["row"], _MODES["row_dual"])


def row_window(q_kp, vertical_radius: float, img_rows: float):
    """Each query's window of target rows [..., M] (lo, hi): floor(y) -+ r
    clamped to the image, as lvt_tpu's ``row_match`` computes it
    (lvt_tpu/ops/matching.py:189-191)."""
    y = torch.floor(q_kp[..., 1])
    return (torch.clamp(y - vertical_radius, min=0.0),
            torch.clamp(y + vertical_radius, max=float(img_rows)))


def _masks(q_meta, q_valid, t_meta, t_valid, q_excl, q_incl, r2a, r2b,
           row_mode, row_radius, img_rows):
    if row_mode:
        lo, hi = row_window(q_meta, row_radius, img_rows)
        y_r = t_meta[..., None, :, 1]
        inside = (t_valid[..., None, :] & (y_r >= lo[..., :, None])
                  & (y_r <= hi[..., :, None]))
        ma = (q_valid & ~q_excl)[..., :, None] & inside
        return ma, (ma if q_incl is None
                    else (q_valid & q_incl)[..., :, None] & inside)
    base = q_valid[..., :, None] & t_valid[..., None, :]
    diff = t_meta[..., None, :, :] - q_meta[..., :, None, :]
    dr2 = (diff * diff).sum(dim=-1)
    ma = base & (dr2 < r2a)
    return ma, (ma if r2b == r2a else base & (dr2 < r2b))


def masked_dual_top2_plain(dist, q_meta, q_valid, t_meta, t_valid,
                           q_excl=None, q_incl=None, *, r2a: float = 0.0,
                           r2b: float = 0.0, row_mode: bool = False,
                           row_radius: float = 0.0, img_rows: float = 0.0):
    """The top-2 half of the plain version, over a distance matrix
    [..., M, K] int32 (lvt_tpu's ``masked_dual_top2`` semantics). Row
    mode: ``q_meta`` holds the queries' keypoints, whose windows are
    :func:`row_window`'s; the first predicate's queries are ``q_valid &
    ~q_excl``, the second's ``q_valid & q_incl`` (the first's with
    ``q_incl`` None)."""
    ma, mb = _masks(q_meta, q_valid, t_meta, t_valid, q_excl, q_incl, r2a,
                    r2b, row_mode, row_radius, img_rows)
    out_a = hamming.masked_top2_int(dist, ma)
    out_b = out_a if mb is ma else hamming.masked_top2_int(dist, mb)
    return out_a, out_b


def hamming_top2_plain(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                       q_excl=None, q_incl=None, **kw):
    """Plain version of kernel T: the Hamming matrix, then the masked
    dual top-2 over it (:func:`masked_dual_top2_plain`'s keywords). Any
    leading axes (streams) broadcast."""
    return masked_dual_top2_plain(
        hamming.hamming_matrix(q_desc, t_desc), q_meta, q_valid, t_meta,
        t_valid, q_excl, q_incl, **kw)


def hamming_top2_plain_batched(*args, **kw):
    """The batched launch's reference: :func:`hamming_top2_plain` on each
    stream of [S, ...] tensors in turn, the results stacked."""
    outs = [hamming_top2_plain(*xs, **kw) for xs in zip(*args)]
    return tuple(tuple(torch.stack([o[p][i] for o in outs]) for i in range(4))
                 for p in range(2))


def _pack(out_a, out_b):
    """((d1, d2, best, n_cand) x 2 predicates) -> the kernel's outputs:
    fout [..., 2 (d1, d2), 2 (predicate), M] f32 and iout [..., 2 (best,
    n_cand), 2, M] int64."""
    def two(i):
        return torch.stack([out_a[i], out_b[i]], dim=-2)
    return (torch.stack([two(0), two(1)], dim=-3),
            torch.stack([two(2), two(3)], dim=-3))


def _unpack(fout, iout):
    return ((fout[..., 0, 0, :], fout[..., 1, 0, :], iout[..., 0, 0, :],
             iout[..., 1, 0, :]),
            (fout[..., 0, 1, :], fout[..., 1, 1, :], iout[..., 0, 1, :],
             iout[..., 1, 1, :]))


@torch.library.custom_op("lvt_tpu_torch::hamming_top2", mutates_args=(),
                         device_types="cuda")
def hamming_top2_op(q_desc: torch.Tensor, t_desc: torch.Tensor,
                    q_meta: torch.Tensor, q_valid: torch.Tensor,
                    t_meta: torch.Tensor, t_valid: torch.Tensor,
                    q_excl: torch.Tensor, q_incl: torch.Tensor, r2a: float,
                    r2b: float, row_radius: float, img_rows: float,
                    mode: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel T over S streams: q_desc [S, M, 8] int32, t_desc [S, K, 8]
    int32, q_meta [S, M, 2] f32 (coordinates; the keypoints in the row
    modes), q_valid [S, M] bool, t_meta [S, K, 2] f32, t_valid [S, K]
    bool, q_excl [S, M] bool (row modes: the first set is q_valid &
    ~q_excl; else [S, 0]), q_incl [S, M] bool (mode 3: the second set is
    q_valid & q_incl; else [S, 0]); mode 0 (two radii r2a, r2b), 1 (one
    radius), 2 (row window floor(y) -+ row_radius within [0, img_rows])
    or 3 (the row window, two query sets). Returns fout [S, 2, 2, M] f32
    and iout [S, 2, 2, M] int64 (see :func:`_pack`).

    CUDA: one launch of ``csrc/top2.cu`` for all streams (replaces
    top2_pallas.py ``_top2_kernel`` and the XOR + popcount in front of it;
    a block of 8 warps owns 4 query rows of one stream, its warps split the
    K columns, and each candidate's distance is 8 XOR + popcount pairs in
    registers)."""
    s, m = q_desc.shape[0], q_desc.shape[1]
    k = t_desc.shape[1]
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the key packing bound {MAX_K}")
    dev = q_desc.device
    words = hamming.DESC_WORDS
    kernels.require(q_desc, "q_desc", torch.int32, (s, m, words), dev)
    kernels.require(t_desc, "t_desc", torch.int32, (s, k, words), dev)
    kernels.require(q_meta, "q_meta", torch.float32, (s, m, 2), dev)
    kernels.require(q_valid, "q_valid", torch.bool, (s, m), dev)
    kernels.require(t_meta, "t_meta", torch.float32, (s, k, 2), dev)
    kernels.require(t_valid, "t_valid", torch.bool, (s, k), dev)
    kernels.require(q_excl, "q_excl", torch.bool,
                    (s, m if mode in ROW_MODES else 0), dev)
    kernels.require(q_incl, "q_incl", torch.bool,
                    (s, m if mode == _MODES["row_dual"] else 0), dev)
    # rows are 32 bytes, so every stream's slice is aligned with the base
    for t, name in ((q_desc, "q_desc"), (t_desc, "t_desc")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte words; "
                             "the tensor must start on a 16-byte boundary")
    fout = torch.empty((s, 2, 2, m), dtype=torch.float32, device=dev)
    iout = torch.empty((s, 2, 2, m), dtype=torch.int64, device=dev)
    err = kernels.lib().lvt_hamming_top2(
        q_desc.data_ptr(), t_desc.data_ptr(), q_meta.data_ptr(),
        q_valid.data_ptr(), t_meta.data_ptr(), t_valid.data_ptr(),
        q_excl.data_ptr(), q_incl.data_ptr(), s, m, k, float(r2a),
        float(r2b), float(row_radius), float(img_rows), int(mode),
        fout.data_ptr(), iout.data_ptr(), kernels.stream_ptr(q_desc))
    kernels.check(err, "hamming_top2")
    hamming_top2.launches += 1
    return fout, iout


@hamming_top2_op.register_kernel("cpu")
def _hamming_top2_cpu(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                      q_excl, q_incl, r2a, r2b, row_radius, img_rows, mode):
    row = mode in ROW_MODES
    return _pack(*hamming_top2_plain(
        q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
        q_excl if row else None,
        q_incl if mode == _MODES["row_dual"] else None, r2a=r2a, r2b=r2b,
        row_mode=row, row_radius=row_radius, img_rows=img_rows))


@hamming_top2_op.register_fake
def _hamming_top2_fake(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                       q_excl, q_incl, *scalars):
    shape = (q_desc.shape[0], 2, 2, q_desc.shape[1])
    return (q_desc.new_empty(shape, dtype=torch.float32),
            q_desc.new_empty(shape, dtype=torch.int64))


def _hamming_top2_vmap(info, in_dims, *args):
    """Batching rule: vmap's axis B and the op's stream axis S fold into
    one axis of B * S streams (``kernels.fold_streams``), and the op runs
    once; the outputs unfold to [B, S, ...]."""
    b = info.batch_size
    flat = kernels.fold_streams(info, in_dims[:8], args[:8])
    fout, iout = hamming_top2_op(*flat, *args[8:])
    return ((fout.view(b, -1, *fout.shape[1:]),
             iout.view(b, -1, *iout.shape[1:])), (0, 0))


hamming_top2_op.register_vmap(_hamming_top2_vmap)


def _op_args(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, q_excl,
             q_incl, *, r2a: float = 0.0, r2b: float = 0.0,
             row_mode: bool = False, row_radius: float = 0.0,
             img_rows: float = 0.0) -> tuple:
    """The op's arguments for one call's tensors and keywords (a leading
    stream axis or not): the mode, and the row masks as the mode reads
    them ([..., 0] where it reads none)."""
    if row_mode:
        if q_excl is None:
            raise ValueError("row mode needs the exclusion mask q_excl")
        mode = _MODES["row" if q_incl is None else "row_dual"]
    else:
        mode = _MODES["single" if r2b == r2a else "dual"]
    none = q_valid[..., :0]
    return (q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
            none if q_excl is None else q_excl,
            none if q_incl is None else q_incl, float(r2a), float(r2b),
            float(row_radius), float(img_rows), mode)


def hamming_top2_batched(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                         q_excl=None, q_incl=None, **kw):
    """Kernel T over [S, ...] inputs (the shapes of :func:`hamming_top2`
    with a leading stream axis), one launch on the card; returns the same
    two 4-tuples with [S, M] leaves."""
    return _unpack(*hamming_top2_op(*_op_args(
        q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, q_excl, q_incl,
        **kw)))


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q_desc: expected a CUDA tensor, got {t.device}")


def hamming_top2_packed(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                        q_excl=None, q_incl=None, **kw):
    """:func:`hamming_top2` as the op writes it, (fout [2, 2, M] f32, iout
    [2, 2, M] int64) in :func:`_pack`'s layout: what the map match's
    acceptance op and local BA's observations read (ops/matching.py,
    core/track.py)."""
    _check_device(q_desc)
    one = [None if x is None else x[None]
           for x in (q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                     q_excl, q_incl)]
    fout, iout = hamming_top2_op(*_op_args(*one, **kw))
    return fout[0], iout[0]


def hamming_top2(
    q_desc: torch.Tensor,   # [M, 8] int32 query descriptors
    t_desc: torch.Tensor,   # [K, 8] int32 target descriptors
    q_meta: torch.Tensor,   # [M, 2] f32 query coords (row mode: keypoints)
    q_valid: torch.Tensor,  # [M] bool
    t_meta: torch.Tensor,   # [K, 2] f32 target coords
    t_valid: torch.Tensor,  # [K] bool
    q_excl: torch.Tensor | None = None,  # [M] bool row mode: excluded
    q_incl: torch.Tensor | None = None,  # [M] bool row mode: a second set
    **kw,
):
    """((d1, d2, best, n_cand) under the first predicate, the same under
    the second); d1/d2 f32, best/n_cand int64, each [M]. Keywords: r2a and
    r2b (radius modes; single-radius callers pass r2b == r2a), or
    ``row_mode=True`` with ``row_radius`` and ``img_rows`` (each query's
    window of rows computed from its keypoint; the first set ``q_valid &
    ~q_excl``, the second ``q_valid & q_incl``, or the first again where
    ``q_incl`` is None). The op with S = 1: CPU tensors take the plain
    version, CUDA tensors the kernel (any other device raises), and under
    ``torch.func.vmap`` one launch serves every stream."""
    return _unpack(*hamming_top2_packed(q_desc, t_desc, q_meta, q_valid,
                                        t_meta, t_valid, q_excl, q_incl,
                                        **kw))


hamming_top2.launches = 0
