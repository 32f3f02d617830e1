"""Kernel T: masked dual top-2 of Hamming distances under radius or
row-window masks, straight from descriptors, for one stream or a batch of
streams in one launch.

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
_MODES = {"dual": 0, "single": 1, "row": 2}
ROW_MODE = _MODES["row"]


def _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode):
    base = q_valid[..., :, None] & t_valid[..., None, :]
    if row_mode:
        y_r = t_meta[..., None, :, 1]
        m = base & (y_r >= q_meta[..., :, 0:1]) & (y_r <= q_meta[..., :, 1:2])
        return m, m
    diff = t_meta[..., None, :, :] - q_meta[..., :, None, :]
    dr2 = (diff * diff).sum(dim=-1)
    ma = base & (dr2 < r2a)
    return ma, (ma if r2b == r2a else base & (dr2 < r2b))


def masked_dual_top2_plain(dist, q_meta, q_valid, t_meta, t_valid, *,
                           r2a: float, r2b: float, row_mode: bool = False):
    """The top-2 half of the plain version, over a distance matrix
    [..., M, K] int32 (lvt_tpu's ``masked_dual_top2`` semantics)."""
    ma, mb = _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode)
    out_a = hamming.masked_top2_int(dist, ma)
    out_b = out_a if mb is ma else hamming.masked_top2_int(dist, mb)
    return out_a, out_b


def hamming_top2_plain(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, *,
                       r2a: float, r2b: float, row_mode: bool = False):
    """Plain version of kernel T: the Hamming matrix, then the masked
    dual top-2 over it. Any leading axes (streams) broadcast."""
    return masked_dual_top2_plain(
        hamming.hamming_matrix(q_desc, t_desc), q_meta, q_valid, t_meta,
        t_valid, r2a=r2a, r2b=r2b, row_mode=row_mode)


def hamming_top2_plain_batched(q_desc, t_desc, q_meta, q_valid, t_meta,
                               t_valid, *, r2a: float, r2b: float,
                               row_mode: bool = False):
    """The batched launch's reference: :func:`hamming_top2_plain` on each
    stream of [S, ...] inputs in turn, the results stacked."""
    outs = [hamming_top2_plain(*args, r2a=r2a, r2b=r2b, row_mode=row_mode)
            for args in zip(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid)]
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
                    t_meta: torch.Tensor, t_valid: torch.Tensor, r2a: float,
                    r2b: float, mode: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel T over S streams: q_desc [S, M, 8] int32, t_desc [S, K, 8]
    int32, q_meta [S, M, 2] f32 (coordinates, or the (lo, hi) row window),
    q_valid [S, M] bool, t_meta [S, K, 2] f32, t_valid [S, K] bool; mode 0
    (two radii), 1 (one radius) or 2 (row window). Returns fout [S, 2, 2,
    M] f32 and iout [S, 2, 2, M] int64 (see :func:`_pack`).

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
    # rows are 32 bytes, so every stream's slice is aligned with the base
    for t, name in ((q_desc, "q_desc"), (t_desc, "t_desc")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte words; "
                             "the tensor must start on a 16-byte boundary")
    fout = torch.empty((s, 2, 2, m), dtype=torch.float32, device=dev)
    iout = torch.empty((s, 2, 2, m), dtype=torch.int64, device=dev)
    err = kernels.lib().lvt_hamming_top2(
        q_desc.data_ptr(), t_desc.data_ptr(), q_meta.data_ptr(),
        q_valid.data_ptr(), t_meta.data_ptr(), t_valid.data_ptr(), s, m, k,
        float(r2a), float(r2b), int(mode), fout.data_ptr(), iout.data_ptr(),
        kernels.stream_ptr(q_desc))
    kernels.check(err, "hamming_top2")
    hamming_top2.launches += 1
    return fout, iout


@hamming_top2_op.register_kernel("cpu")
def _hamming_top2_cpu(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, r2a,
                      r2b, mode):
    return _pack(*hamming_top2_plain(q_desc, t_desc, q_meta, q_valid, t_meta,
                                     t_valid, r2a=r2a, r2b=r2b,
                                     row_mode=mode == ROW_MODE))


@hamming_top2_op.register_fake
def _hamming_top2_fake(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, r2a,
                       r2b, mode):
    shape = (q_desc.shape[0], 2, 2, q_desc.shape[1])
    return (q_desc.new_empty(shape, dtype=torch.float32),
            q_desc.new_empty(shape, dtype=torch.int64))


def _hamming_top2_vmap(info, in_dims, *args):
    """Batching rule: vmap's axis B and the op's stream axis S fold into
    one axis of B * S streams (``kernels.fold_streams``), and the op runs
    once; the outputs unfold to [B, S, ...]."""
    b = info.batch_size
    flat = kernels.fold_streams(info, in_dims[:6], args[:6])
    fout, iout = hamming_top2_op(*flat, *args[6:])
    return ((fout.view(b, -1, *fout.shape[1:]),
             iout.view(b, -1, *iout.shape[1:])), (0, 0))


hamming_top2_op.register_vmap(_hamming_top2_vmap)


def _mode(r2a, r2b, row_mode) -> int:
    return _MODES["row" if row_mode else ("single" if r2b == r2a else "dual")]


def hamming_top2_batched(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid,
                         *, r2a: float, r2b: float, row_mode: bool = False):
    """Kernel T over [S, ...] inputs (the shapes of :func:`hamming_top2`
    with a leading stream axis), one launch on the card; returns the same
    two 4-tuples with [S, M] leaves."""
    return _unpack(*hamming_top2_op(q_desc, t_desc, q_meta, q_valid, t_meta,
                                    t_valid, float(r2a), float(r2b),
                                    _mode(r2a, r2b, row_mode)))


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q_desc: expected a CUDA tensor, got {t.device}")


def hamming_top2_packed(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, *,
                        r2a: float, r2b: float, row_mode: bool = False):
    """:func:`hamming_top2` as the op writes it, (fout [2, 2, M] f32, iout
    [2, 2, M] int64) in :func:`_pack`'s layout: what the map match's
    acceptance op reads (ops/matching.py)."""
    _check_device(q_desc)
    fout, iout = hamming_top2_op(q_desc[None], t_desc[None], q_meta[None],
                                 q_valid[None], t_meta[None], t_valid[None],
                                 float(r2a), float(r2b),
                                 _mode(r2a, r2b, row_mode))
    return fout[0], iout[0]


def hamming_top2(
    q_desc: torch.Tensor,   # [M, 8] int32 query descriptors
    t_desc: torch.Tensor,   # [K, 8] int32 target descriptors
    q_meta: torch.Tensor,   # [M, 2] f32 query coords, or (lo, hi) in row mode
    q_valid: torch.Tensor,  # [M] bool
    t_meta: torch.Tensor,   # [K, 2] f32 target coords
    t_valid: torch.Tensor,  # [K] bool
    *,
    r2a: float,
    r2b: float,
    row_mode: bool = False,
):
    """((d1, d2, best, n_cand) under r2a, the same under r2b); d1/d2 f32,
    best/n_cand int64, each [M]. Single-radius callers pass r2b == r2a;
    row mode ignores both radii. The op with S = 1: CPU tensors take the
    plain version, CUDA tensors the kernel (any other device raises), and
    under ``torch.func.vmap`` one launch serves every stream."""
    return _unpack(*hamming_top2_packed(q_desc, t_desc, q_meta, q_valid,
                                        t_meta, t_valid, r2a=r2a, r2b=r2b,
                                        row_mode=row_mode))


hamming_top2.launches = 0
