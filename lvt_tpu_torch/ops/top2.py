"""Kernel T: masked dual top-2 of Hamming distances under radius or
row-window masks, straight from descriptors.

Port of lvt_tpu/ops/top2_pallas.py (``masked_dual_top2``) together with the
Hamming matrix it reads (``ops/hamming.py::hamming_matrix``, XLA's work in
lvt_tpu). CUDA tensors go through the hand-written kernel ``csrc/top2.cu``,
which computes each candidate's distance in registers so the [M, K] matrix
never exists; CPU tensors through :func:`hamming_top2_plain`: the matrix,
then :func:`masked_dual_top2_plain`, which materialises the candidate masks
and runs ``hamming.masked_top2_int`` (the XLA path of ops/matching.py).
"""

from __future__ import annotations

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.ops import hamming

COL_BITS = 11
MAX_K = 1 << COL_BITS   # keys are d << 11 | col, so K <= 2048
_MODES = {"dual": 0, "single": 1, "row": 2}


def _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode):
    base = q_valid[:, None] & t_valid[None, :]
    if row_mode:
        y_r = t_meta[:, 1]
        m = base & (y_r[None, :] >= q_meta[:, 0:1]) & (y_r[None, :] <= q_meta[:, 1:2])
        return m, m
    diff = t_meta[None, :, :] - q_meta[:, None, :]
    dr2 = (diff * diff).sum(dim=-1)
    ma = base & (dr2 < r2a)
    return ma, (ma if r2b == r2a else base & (dr2 < r2b))


def masked_dual_top2_plain(dist, q_meta, q_valid, t_meta, t_valid, *,
                           r2a: float, r2b: float, row_mode: bool = False):
    """The top-2 half of the plain version, over a distance matrix
    [M, K] int32 (lvt_tpu's ``masked_dual_top2`` semantics)."""
    ma, mb = _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode)
    out_a = hamming.masked_top2_int(dist, ma)
    out_b = out_a if mb is ma else hamming.masked_top2_int(dist, mb)
    return out_a, out_b


def hamming_top2_plain(q_desc, t_desc, q_meta, q_valid, t_meta, t_valid, *,
                       r2a: float, r2b: float, row_mode: bool = False):
    """Plain version of kernel T: the Hamming matrix, then the masked
    dual top-2 over it."""
    return masked_dual_top2_plain(
        hamming.hamming_matrix(q_desc, t_desc), q_meta, q_valid, t_meta,
        t_valid, r2a=r2a, r2b=r2b, row_mode=row_mode)


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
    row mode ignores both radii.

    CUDA: ``csrc/top2.cu`` (replaces top2_pallas.py ``_top2_kernel`` and
    the XOR + popcount in front of it; a block of 8 warps owns 4 query
    rows, its warps split the K columns, and each candidate's distance is
    8 XOR + popcount pairs in registers). CPU: the plain version."""
    if q_desc.device.type == "cpu":
        return hamming_top2_plain(q_desc, t_desc, q_meta, q_valid, t_meta,
                                  t_valid, r2a=r2a, r2b=r2b,
                                  row_mode=row_mode)
    m, k = q_desc.shape[0], t_desc.shape[0]
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the key packing bound {MAX_K}")
    dev = q_desc.device
    words = hamming.DESC_WORDS
    kernels.require(q_desc, "q_desc", torch.int32, (m, words), dev)
    kernels.require(t_desc, "t_desc", torch.int32, (k, words), dev)
    kernels.require(q_meta, "q_meta", torch.float32, (m, 2), dev)
    kernels.require(q_valid, "q_valid", torch.bool, (m,), dev)
    kernels.require(t_meta, "t_meta", torch.float32, (k, 2), dev)
    kernels.require(t_valid, "t_valid", torch.bool, (k,), dev)
    for t, name in ((q_desc, "q_desc"), (t_desc, "t_desc")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte words; "
                             "the tensor must start on a 16-byte boundary")
    mode = "row" if row_mode else ("single" if r2b == r2a else "dual")
    fout = torch.empty((2, 2, m), dtype=torch.float32, device=dev)
    iout = torch.empty((2, 2, m), dtype=torch.int64, device=dev)
    err = kernels.lib().lvt_hamming_top2(
        q_desc.data_ptr(), t_desc.data_ptr(), q_meta.data_ptr(),
        q_valid.data_ptr(), t_meta.data_ptr(), t_valid.data_ptr(), m, k,
        float(r2a), float(r2b), _MODES[mode], fout.data_ptr(),
        iout.data_ptr(), kernels.stream_ptr(q_desc))
    kernels.check(err, "hamming_top2")
    hamming_top2.launches += 1
    return ((fout[0, 0], fout[1, 0], iout[0, 0], iout[1, 0]),
            (fout[0, 1], fout[1, 1], iout[0, 1], iout[1, 1]))


hamming_top2.launches = 0
