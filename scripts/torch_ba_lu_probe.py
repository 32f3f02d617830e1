#!/usr/bin/env python3
"""Which order of operations local BA's reduced solve follows on the card,
and whether the kernel of csrc/ba.cu matches the plain version.

The plain version (lvt_tpu_torch/solver/bundle.py::refine_structure_plain)
solves the reduced camera system of each LM iteration with ``_solve64``:
cuBLAS's batched LU (``lu_factor_ex`` of the system beside the identity),
then two triangular solves (``solve_triangular``), all in float64. On BA
windows of KITTI 00's geometry (tests/test_torch_cuda.py::_ba_problem)
this script records every such system on the GPU with the LU factors, the
pivots, the forward solve's y and the solution x, and emulates variants of
the same steps exactly (a fused multiply-add rounded once, through Python's
fractions): the LU (LAPACK's getf2, right-looking: the pivot column scaled
by the pivot's reciprocal or divided by it, the trailing update fused or
rounded twice; or left-looking, each entry's dot product first), the unit
lower solve and the upper solve (column by column, fused or not, a dot
product per row, or by blocks of rows). It prints per variant how many
systems it matches bit for bit, and per output how many windows
``lvt_tpu_torch::ba_refine`` matches. On the H100 (torch 2.11, CUDA 12.8)
the LU is getf2's with the reciprocal and fused updates, and both
triangular solves are "col" at n = 18 (F = 3) and "block8" at n = 24 to
48 (F = 4 to 8): csrc/ba.cu::lu_solve.

    python3 scripts/torch_ba_lu_probe.py [--windows 6] [--f 4] [--dump FILE]
    python3 scripts/torch_ba_lu_probe.py --analyze FILE   # anywhere, no GPU

Run from the root of a checkout on a machine with an NVIDIA GPU (the first
form); prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def fma(a: float, b: float, c: float) -> float:
    """a b + c rounded once to float64."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def sub_mul(c, a, b, fused: bool) -> float:
    """c - a b, fused or rounded twice."""
    return fma(-a, b, c) if fused else c - a * b


def lu(a, scale: str, fused: bool, order: str):
    """LU with partial pivoting (the first row of largest magnitude) of
    ``a``: (packed L\\U, pivots). ``order`` "right": getf2's column by column
    updates of the trailing block; "left": each entry's sum over the
    earlier columns as one dot product (accumulated fused if ``fused``),
    then subtracted."""
    a = [list(map(float, r)) for r in a]
    n = len(a)
    piv = []
    for k in range(n):
        if order == "left":
            for i in range(k, n):          # column k of U's row k .. L
                s = 0.0
                for j in range(k):
                    s = fma(a[i][j], a[j][k], s) if fused else s + a[i][j] * a[j][k]
                a[i][k] = a[i][k] - s
        col = [abs(a[i][k]) for i in range(k, n)]
        p = k + int(np.argmax(col))
        piv.append(p)
        a[k], a[p] = a[p], a[k]
        if order == "left":
            for j in range(k + 1, n):      # row k of U
                s = 0.0
                for i in range(k):
                    s = fma(a[k][i], a[i][j], s) if fused else s + a[k][i] * a[i][j]
                a[k][j] = a[k][j] - s
        r = 1.0 / a[k][k]
        for i in range(k + 1, n):
            a[i][k] = a[i][k] * r if scale == "rcp" else a[i][k] / a[k][k]
        if order == "right":
            for i in range(k + 1, n):
                for j in range(k + 1, n):
                    a[i][j] = sub_mul(a[i][j], a[i][k], a[k][j], fused)
    return np.array(a), np.array(piv)


def _block_dot(a, b, i, lo, hi) -> float:
    """sum_{k in [lo, hi)} a_ik b_k, fused, k ascending."""
    s = 0.0
    for k in range(lo, hi):
        s = fma(a[i][k], b[k], s)
    return s


def _blocks(n: int, how: str) -> list:
    """The row blocks of a "blockN" solve, top to bottom: N rows each from
    the top, or with a trailing "b" from the bottom."""
    nb = int(how[5:].rstrip("b"))
    if how.endswith("b"):
        return [(max(0, e - nb), e) for e in range(n, 0, -nb)][::-1]
    return [(bs, min(n, bs + nb)) for bs in range(0, n, nb)]


def lower_solve(l, b, how: str):
    """y = L^-1 b for unit lower L: "col" b_i -= b_k l_ik column by column
    (fused), "colmul" the same rounded twice, "dot" each row's dot product
    (fused) subtracted, "blockN" by blocks of N rows (``_blocks``): "col"
    within a block, then each later row less the block's dot product
    (fused, ascending)."""
    b = list(map(float, b))
    n = len(b)
    if how.startswith("block"):
        for bs, be in _blocks(n, how):
            for k in range(bs, be):
                for i in range(k + 1, be):
                    b[i] = fma(-b[k], l[i][k], b[i])
            for i in range(be, n):
                b[i] = b[i] - _block_dot(l, b, i, bs, be)
        return np.array(b)
    if how == "dot":
        for i in range(n):
            s = 0.0
            for k in range(i):
                s = fma(l[i][k], b[k], s)
            b[i] = b[i] - s
        return np.array(b)
    for k in range(n):
        for i in range(k + 1, n):
            b[i] = sub_mul(b[i], b[k], l[i][k], how == "col")
    return np.array(b)


def upper_solve(u, b, how: str):
    """x = U^-1 b: "col" x_k = b_k / u_kk then b_i -= x_k u_ik, k
    descending (fused); "colrcp" x_k = b_k (1 / u_kk); "colmul" rounded
    twice; "dot" each row's dot product of the later x (fused, j
    ascending) subtracted, then divided; "blockN" by the blocks of N rows
    (``_blocks``), the last first: "col" within a block, then each earlier
    row less the block's dot product (fused, ascending)."""
    b = list(map(float, b))
    n = len(b)
    if how.startswith("block"):
        for bs, be in _blocks(n, how)[::-1]:
            for k in reversed(range(bs, be)):
                b[k] = b[k] / u[k][k]
                for i in range(bs, k):
                    b[i] = fma(-b[k], u[i][k], b[i])
            for i in range(bs):
                b[i] = b[i] - _block_dot(u, b, i, bs, be)
        return np.array(b)
    if how == "dot":
        for i in reversed(range(n)):
            s = 0.0
            for j in range(i + 1, n):
                s = fma(u[i][j], b[j], s)
            b[i] = (b[i] - s) / u[i][i]
        return np.array(b)
    for k in reversed(range(n)):
        b[k] = b[k] * (1.0 / u[k][k]) if how == "colrcp" else b[k] / u[k][k]
        for i in range(k):
            b[i] = sub_mul(b[i], b[k], u[i][k], how != "colmul")
    return np.array(b)


LU_VARIANTS = [("rcp", True, "right"), ("div", True, "right"),
               ("rcp", False, "right"), ("div", False, "right"),
               ("rcp", True, "left"), ("div", True, "left")]
LOWER = ("col", "colmul", "dot", "block4", "block8", "block8b", "block16")
UPPER = ("col", "colrcp", "colmul", "dot", "block4", "block8", "block8b",
         "block16")


def analyze(systems: dict) -> None:
    """Each variant's bit-exact matches over the recorded systems."""
    n_sys = len(systems["a"])
    print(f"{n_sys} systems of size {systems['a'][0].shape[0]}")
    for v in LU_VARIANTS:
        hits = 0
        for a, want, piv in zip(systems["a"], systems["lu"], systems["piv"]):
            got, gp = lu(a, *v)
            hits += bool(np.array_equal(got, want) and np.array_equal(gp, piv))
        print(f"LU {v}: {hits} / {n_sys} bit-equal (factors and pivots)")
    for how in LOWER:
        hits = sum(bool(np.array_equal(lower_solve(np.tril(f, -1), pb, how), y))
                   for f, pb, y in zip(systems["lu"], systems["pb"],
                                       systems["y"]))
        print(f"unit lower solve {how}: {hits} / {n_sys} bit-equal")
    for how in UPPER:
        hits = sum(bool(np.array_equal(upper_solve(np.triu(f), y, how), x))
                   for f, y, x in zip(systems["lu"], systems["y"],
                                      systems["x"]))
        print(f"upper solve {how}: {hits} / {n_sys} bit-equal")


def record(n_windows: int, m: int, device: str, f: int = 4) -> dict:
    """The systems the plain version solves on the card over
    ``n_windows`` BA windows, each with torch's intermediates; and the
    kernel against the plain version on the same windows."""
    import torch

    from lvt_tpu_torch.solver import bundle
    from test_torch_cuda import BA_CAM, _ba_plain, _ba_problem

    systems = {k: [] for k in ("a", "b", "lu", "piv", "pb", "y", "x")}
    real = bundle._solve64

    def probe(a, b):
        a64 = a.double()
        eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
        lu_, pivots, _ = torch.linalg.lu_factor_ex(torch.stack([a64, eye]))
        p, low, up = torch.lu_unpack(lu_[0], pivots[0])
        pb = p.mT @ b.double()[:, None]
        y = torch.linalg.solve_triangular(low, pb, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(up, y, upper=True)[:, 0]
        out = real(a, b)
        if not torch.equal(out, x):
            raise AssertionError("the probe's _solve64 is not the module's")
        for k, v in (("a", a64), ("b", b.double()), ("lu", lu_[0]),
                     ("piv", pivots[0] - 1), ("pb", pb[:, 0]),
                     ("y", y[:, 0]), ("x", x)):
            systems[k].append(v.cpu().numpy())
        return out

    cam = tuple(float(BA_CAM[k]) for k in ("fx", "fy", "cx", "cy",
                                            "baseline"))
    same = {k: 0 for k in ("pos", "chi2", "n_obs", "accepted")}
    bundle._solve64 = probe
    try:
        for i in range(n_windows):
            args = _ba_problem(np.random.RandomState(100 + i), 1, m, device,
                               f=f)
            want = _ba_plain(args)
            bundle._solve64 = real
            got = bundle.ba_refine_op(*args, *cam, 5.991, 6)
            bundle._solve64 = probe
            for k, g, w in zip(same, got, want):
                same[k] += bool(torch.equal(g, w))
    finally:
        bundle._solve64 = real
    print(f"ba_refine against the plain version over {n_windows} windows "
          f"of F = {f}, M = {m}, bit-equal per output: {same}")
    return {k: [np.asarray(x) for x in v] for k, v in systems.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--f", type=int, default=4, help="window poses")
    ap.add_argument("--dump", help="save the recorded systems (npz)")
    ap.add_argument("--analyze", help="analyze a saved dump, no GPU")
    ap.add_argument("--max-systems", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cpu: LAPACK's solve and the plain op, a check of "
                         "this script")
    args = ap.parse_args(argv)
    if args.analyze:
        d = np.load(args.analyze)
        n = len([k for k in d.files if k.startswith("a_")])
        systems = {k: [d[f"{k}_{i}"] for i in range(n)]
                   for k in ("a", "b", "lu", "piv", "pb", "y", "x")}
    else:
        if args.device == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip(), flush=True)
        systems = record(args.windows, args.m, args.device, args.f)
        if args.dump:
            os.makedirs(os.path.dirname(args.dump) or ".", exist_ok=True)
            np.savez(args.dump, **{f"{k}_{i}": x for k, v in systems.items()
                                   for i, x in enumerate(v)})
    systems = {k: v[:args.max_systems] for k, v in systems.items()}
    analyze(systems)
    return 0


if __name__ == "__main__":
    sys.exit(main())
