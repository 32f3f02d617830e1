#!/usr/bin/env python3
"""Which order of operations torch.linalg.solve_ex follows for PnP's 6x6
damped systems on the card: the systems (H + lambda I, -g) that the plain
PnP solve (lvt_tpu_torch/solver/pnp.py::solve_pnp_plain) hands to
``solve_ex``, recorded on the GPU, and its solutions against float32
emulations (numpy, one rounding per operation; a fused multiply-add
emulated in float64) of LU variants: the pivot column scaled by the
pivot's reciprocal or divided by it, the updates and the triangular
solves with or without fused multiply-adds. The variant that matches
every system is the one csrc/pnp_lm.cu's solve6 implements.

    python3 scripts/torch_pnp_lu_probe.py [--problems 40] [--out DIR]

Run from the root of a checkout on a machine with an NVIDIA GPU; prints one
line per variant (systems matched bit for bit) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

F32 = np.float32


def _fma(a, b, c):
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _sub_mul(c, a, b, fused: bool):
    """c - a b, fused or rounded twice."""
    return _fma(-a, b, c) if fused else F32(c - F32(a * b))


def lu_solve(a, b, scale: str, fused: bool, diag: str):
    """One 6x6 system by LU with partial pivoting (the first row of
    largest magnitude), row swaps applied to b as they happen: the column
    below the pivot ``scale``d ("rcp": times the pivot's reciprocal;
    "div": divided by it), updates and both triangular solves ``fused``,
    the back substitution's diagonal ``diag`` ("div" or "rcp")."""
    a, b, n = a.astype(F32).copy(), b.astype(F32).copy(), a.shape[0]
    for k in range(n):
        p = k + int(np.argmax(np.abs(a[k:, k])))
        a[[k, p]], b[[k, p]] = a[[p, k]], b[[p, k]]
        r = F32(F32(1) / a[k, k])
        for i in range(k + 1, n):
            a[i, k] = F32(a[i, k] * r) if scale == "rcp" else F32(a[i, k] / a[k, k])
            for j in range(k + 1, n):
                a[i, j] = _sub_mul(a[i, j], a[i, k], a[k, j], fused)
            b[i] = _sub_mul(b[i], a[i, k], b[k], fused)
    for k in range(n - 1, -1, -1):
        b[k] = (F32(b[k] / a[k, k]) if diag == "div"
                else F32(b[k] * F32(F32(1) / a[k, k])))
        for i in range(k):
            b[i] = _sub_mul(b[i], a[i, k], b[k], fused)
    return b


def record(n_problems: int):
    """(A, B, X): the systems solve_pnp_plain passes to solve_ex over
    ``n_problems`` synthetic problems of 1024 points (tests/
    test_torch_cuda.py's generator) and solve_ex's solutions."""
    from test_torch_cuda import PNP_CAM, _pnp_problem

    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import pnp

    seen, real = [], torch.linalg.solve_ex

    def solve_ex(a, b, *args, **kw):
        out = real(a, b, *args, **kw)
        seen.append((a.cpu().numpy(), b.cpu().numpy(), out[0].cpu().numpy()))
        return out

    args = _pnp_problem(np.random.RandomState(0), n_problems, 1024,
                        torch.device("cuda"))
    torch.linalg.solve_ex = solve_ex
    try:
        for i in range(n_problems):
            pnp.solve_pnp_plain(Pose(args[0][i], args[1][i]),
                                *(x[i] for x in args[2:]), **PNP_CAM)
    finally:
        torch.linalg.solve_ex = real
    return tuple(np.stack(x) for x in zip(*seen))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--problems", type=int, default=40)
    p.add_argument("--out", help="also save the systems (npz) there")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    a, b, x = record(args.problems)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "pnp_lu_systems.npz"), A=a, B=b, X=x)
    batched = torch.linalg.solve_ex(torch.from_numpy(a).cuda(),
                                    torch.from_numpy(b).cuda())[0].cpu()
    print(f"{len(a)} systems; solve_ex over all of them in one batched call "
          f"equal to the single calls: "
          f"{int((batched.numpy() == x).all(1).sum())} of {len(a)}")
    for scale, fused, diag in itertools.product(("rcp", "div"), (True, False),
                                                ("div", "rcp")):
        same = sum(np.array_equal(lu_solve(a[t], b[t], scale, fused, diag),
                                  x[t]) for t in range(len(a)))
        print(f"scale {scale}, fused {fused}, diagonal {diag}: {same} of "
              f"{len(a)} bit-equal to solve_ex")
    return 0


if __name__ == "__main__":
    sys.exit(main())
