#!/usr/bin/env python3
"""Where PnP's fused solve spends its time: the SM clock at each phase
boundary of ``csrc/pnp_lm.cu``'s ``pnp_solve_kernel``, in every block.

The script writes two copies of a ``pnp_lm.cu`` (by default this tree's;
``--source`` names another, beside its ``lm_common.cuh``) into
``build/pnp_clocks/``: one as it is, and one that defines the kernel's
``PNP_CLOCK(slot, kind)`` markers as a block barrier and a ``clock64()``
stamp by thread 0, and ``PNP_CLOCK_WARP(slot, kind)`` (inside warp 0's
step) as thread 0's stamp alone. It builds them with nvcc for sm_90a
(ptxas's registers and spills printed) and launches them on PnP problems
as the tracking step poses them (``tests/test_torch_cuda.py``'s: points
4-80 m deep, 0.5 px noise, an eighth of them outliers, a tenth masked) at
M = 1024 and 4096 points and S = 1 and 8 streams, and at M = 1024, S = 8
with half the points masked (weight 0: unmatched map points).

It prints, per shape: the plain copy's device time (the mean of 200
launches, ``chip_smoke.device_ms``) and whether its outputs equal this
tree's plain version (``pnp.solve_pnp_plain``, stream by stream); then
the instrumented copy's cycles per kind of phase, summed over the solve
in each block (the median and the largest over the blocks) with the
number of such phases: the point stage, the sweeps over the points, the
block reductions, the 6x6 solve, the retraction, the accept tests (with
each pass's start and the result), and the whole.

    python3 scripts/torch_pnp_clocks.py [--source DIR/pnp_lm.cu] [--tag T]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc;
prints the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]
CSRC = ROOT / "lvt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "pnp_clocks"
SLOTS = 96
KINDS = ("stage", "sweeps", "reductions", "solve: LU", "retraction",
         "accept", "end", "solve: back substitution")
STAMPS = ('__device__ long long* g_clk;\n'
          '#define PNP_CLOCK_REC(slot, kind) (g_clk[(blockIdx.x * 96ll + '
          '(slot)) * 2] = (kind), g_clk[(blockIdx.x * 96ll + (slot)) * 2 + 1]'
          ' = clock64())\n'
          '#define PNP_CLOCK(slot, kind) do { __syncthreads(); '
          'if (threadIdx.x == 0) PNP_CLOCK_REC(slot, kind); } while (0)\n'
          '#define PNP_CLOCK_WARP(slot, kind) do { if (threadIdx.x == 0) '
          'PNP_CLOCK_REC(slot, kind); } while (0)\n')
SET_CLK = ('\nextern "C" int lvt_pnp_set_clk(long long* p) {\n'
           '  return static_cast<int>(cudaMemcpyToSymbol(g_clk, &p, '
           'sizeof(p)));\n}\n')
# (M, S, the share of the points with weight 0)
SHAPES = ((1024, 1, 0.1), (1024, 8, 0.1), (4096, 1, 0.1), (4096, 8, 0.1),
          (1024, 8, 0.5))


def source(path: Path, clocks: bool) -> str:
    src = path.read_text()
    if clocks:
        head = '#include "lm_common.cuh"\n'
        assert head in src
        src = src.replace(head, head + STAMPS, 1) + SET_CLK
    return src


def build(tag: str, src: str, include: Path) -> tuple[ctypes.CDLL, str]:
    from lvt_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(src)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                          str(include), "-Xptxas", "-v", "-shared", "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.lvt_pnp_solve.argtypes = kernels._SIGNATURES["lvt_pnp_solve"]
    return lib, " ".join(kernels.ptxas_report("pnp_solve_kernel",
                                              res.stderr + res.stdout))


def launcher(lib, args, cam):
    """A function that launches ``lib``'s solve on (t, q, points, obs,
    weights) into fixed outputs (``pnp.pnp_solve_op``'s), and the
    outputs."""
    import torch

    from lvt_tpu_torch import kernels

    t, q, pts, obs, w = args
    s, m = pts.shape[:2]
    f32 = dict(dtype=torch.float32, device=pts.device)
    scratch = torch.empty((s, m), **f32)
    outs = (torch.empty((s, 3), **f32), torch.empty((s, 4), **f32),
            torch.empty((s, m), dtype=torch.bool, device=pts.device),
            torch.empty((s,), dtype=torch.int64, device=pts.device),
            torch.empty((s,), **f32))

    def run():
        err = lib.lvt_pnp_solve(
            t.data_ptr(), q.data_ptr(), pts.data_ptr(), obs.data_ptr(),
            w.data_ptr(), s, m, cam["fx"], cam["fy"], cam["cx"], cam["cy"],
            cam["reprojection_th2"], scratch.data_ptr(),
            *(x.data_ptr() for x in outs), kernels.stream_ptr(pts))
        if err:
            raise RuntimeError(f"launch failed ({err})")
    return run, outs


def phases(clk) -> dict:
    """{kind: (median, largest) cycles over the blocks, phases per block}
    from the stamps [blocks, SLOTS, 2] (kind, clock): each interval between
    consecutive stamps goes to the kind of the stamp that opens it."""
    import numpy as np

    per_block = []
    for rows in clk:
        rows = rows[rows[:, 1] > 0]
        sums = {}
        for (kind, c0), (_, c1) in zip(rows[:-1], rows[1:]):
            k = KINDS[int(kind)]
            n, tot = sums.get(k, (0, 0))
            sums[k] = (n + 1, tot + int(c1 - c0))
        sums["whole"] = (1, int(rows[-1, 1] - rows[0, 1]))
        per_block.append(sums)
    out = {}
    for k in [*KINDS, "whole"]:
        vals = [b[k][1] for b in per_block if k in b]
        if vals:
            out[k] = (int(np.median(vals)), max(vals), per_block[0][k][0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", type=Path, default=CSRC / "pnp_lm.cu",
                   help="the pnp_lm.cu to clock (beside its lm_common.cuh)")
    p.add_argument("--tag", default="tree", help="a name for the build")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import pnp

    # the problems of tests/test_torch_cuda.py, loaded from its file (a
    # package named ``tests`` elsewhere on the path may shadow this one)
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    PNP_CAM, _pnp_problem = cases.PNP_CAM, cases._pnp_problem

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"), flush=True)
    cam = dict(PNP_CAM, reprojection_th2=5.991)
    src = args.source.resolve()
    lib, ptx = build(args.tag, source(src, False), src.parent)
    clk_lib, _ = build(args.tag + "_clk", source(src, True), src.parent)
    clk_lib.lvt_pnp_set_clk.argtypes = [ctypes.c_void_p]
    print(f"[{args.tag}] {src}; ptxas: {ptx}", flush=True)
    for m, s, masked in SHAPES:
        rs = np.random.RandomState(m + s)
        prob = _pnp_problem(rs, s, m, "cuda")
        if masked > 0.1:   # the problems mask a tenth
            keep = torch.from_numpy(rs.rand(s, m) >= masked).cuda()
            prob[4] = prob[4] * keep
        run, outs = launcher(lib, prob, cam)
        run()
        torch.cuda.synchronize()
        same = True
        for i in range(s):
            want = pnp.solve_pnp_plain(Pose(prob[0][i], prob[1][i]),
                                       *(x[i] for x in prob[2:]), **cam)
            got = [x[i] for x in outs]
            same &= all(torch.equal(a, b) for a, b in zip(
                got, (*want.pose, want.inlier_mask, want.inlier_count,
                      want.chi2)))
        ms = chip_smoke.device_ms(run, chip_smoke.REPS)
        clk = torch.zeros(s * SLOTS * 2, dtype=torch.int64, device="cuda")
        clk_lib.lvt_pnp_set_clk(clk.data_ptr())
        run_c, _ = launcher(clk_lib, prob, cam)
        run_c()
        torch.cuda.synchronize()
        ph = phases(clk.view(s, SLOTS, 2).cpu().numpy())
        parts = "; ".join(f"{k} {a} / {b} ({n})"
                          for k, (a, b, n) in ph.items())
        print(f"[{args.tag}] M={m} S={s} ({masked:.0%} masked): {ms:.4f} "
              f"ms, outputs "
              f"{'equal' if same else 'DIFFER'} to the plain version; "
              f"cycles median / max over blocks (phases): {parts}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
