#!/usr/bin/env python3
"""Where local BA's kernel spends its time: the SM clock at each phase
boundary of ``csrc/ba.cu``'s kernel on one stream.

The script writes an instrumented copy of ``lvt_tpu_torch/csrc/ba.cu``
into ``build/ba_phase_clocks/`` (a ``clock64()`` stamp by thread 0 after a
block barrier at each boundary), builds it there with nvcc for sm_90a, and
launches it on BA windows of KITTI 00's geometry
(tests/test_torch_cuda.py::_ba_problem, F = 4, 6 LM iterations) at M =
1024 and 4096. It prints the clocks between stamps: the gate and the
starting state, then per iteration (1) the per-point blocks, (2) the warp
sums over the points, (3) the reduced system's assembly and solve, (4)
the point steps, the retraction, the trial chi-square and the accept
test; then the writeback. The stamps' barriers add a little time; the
kernel's own time is chip_smoke.py's.

    python3 scripts/torch_ba_phase_clocks.py [--threads 512 256 ...]

``--threads`` builds and times the kernel at each block size given (a
multiple of 32; the kernel's own is 512).

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc;
prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
OUT = ROOT / "build" / "ba_phase_clocks"
STAMP = ("do { __syncthreads(); if (threadIdx.x == 0) g_clk[blockIdx.x * 64"
         " + (ck < 63 ? ck++ : 63)] = clock64(); } while (0)")


def instrumented(threads: int = 512) -> str:
    """ba.cu with the stamps (``STAMP()``) at each phase boundary, at
    ``threads`` threads per block."""
    src = (ROOT / "lvt_tpu_torch" / "csrc" / "ba.cu").read_text()
    edits = [
        ("constexpr int THREADS = 512;", f"constexpr int THREADS = {threads};"),
        ('#include "lm_common.cuh"', '#include "%s"' % (
            ROOT / "lvt_tpu_torch" / "csrc" / "lm_common.cuh")),
        ("namespace {\n\nconstexpr int THREADS",
         "namespace {\n__device__ long long* g_clk;\n#define STAMP() " + STAMP
         + "\n\nconstexpr int THREADS"),
        ("  __shared__ Shared sh;\n",
         "  __shared__ Shared sh;\n  int ck = 0;\n  STAMP();\n"),
        ("  const int n = 6 * f_dim, nf = f_dim - 1;\n",
         "  STAMP();\n  const int n = 6 * f_dim, nf = f_dim - 1;\n"),
        ("    point_blocks(in, s, m, f_dim, x_off, cam, sh);\n",
         "    STAMP();\n    point_blocks(in, s, m, f_dim, x_off, cam, sh);\n"
         "    STAMP();\n"),
        ("    __syncthreads();\n    assemble(f_dim, sh);\n",
         "    STAMP();\n    assemble(f_dim, sh);\n"),
        ("    if (threadIdx.x < f_dim) {\n      const int f = threadIdx.x;\n"
         "      retract(",
         "    STAMP();\n    if (threadIdx.x < f_dim) {\n"
         "      const int f = threadIdx.x;\n      retract("),
        ("  if (threadIdx.x == 0) chi2_out[st] = sh.chi2;\n}",
         "  STAMP();\n  if (threadIdx.x == 0) chi2_out[st] = sh.chi2;\n}"),
        ('extern "C" int lvt_ba_refine(',
         'extern "C" void lvt_ba_set_clk(long long* c) {\n'
         '  cudaMemcpyToSymbol(g_clk, &c, sizeof(c));\n}\n\n'
         'extern "C" int lvt_ba_refine('),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ba.cu changed: {old[:40]!r} not found once")
        src = src.replace(old, new)
    return src


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    from lvt_tpu_torch import kernels
    from test_torch_cuda import BA_CAM, _ba_problem

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[512])
    threads_list = ap.parse_args(argv).threads
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    cam = [BA_CAM[k] for k in ("fx", "fy", "cx", "cy")]
    hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    clk = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
    for threads in threads_list:
        cu = OUT / f"ba_timed_{threads}.cu"
        so = OUT / f"libba_timed_{threads}.so"
        cu.write_text(instrumented(threads))
        report = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(so), str(cu)], check=True, capture_output=True,
            text=True)
        regs = [line.strip() for line in (report.stdout + report.stderr)
                .splitlines() if "spill" in line or "registers" in line]
        print(f"{threads} threads: {regs[-2:]}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.lvt_ba_refine.argtypes = kernels._SIGNATURES["lvt_ba_refine"]
        lib.lvt_ba_scratch_per_point.argtypes = [ctypes.c_int]
        lib.lvt_ba_set_clk.argtypes = [ctypes.c_void_p]
        lib.lvt_ba_set_clk(clk.data_ptr())
        _time(lib, clk, cam, hz, threads)
    return 0


def _time(lib, clk, cam, hz, threads) -> None:
    """The phase clocks of one build at M = 1024 and 4096."""
    import numpy as np
    import torch

    from lvt_tpu_torch import kernels
    from test_torch_cuda import BA_CAM, _ba_problem

    for m in (1024, 4096):
        args = _ba_problem(np.random.RandomState(1), 1, m, "cuda")
        f = args[0].shape[1]
        dev = dict(device="cuda")
        scratch = torch.empty((1, m * lib.lvt_ba_scratch_per_point(f)), **dev)
        out = [torch.empty((1, m, 3), **dev), torch.empty(1, **dev),
               torch.empty(1, dtype=torch.int64, **dev),
               torch.empty((1, 6), dtype=torch.bool, **dev)]
        for _ in range(3):      # the last of 3 launches
            clk.zero_()
            kernels.check(lib.lvt_ba_refine(
                *(x.data_ptr() for x in args), 1, f, m, 6, *cam, 5.991,
                -BA_CAM["baseline"], 0.5, scratch.data_ptr(),
                *(x.data_ptr() for x in out),
                torch.cuda.current_stream().cuda_stream), "ba_timed")
            torch.cuda.synchronize()
        c = clk[0].cpu().numpy()
        c = c[c > 0]
        d = np.diff(c)
        # the gate, the loop's start, 6 x 4 phases (the last one runs on
        # into the writeback)
        it = d[2:].reshape(6, 4)
        steps = int(np.median(it[:5, 3]))
        print(f"{threads} threads, M = {m}, F = {f}: {c[-1] - c[0]} clocks "
              f"({1e3 * (c[-1] - c[0]) / hz:.3f} ms at {hz / 1e6:.0f} MHz); "
              f"gate and start {d[0] + d[1]}; per iteration, median of 6: "
              f"point blocks {int(np.median(it[:, 0]))}, sums over the "
              f"points {int(np.median(it[:, 1]))}, solve "
              f"{int(np.median(it[:, 2]))}, steps and trial {steps} (of 5); "
              f"writeback {int(it[5, 3]) - steps}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
