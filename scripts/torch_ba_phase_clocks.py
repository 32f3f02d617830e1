#!/usr/bin/env python3
"""Where local BA's kernel spends its time: the SM clock at each phase
boundary of ``csrc/ba.cu``'s kernel, in every block of one stream's
cluster.

For each cluster size and block size asked for, the script writes two
copies of ``lvt_tpu_torch/csrc/ba.cu`` into ``build/ba_phase_clocks/``
with ``CLUSTER`` and ``THREADS`` set: one as it is, and one that defines
the kernel's ``BA_PHASE_CLOCK(slot)`` markers as a block barrier and a
``clock64()`` stamp by thread 0 of every block. It builds them, four at
a time, with nvcc for sm_90a (ptxas's registers and spills printed) and
launches them on BA windows of KITTI 00's geometry
(tests/test_torch_cuda.py::_ba_problem, F = 4, 6 LM iterations) at M =
1024 and 4096.

It prints, per build: the plain copy's device time (CUDA events, the mean
of 50 launches) at S = 1 and S = 8, and then the instrumented copy's
clocks between stamps at S = 1: the gate and the starting state, per
iteration (the median of 6) (1) the per-point blocks, (2) the block's
sums over its points, (3) the exchange (the cluster barrier, then every
block reading the C blocks' partials and assembling the reduced system),
(4) the solve, (5) the point steps, the retraction and the trial's
chi-square over the block's points, (6) the trial's exchange (the
cluster sum) and the accept test; then the writeback; and the solve's
parts (``BA_SOLVE_CLOCK``, thread 0 after a warp barrier), per
iteration: the LU's steps (the last step's multipliers and the pivot
search; the block barrier and the reciprocal; the trailing update; the
block barrier), then the lower and the upper solve.
Each phase is given for block rank 0 and as the min-max over the
cluster's ranks. The stamps' barriers add a little time; the kernel's
own time is chip_smoke.py's.

    python3 scripts/torch_ba_phase_clocks.py [--cluster 4 8 16]
                                             [--threads 128 256 512]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc;
prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
CSRC = ROOT / "lvt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ba_phase_clocks"
SLOTS = 64
ITERS = 6
PARALLEL = 4   # nvcc processes at a time
# the phase stamps in slots 0 .. 2 + 6 ITERS of each block's row of 64;
# the solve's parts summed over the iterations in slots 49 .. 54
STAMPS = ('__device__ long long* g_clk;\n'
          '__device__ long long g_solve_last[256];\n'
          '#define BA_PHASE_CLOCK(slot) do { __syncthreads(); '
          'if (threadIdx.x == 0) g_clk[blockIdx.x * 64 + ((slot) < 48 ? '
          '(slot) : 48)] = clock64(); } while (0)\n'
          '#define BA_SOLVE_CLOCK(part) do { __syncwarp(); if (threadIdx.x == 0) { '
          'const long long now_ = clock64(); if ((part) > 0) '
          'g_clk[blockIdx.x * 64 + 48 + (part)] += now_ - '
          'g_solve_last[blockIdx.x & 255]; g_solve_last[blockIdx.x & 255] = '
          'now_; } } while (0)\n')
PHASES = ("point blocks", "sums", "exchange", "solve", "steps and trial",
          "trial exchange")
SOLVE_PARTS = ("LU multipliers and pivot", "LU barrier and reciprocal",
               "LU trailing update", "LU barrier", "lower solve",
               "upper solve")


def source(cluster: int, threads: int, clocks: bool) -> str:
    """ba.cu with CLUSTER and THREADS set and, with ``clocks``, its phase
    markers stamping the SM clock into ``g_clk`` (set by
    ``lvt_ba_set_clk``)."""
    src = (CSRC / "ba.cu").read_text()
    for name, value in (("CLUSTER", cluster), ("THREADS", threads)):
        pat = rf"constexpr int {name} = \d+;"
        if len(re.findall(pat, src)) != 1:
            raise RuntimeError(f"ba.cu changed: {pat!r} not found once")
        src = re.sub(pat, f"constexpr int {name} = {value};", src)
    if clocks:
        src = STAMPS + src + (
            '\nextern "C" void lvt_ba_set_clk(long long* c) {\n'
            '  cudaMemcpyToSymbol(g_clk, &c, sizeof(c));\n}\n')
    return src


def build(configs) -> dict:
    """Every (cluster, threads, clocks) copy built, PARALLEL at a time;
    their ptxas lines on the kernel."""
    from lvt_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for key in configs:
        tag = "c{}_t{}_{}".format(*key[:2], "clk" if key[2] else "plain")
        cu, so = OUT / f"ba_{tag}.cu", OUT / f"libba_{tag}.so"
        cu.write_text(source(*key))
        cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(CSRC),
                     "-Xptxas", "-v", "-shared", "-o", str(so), str(cu)])
        libs[key] = so
    out = {}
    for at in range(0, len(cmds), PARALLEL):
        batch = list(zip(configs, cmds))[at:at + PARALLEL]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for _, cmd in batch]
        for (key, cmd), proc in zip(batch, procs):
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{text}")
            out[key] = (libs[key],
                        kernels.ptxas_report("ba_refine_kernel", text))
    return out


def _load(so: Path, clocks: bool):
    from lvt_tpu_torch import kernels

    lib = ctypes.CDLL(str(so))
    lib.lvt_ba_refine.argtypes = kernels._SIGNATURES["lvt_ba_refine"]
    lib.lvt_ba_scratch_per_point.argtypes = [ctypes.c_int]
    if clocks:
        lib.lvt_ba_set_clk.argtypes = [ctypes.c_void_p]
    return lib


def _launcher(lib, args):
    """A function that launches the build once on ``args`` (S streams)."""
    import torch

    from lvt_tpu_torch import kernels
    from test_torch_cuda import BA_CAM

    s, f, m = args[3].shape[:3]
    dev = dict(device="cuda")
    scratch = torch.empty((s, m * lib.lvt_ba_scratch_per_point(f)), **dev)
    out = [torch.empty((s, m, 3), **dev), torch.empty(s, **dev),
           torch.empty(s, dtype=torch.int64, **dev),
           torch.empty((s, ITERS), dtype=torch.bool, **dev)]
    cam = [BA_CAM[k] for k in ("fx", "fy", "cx", "cy")]

    def launch():
        kernels.check(lib.lvt_ba_refine(
            *(x.data_ptr() for x in args), s, f, m, ITERS, *cam, 5.991,
            -BA_CAM["baseline"], 0.5, scratch.data_ptr(),
            *(x.data_ptr() for x in out),
            torch.cuda.current_stream().cuda_stream), "ba_refine (copy)")
    return launch, out


def _device_ms(launch, reps=50) -> float:
    import torch

    for _ in range(3):
        launch()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _clocks(lib, args, cluster, hz, label) -> None:
    """The instrumented build's phase clocks at S = 1, per rank."""
    import numpy as np
    import torch

    clk = torch.zeros((cluster, SLOTS), dtype=torch.int64, device="cuda")
    lib.lvt_ba_set_clk(clk.data_ptr())
    launch, _ = _launcher(lib, args)
    for _ in range(3):      # the last of 3 launches
        clk.zero_()
        launch()
        torch.cuda.synchronize()
    c = clk.cpu().numpy().astype(np.int64)               # [ranks, slots]
    d = np.diff(c[:, :2 + 6 * ITERS + 1], axis=1)        # [ranks, 2 + 6 it]
    start = d[:, 0]
    it = d[:, 1:1 + 6 * ITERS].reshape(cluster, ITERS, 6)
    per = np.median(it, axis=1)                          # [ranks, 6]
    writeback = d[:, 1 + 6 * ITERS]
    total = c[:, 2 + 6 * ITERS] - c[:, 0]

    def show(v):
        return f"{int(v[0])} ({int(v.min())}-{int(v.max())})"

    print(f"{label}: {show(total)} clocks in all, rank 0 "
          f"({1e3 * total[0] / hz:.4f} ms at {hz / 1e6:.0f} MHz); "
          f"gate and start {show(start)}; per iteration, median of "
          f"{ITERS}: " + ", ".join(f"{name} {show(per[:, k])}"
                                   for k, name in enumerate(PHASES))
          + f", in all {show(per.sum(1))}; writeback {show(writeback)} "
          f"[rank 0 (min-max over the {cluster} ranks)]", flush=True)
    parts = c[:, 49:55] / ITERS
    print(f"{label}: the solve per iteration, mean of {ITERS}: " + ", ".join(
        f"{name} {show(parts[:, k])}" for k, name in enumerate(SOLVE_PARTS)),
        flush=True)


def main(argv=None) -> int:
    import argparse

    import numpy as np

    from test_torch_cuda import _ba_problem

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cluster", type=int, nargs="+", default=[8])
    ap.add_argument("--threads", type=int, nargs="+", default=[256])
    opts = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    shapes = list(itertools.product(opts.cluster, opts.threads))
    built = build([(c, t, k) for c, t in shapes for k in (False, True)])
    problems = {m: _ba_problem(np.random.RandomState(1), 8, m, "cuda")
                for m in (1024, 4096)}
    for c, t in shapes:
        so, ptxas = built[(c, t, False)]
        print(f"cluster {c} x {t} threads: {'; '.join(ptxas)}", flush=True)
        try:
            plain = _load(so, False)
            clocked = _load(built[(c, t, True)][0], True)
            for m, args in problems.items():
                one = tuple(x[:1].contiguous() for x in args)
                ms = [_device_ms(_launcher(plain, a)[0]) for a in (one, args)]
                print(f"cluster {c} x {t} threads, M = {m}, F = "
                      f"{args[3].shape[1]}: {ms[0]:.4f} ms at S = 1, "
                      f"{ms[1]:.4f} ms at S = 8", flush=True)
                _clocks(clocked, one, c, hz,
                        f"cluster {c} x {t} threads, M = {m}")
        except RuntimeError as err:   # a launch the card refuses
            print(f"cluster {c} x {t} threads: {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
