#!/usr/bin/env python3
"""Where the tracking branch's kernels spend their time: the SM clock at
each phase boundary of ``csrc/track.cu``'s ``staged_promote_kernel``,
``triangulate_insert_kernel``, ``map_accept_kernel``,
``upkeep_pre_kernel`` and ``predict_project_kernel``, in every block.

The script writes two copies of a ``track.cu`` (by default that of
``--root``; ``--source`` names another, beside its ``lm_common.cuh``) into
``build/track_clocks/``: one as it is, and one that defines the kernels'
``TRACK_CLOCK(slot)`` markers as a block barrier and a ``clock64()`` stamp
by thread 0 (kept in shared memory until the kernel's last marker). It
builds them with nvcc for sm_90a (ptxas's registers and spills printed)
and launches each through the ``lvt_tpu_torch`` package of
``--root`` (by default this tree: the wrappers that go with the source) on
the ``cuda`` tests' problems (this tree's ``tests/test_torch_cuda.py``:
``_track_problem``, and ``accept_args`` for the map match; made in a child
process) at path 1's shape (K = 1536 features, M = N = 1024, one stream),
path 3's (8 streams) and path 5's (M = 4096, K = 896; no staged set for
``upkeep_pre``, ``staged_threshold`` 0 for the triangulation), the
triangulation with policy 2 (every frame triangulates). ``--ops`` picks
the kernels (default: all five).

It prints, per op and shape: the blocks of the launch and the blocks per
stream, the plain copy's device time (the mean of 200 launches,
``chip_smoke.device_ms``) and whether its outputs equal the plain
version's (stream by stream, NaN for NaN); then the instrumented copy's
cycles per phase (between consecutive stamps), the median and the largest
over the blocks, and the whole (first stamp to last).

    python3 scripts/torch_track_clocks.py [--root DIR] [--source FILE]
        [--tag T] [--ops NAME ...]

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
OUT = ROOT / "build" / "track_clocks"
SLOTS = 90
# the most blocks a stream of a clocked launch takes (predict_project at
# M = 4096 in blocks of 128)
MAX_BLOCKS = 64
# thread 0 stamps into shared memory (a global store ahead of a cluster
# barrier's release would make the release wait for it); a kernel's first
# marker (slot 0, 10, ..., 80) clears the stamps, its last (9, 19, ..., 89;
# 25 and 34 in a parent's one-block kernels) writes them out
STAMPS = ('__device__ long long* g_clk;\n'
          '__device__ __forceinline__ void track_stamp(int slot) {\n'
          f'  __shared__ long long clk_s[{SLOTS}];\n'
          '  if (threadIdx.x != 0) return;\n'
          '  if (slot % 10 == 0)\n'
          f'    for (int i = 0; i < {SLOTS}; ++i) clk_s[i] = 0;\n'
          '  clk_s[slot] = clock64();\n'
          '  if (slot % 10 == 9 || slot == 25 || slot == 34)\n'
          f'    for (int i = 0; i < {SLOTS}; ++i)\n'
          '      g_clk[(blockIdx.x + gridDim.x * (long long)blockIdx.y) * '
          f'{SLOTS} + i] = clk_s[i];\n'
          '}\n'
          '#define TRACK_CLOCK(slot) do { __syncthreads(); '
          'track_stamp(slot); } while (0)\n')
SET_CLK = ('\nextern "C" int lvt_track_set_clk(long long* p) {\n'
           '  return static_cast<int>(cudaMemcpyToSymbol(g_clk, &p, '
           'sizeof(p)));\n}\n')
# the phase that starts at each marker
PHASES = {
    # the cluster kernels: triangulate_insert 0-9, staged_promote 10-19
    0: "keys and barrier 1's arrive", 1: "loads, copies through, free ranks",
    2: "barrier 1",
    3: "resolution (atomicMin)", 4: "barrier 2",
    5: "triangulation, candidates and records", 6: "barrier 3",
    7: "insertions", 8: "barrier 4 and the scalars",
    10: "keys and barrier 1's arrive", 11: "loads, copy through, free ranks",
    12: "barrier 1",
    13: "resolution (atomicMin)", 14: "barrier 2",
    15: "promotion flags and records", 16: "barrier 3",
    17: "claims and insertion", 18: "barrier 4",
    # the one-block-per-stream kernels (the markers of a parent's copy)
    20: "map size", 21: "resolution", 22: "triangulation passes",
    23: "insertion into the map", 24: "insertion into the staged set",
    30: "claims copy and resolution", 31: "promotion passes",
    32: "claims out", 33: "insertion",
    # map_accept and upkeep_pre: one block a stream, every input loaded
    # before the first of two barriers
    40: "keys set, loads, features staged",
    41: "atomicMin both radii, counts", 42: "outputs",
    50: "un-marks cleared, loads",
    51: "pose, bookkeeping, un-marks, staged projection, kept count",
    52: "claims and targets out",
    # the same two as PRs 15-16 wrote them (the markers of a parent's copy)
    60: "narrow resolution", 61: "wide resolution", 62: "narrow count",
    63: "outputs and claims", 64: "count", 65: "claims out",
    70: "pose (thread 0)", 71: "bookkeeping and cull",
    72: "staged projection", 73: "kept count", 74: "claims and targets out",
    # predict_project: a point a thread, no barrier but the markers' (in a
    # parent's copy: thread 0's pose behind the block's barrier)
    80: "loads and the pose algebra (a parent's: thread 0's, the barrier)",
    81: "projection and stores (a parent's: the point's loads too)",
}
# (label, streams, the problem's sizes, each op's extras)
SHAPES = (("path 1", 1, {}, {}), ("path 3", 8, {}, {}),
          ("path 5", 1, {"m": 4096, "k": 896},
           {"triangulate_insert": {"staged_threshold": 0},
            "upkeep_pre": {"n": 0}}))
OPS = ("staged_promote", "triangulate_insert", "map_accept", "upkeep_pre",
       "predict_project")
# map_accept's scalars: the tests' ratio and absolute thresholds, and a
# retry at m / 25 matches
ACCEPT_SCALARS = (0.8, 30.0)


def op_and_plain(name):
    """Op ``name``'s custom op and its plain version's flat form (the
    op's CPU kernel, one stream)."""
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.ops import matching

    mod = matching if name == "map_accept" else track
    return getattr(mod, f"{name}_op"), getattr(mod, f"_{name}_flat")


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
    report = res.stderr + res.stdout
    return ctypes.CDLL(str(so)), "; ".join(
        f"{op}: {' '.join(kernels.ptxas_report(op + '_kernel', report))}"
        for op in OPS)


class TrackLib:
    """The tree's kernel library with the functions of ``track.cu`` taken
    from ``so`` (a build of one copy), typed as the tree's kernels.py
    types them."""

    def __init__(self, so, real, signatures):
        self._so, self._real = so, real
        for name, argtypes in signatures.items():
            fn = getattr(so, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def __getattr__(self, name):
        fn = getattr(self._so, name, None)
        return fn if fn is not None else getattr(self._real, name)


def phases(clk) -> list[str]:
    """Each phase's cycles, the median and the largest over the blocks
    that stamped, from the stamps [blocks, SLOTS]."""
    import numpy as np

    rows = clk[(clk > 0).any(1)]
    if not len(rows):
        return ["no stamps"]
    slots = [i for i in range(SLOTS) if (rows[:, i] > 0).all()]
    out = []
    for a, b in zip(slots[:-1], slots[1:]):
        d = rows[:, b] - rows[:, a]
        out.append(f"{PHASES.get(a, a)} {int(np.median(d))} / {int(d.max())}")
    d = rows[:, slots[-1]] - rows[:, slots[0]]
    out.append(f"whole {int(np.median(d))} / {int(d.max())}")
    return out


def problems(cases, device="cpu") -> dict:
    """{(op, shape label): (_track_problem's keywords, the op's
    arguments)} at each of SHAPES, from the module of
    ``tests/test_torch_cuda.py`` (``cases``)."""
    import numpy as np

    out = {}
    for name in OPS:
        for label, s, sizes, extra in SHAPES:
            kw = dict(sizes, **extra.get(name, {}))
            if name == "triangulate_insert":
                kw["policy"] = 2
            rs = np.random.RandomState(s)
            if name == "map_accept":
                m, k = kw.get("m", 1024), kw.get("k", 1536)
                args = [*cases.accept_args(rs, s, m, k, device),
                        *ACCEPT_SCALARS, max(1, m // 25)]
            else:
                args = cases._track_problem(rs, name, s, device, **kw)
            out[name, label] = (kw, args)
    return out


def make_inputs(path: Path) -> None:
    """problems() of this tree's tests (CPU tensors), saved to ``path``."""
    import torch

    sys.path[:0] = [str(ROOT)]
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    torch.save(problems(cases), path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=Path, default=ROOT,
                   help="the checkout whose lvt_tpu_torch launches the "
                        "kernels")
    p.add_argument("--source", type=Path,
                   help="the track.cu to clock (beside its lm_common.cuh; "
                        "default: --root's)")
    p.add_argument("--tag", default="tree", help="a name for the builds")
    p.add_argument("--ops", nargs="+", choices=OPS, default=list(OPS),
                   help="the kernels to clock")
    p.add_argument("--make-inputs", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.make_inputs:
        make_inputs(args.make_inputs)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    inputs = OUT / "inputs.pt"
    subprocess.run([sys.executable, __file__, "--make-inputs", str(inputs)],
                   check=True)
    root = args.root.resolve()
    src = (args.source or root / "lvt_tpu_torch" / "csrc" / "track.cu"
           ).resolve()
    sys.path[:0] = [str(root)]

    import lvt_tpu_torch  # noqa: F401  (--root's package, first)
    import numpy as np
    import torch

    from lvt_tpu_torch import kernels

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(smoke._smi("name,power.limit"), flush=True)
    real = kernels.lib()
    plain_so, ptx = build(args.tag, source(src, False), src.parent)
    clk_so, _ = build(args.tag + "_clk", source(src, True), src.parent)
    clk_so.lvt_track_set_clk.argtypes = [ctypes.c_void_p]
    libs = {which: TrackLib(so, real, kernels._SIGNATURES)
            for which, so in (("plain", plain_so), ("clocked", clk_so))}
    print(f"[{args.tag}] {src} through {root}; ptxas: {ptx}", flush=True)
    for (op_name, label), (kw, a) in torch.load(inputs).items():
        if op_name not in args.ops:
            continue
        a = [x.cuda() if isinstance(x, torch.Tensor) else x for x in a]
        s = a[0].shape[0]
        op, flat = op_and_plain(op_name)
        want = kernels.per_stream(flat, sum(isinstance(x, torch.Tensor)
                                            for x in a), a)
        kernels._lib = libs["plain"]
        try:
            smoke._require_equal_nan(op_name, op(*a), want)
            same = "equal"
        except AssertionError as e:
            same = f"DIFFER ({e})"
        ms = smoke.device_ms(lambda: op(*a), smoke.REPS)
        clk = torch.zeros(MAX_BLOCKS * s * SLOTS, dtype=torch.int64,
                          device="cuda")
        clk_so.lvt_track_set_clk(clk.data_ptr())
        kernels._lib = libs["clocked"]
        op(*a)
        torch.cuda.synchronize()
        kernels._lib = real
        c = clk.view(MAX_BLOCKS * s, SLOTS).cpu().numpy()
        blocks = int((c > 0).any(1).sum())
        shape = ", ".join(f"{k}={v}" for k, v in kw.items())
        print(f"[{args.tag}] {op_name} {label} (S={s}"
              f"{', ' + shape if shape else ''}): {blocks} blocks, "
              f"{blocks // s} a stream, {ms:.4f} ms, outputs {same}; "
              f"cycles median / max over the blocks: "
              + "; ".join(phases(c)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
