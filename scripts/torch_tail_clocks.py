#!/usr/bin/env python3
"""Where the step's tail spends its time: the SM clock at each phase
boundary of ``csrc/tail.cu``'s ``step_tail_kernel`` in every block, as the
kernel ends a runner's frame (the state into the runner's buffers, the
rows, the next KITTI pair copied into the input buffers).

The script writes copies of a ``tail.cu`` (by default that of ``--root``)
into ``build/tail_clocks/``: one as it is and one that defines the
kernel's ``TAIL_CLOCK(slot)`` markers as a block barrier and a stamp by
thread 0 of ``clock64()`` and ``%globaltimer`` (kept in shared memory
until the block's last marker); with ``--variants`` also copies with a
part replaced (``VARIANTS``), each built and timed the same way. It builds
them with nvcc for sm_90a (ptxas's registers and spills printed) and
launches each through ``tail._launch`` of the ``lvt_tpu_torch`` package of
``--root`` on the ``cuda`` tests' problems (this tree's
``tests/test_torch_cuda.py``: ``tail_problem``, made in a child process)
at path 1's shape (M = N = 1024, K = 1536, one stream), path 2's (a BA
window of 4), path 3's (8 streams), path 5's (M = 4096, no staged set, K =
896) and at M = N = 8192 and 16384.

It prints, per build and shape: the units of a stream's state, the
device time of one launch (the mean of 200, ``chip_smoke.device_ms``)
and whether its outputs equal the plain tail's and the runner's copies
(the buffers, row 0, the next frame: NaN for NaN); then the clocked
copy's cycles per phase (between consecutive stamps), the median and the
largest over the stream blocks and over the copy blocks, and from the
global timer the span from the first block's first stamp to the last
block's last, and when the last stream block and the last copy block
ended within it.

    python3 scripts/torch_tail_clocks.py [--root DIR] [--source FILE]
        [--tag T] [--variants NAME ...]

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
OUT = ROOT / "build" / "tail_clocks"
SLOTS = 20
# the stream blocks' markers are 0-9, the copy blocks' 10-19; a block's
# first marker clears its stamps, its last (9 or 19) writes them out
STAMPS = ('__device__ long long* g_clk;\n'
          '__device__ __forceinline__ void tail_stamp(int slot) {\n'
          f'  __shared__ long long clk_s[2 * {SLOTS}];\n'
          '  if (threadIdx.x != 0) return;\n'
          '  if (slot % 10 == 0)\n'
          f'    for (int i = 0; i < 2 * {SLOTS}; ++i) clk_s[i] = 0;\n'
          '  long long g;\n'
          '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));\n'
          '  clk_s[slot] = clock64();\n'
          f'  clk_s[{SLOTS} + slot] = g;\n'
          '  if (slot % 10 == 9)\n'
          f'    for (int i = 0; i < 2 * {SLOTS}; ++i)\n'
          '      g_clk[(blockIdx.x + gridDim.x * (long long)blockIdx.y) * '
          f'2 * {SLOTS} + i] = clk_s[i];\n'
          '}\n'
          '#define TAIL_CLOCK(slot) do { __syncthreads(); '
          'tail_stamp(slot); } while (0)\n')
SET_CLK = ('\nextern "C" int lvt_tail_set_clk(long long* p) {\n'
           '  return static_cast<int>(cudaMemcpyToSymbol(g_clk, &p, '
           'sizeof(p)));\n}\n')
HEAD = "#include <cstdint>\n"
# the phase that starts at each marker
PHASES = {
    0: "first loads, the held units' leaves and loads, the means' loads "
       "and sums, the counts",
    1: "the counts by warp",
    2: "block sums into rank 0",
    3: "cluster barrier",
    4: "stores (held units, rank 0's rows and scalars)",
    5: "the rest of the units streamed",
    10: "table and ticket", 11: "the next frame copied",
}
# the held units' loads as tail.cu issues them: once the status is in,
# from the one source the flags pick
PICKED = """  const Flags f = flags_of(status, matches, a.min_matches,
                           a.fresh_status != nullptr);
  load_batch(held, tab, s, first, step, f);
"""
# ... and with every distinct source of each unit loaded before the flags
# are known, one picked after
PREFETCHED = """  uint4 cand[NB][4];
  int same[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (held.leaf[j] < 0) continue;
    const Leaf& l = tab.leaf[held.leaf[j]];
    const long long off =
        (first + j * step - tab.first[held.leaf[j]]) * l.unit;
    const uint8_t* p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = q == FRESH ? (l.src[FRESH] ? l.src[FRESH] + off : nullptr)
                        : l.src[q] + s * l.bytes + off;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      same[j][q] = q;
#pragma unroll
      for (int r = q - 1; r >= 0; --r)
        if (p[r] == p[q]) same[j][q] = r;
      cand[j][q] = make_uint4(0, 0, 0, 0);
      if (same[j][q] == q && p[q] != nullptr)
        cand[j][q] = load_unit(p[q], l.unit);
    }
  }
  const Flags f = flags_of(status, matches, a.min_matches,
                           a.fresh_status != nullptr);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (held.leaf[j] < 0) continue;
    const int r = same[j][pick(tab.leaf[held.leaf[j]], f)];
    held.v[j] = r == 0 ? cand[j][0] : r == 1 ? cand[j][1]
              : r == 2 ? cand[j][2] : cand[j][3];
  }
"""
# name: (a part of tail.cu, its replacement)
VARIANTS = {
    # at most 4 units a thread over the barrier: past 8192 units a stream
    # the rest streams after it (the layout before the units were sized)
    "hold4": ("constexpr int MAX_B = 8;", "constexpr int MAX_B = 4;"),
    # every candidate of a held unit loaded ahead of the flags
    "prefetch": (PICKED, PREFETCHED),
}
# (label, streams, tail_problem's keywords)
SHAPES = (("path 1", 1, {}), ("path 2", 1, {"f": 4}), ("path 3", 8, {}),
          ("path 5", 1, {"m": 4096, "n": 0, "k": 896}),
          ("M=8192", 1, {"m": 8192, "n": 8192, "k": 1000}),
          ("M=16384", 1, {"m": 16384, "n": 16384, "k": 1000}))
TIMING_FRAMES = 1024    # the chunk of the timed launches (the next pair)
MAX_COPY_CLUSTERS = 128  # csrc/tail.cu's


def source(path: Path, clocks: bool, variant: str | None) -> str:
    src = path.read_text()
    if variant:
        old, new = VARIANTS[variant]
        assert old in src, f"{variant}: {old!r} not in {path}"
        src = src.replace(old, new, 1)
    if clocks:
        assert HEAD in src
        src = src.replace(HEAD, HEAD + STAMPS, 1) + SET_CLK
    return src


def build(tag: str, src: str) -> tuple[ctypes.CDLL, str]:
    from lvt_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(src)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                          "-v", "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stderr}")
    report = res.stderr + res.stdout
    return ctypes.CDLL(str(so)), " ".join(
        kernels.ptxas_report("step_tail_kernel", report))


class TailLib:
    """The tree's kernel library with the functions of ``tail.cu`` taken
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


def phases(rows) -> list[str]:
    """Each phase's cycles, the median and the largest over the blocks,
    from their stamps [blocks, SLOTS]."""
    import numpy as np

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


def make_inputs(path: Path) -> None:
    """tail_problem() of this tree's tests at SHAPES (CPU tensors), saved
    to ``path``."""
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT)]
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    torch.save({"min_matches": cases.TAIL_MIN_MATCHES, "problems": {
        label: (s, kw, cases.tail_problem(np.random.RandomState(s), s,
                                          "cpu", **kw))
        for label, s, kw in SHAPES}}, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=Path, default=ROOT,
                   help="the checkout whose lvt_tpu_torch launches the "
                        "kernel")
    p.add_argument("--source", type=Path,
                   help="the tail.cu to clock (default: --root's)")
    p.add_argument("--tag", default="tree", help="a name for the builds")
    p.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                   default=[], help="copies with a part replaced, besides")
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
    src = (args.source or root / "lvt_tpu_torch" / "csrc" / "tail.cu"
           ).resolve()
    sys.path[:0] = [str(root)]

    import lvt_tpu_torch  # noqa: F401  (--root's package, first)
    import numpy as np
    import torch

    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(smoke._smi("name,power.limit"), flush=True)
    real = kernels.lib()
    saved = torch.load(inputs)
    problems, min_matches = saved["problems"], saved["min_matches"]
    for variant in [None, *args.variants]:
        tag = args.tag + (f"_{variant}" if variant else "")
        plain_so, ptx = build(tag, source(src, False, variant))
        clk_so, _ = build(tag + "_clk", source(src, True, variant))
        clk_so.lvt_tail_set_clk.argtypes = [ctypes.c_void_p]
        libs = {which: TailLib(so, real, kernels._SIGNATURES)
                for which, so in (("plain", plain_so), ("clocked", clk_so))}
        print(f"[{tag}] {src} through {root}; ptxas: {ptx}", flush=True)
        for label, (s, kw, a) in problems.items():
            a = [[x.cuda() for x in xs] for xs in a]
            state_l, new_l, inp_l = a
            inp = tail.TailInputs(*inp_l[:-1], None if inp_l[-1].dim() == 2
                                  else inp_l[-1])
            state = from_leaves(tail._TEMPLATE, state_l)
            want, pose, metrics = tail._unpack(state, tail._plain_streams(
                state_l, new_l, inp_l, min_matches))
            pair = [torch.randint(0, 256, (TIMING_FRAMES, s, 376, 1241),
                                  dtype=torch.uint8, device="cuda")
                    for _ in range(2)]

            def runner():
                buffers = from_leaves(tail._TEMPLATE,
                                      [x.clone() for x in state_l])
                epi = graphs.Epilogue(buffers,
                                      [torch.empty_like(x[0]) for x in pair])
                return buffers, epi, epi.start(pair)

            def launch(buffers, epi):
                tail._launch(leaves(buffers), new_l, inp, min_matches, (s,),
                             epi)

            kernels._lib = libs["plain"]
            try:
                buffers, epi, rows = runner()
                launch(buffers, epi)
                smoke._require_equal_nan(
                    label, [*leaves(buffers),
                            *[x[0] for x in graphs._rows_of(rows)],
                            *epi.inputs],
                    [*leaves(want), *pose, *metrics, *[x[1] for x in pair]])
                same = "equal"
            except AssertionError as e:
                same = f"DIFFER ({e})"
            buffers, epi, _ = runner()
            ms = smoke.device_ms(lambda: launch(buffers, epi), smoke.REPS)
            units = tail._units(
                ((x.numel() // s * x.element_size(), (x,))
                 for i, x in enumerate(leaves(buffers)) if i in tail.KINDS),
                s)
            buffers, epi, _ = runner()
            blocks = 8 * (s + MAX_COPY_CLUSTERS)
            clk = torch.zeros(blocks * 2 * SLOTS, dtype=torch.int64,
                              device="cuda")
            clk_so.lvt_tail_set_clk(clk.data_ptr())
            kernels._lib = libs["clocked"]
            launch(buffers, epi)
            torch.cuda.synchronize()
            kernels._lib = real
            c = clk.view(blocks, 2 * SLOTS).cpu().numpy()
            c = c[(c > 0).any(1)]
            cyc, ns = c[:, :SLOTS], c[:, SLOTS:]
            stream = cyc[:, 0] > 0
            t0 = ns[ns > 0].min()
            end_s = int(ns[stream].max() - t0)
            end_c = int(ns[~stream].max() - t0) if (~stream).any() else 0
            print(f"[{tag}] {label} (S={s}, {units} units a stream): "
                  f"{int(stream.sum())} stream blocks, "
                  f"{int((~stream).sum())} copy blocks, {ms:.4f} ms, "
                  f"outputs {same}; cycles median / max, stream blocks: "
                  + "; ".join(phases(cyc[stream])) + "; copy blocks: "
                  + "; ".join(phases(cyc[~stream]))
                  + f"; global timer: the last stream block ends at "
                  f"{end_s} ns, the last copy block at {end_c} ns after "
                  f"the first stamp", flush=True)
            del pair
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
