#!/usr/bin/env python3
"""Where the corner selection's kernel spends its time: the SM clock at
each phase boundary of ``csrc/select.cu``'s kernel, in every block, for
variants of its block size and tile size.

For each variant the script writes two copies of
``lvt_tpu_torch/csrc/select.cu`` into ``build/select_clocks/`` with
``THREADS`` and ``TILE_TARGET`` set: one as it is, and one that defines
the kernel's ``SELECT_CLOCK(slot)`` markers as a block barrier and a
``clock64()`` stamp by thread 0. It builds them with nvcc for sm_90a (ptxas's
registers and spills printed) and launches them on kernel A's maps of
random uint8 frames at path 1's shape (a KITTI pair, 250-px cells keeping
150, 1536 slots), path 3's 16 images, and TUM fr1's one cell of 640 x 480
keeping 1000 at 1 and 8 images.

It prints, per variant and shape: the plain copy's device time (the mean
of 200 launches, ``chip_smoke.device_ms``) and whether its outputs equal
the plain version's (``detect.select_corners_plain``); then the instrumented copy's clocks (cycles) between
stamps, the median and the largest over the blocks: the tile's load, its
select, its compaction and publication; in each cell's merging block the
candidates' load, their select and compaction, their sort, and the
slot writes; in each image's last block the fallback and ``valid``.

    python3 scripts/torch_select_clocks.py [--variants 256:4096 512:8192]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc;
prints the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]
CSRC = ROOT / "lvt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "select_clocks"
SLOTS = 9
STAMPS = ('__device__ long long* g_clk;\n'
          '#define SELECT_CLOCK(slot) do { __syncthreads(); '
          'if (threadIdx.x == 0) g_clk[(blockIdx.x + gridDim.x * '
          '(blockIdx.y + gridDim.y * (long long)blockIdx.z)) * 9 + (slot)] '
          '= clock64(); } while (0)\n')
SET_CLK = ('\nextern "C" int lvt_select_set_clk(long long* p) {\n'
           '  return static_cast<int>(cudaMemcpyToSymbol(g_clk, &p, '
           'sizeof(p)));\n}\n')
PHASES = (("tile load", 0, 1), ("tile select", 1, 2),
          ("tile compaction and publication", 2, 3),
          ("merge: candidates' load", 3, 4),
          ("merge: select and compaction", 4, 5),
          ("merge: sort", 5, 6), ("merge: slot writes", 6, 7),
          ("image: fallback and valid", 7, 8))


def source(threads: int, tile: int, clocks: bool) -> str:
    src = (CSRC / "select.cu").read_text()
    for name, value in (("THREADS", threads), ("TILE_TARGET", tile)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    if clocks:
        src = src.replace("#include <stdint.h>\n",
                          "#include <stdint.h>\n" + STAMPS, 1) + SET_CLK
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
    lib = ctypes.CDLL(str(so))
    lib.lvt_select_geometry.argtypes = kernels._SIGNATURES[
        "lvt_select_geometry"]
    lib.lvt_select_corners.argtypes = kernels._SIGNATURES[
        "lvt_select_corners"]
    return lib, " ".join(kernels.ptxas_report("select_corners_kernel",
                                              res.stderr + res.stdout))


def launcher(lib, args):
    """A function that launches ``lib``'s kernel on the op's arguments
    (``detect.select_corners_op``'s, patch mode) into fixed outputs, and
    the outputs, and the grid's block count."""
    import torch

    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.ops import detect
    from lvt_tpu_torch.ops.brief import PATCH, PATCH_C0, PATCH_R0

    nms, _, threshold, cell, k, low, spread, cap = args
    b, h, w = nms.shape
    geo = (ctypes.c_int * 5)()
    if lib.lvt_select_geometry(h, w, cell, k, cap, geo):
        raise ValueError("geometry out of the kernel's bounds")
    dev = nms.device
    cand = torch.empty(b * geo[0] * geo[1] * geo[2], dtype=torch.int64,
                       device=dev)
    counters = torch.empty(b * geo[0] + 2 * b, dtype=torch.int32, device=dev)
    outs = (*(torch.empty((b, cap), dtype=torch.int32, device=dev)
              for _ in range(4)),
            torch.empty((b, cap), dtype=torch.float32, device=dev),
            torch.empty((b, cap), dtype=torch.bool, device=dev))
    t, t_low = detect._thresholds(threshold)

    def run():
        err = lib.lvt_select_corners(
            nms.data_ptr(), None, b, h, w, cell, k, cap, t, t_low, low,
            int(spread), PATCH_C0, w - PATCH + PATCH_C0, PATCH_R0,
            h - PATCH + PATCH_R0, cand.data_ptr(), counters.data_ptr(),
            *(x.data_ptr() for x in outs), None, None,
            kernels.stream_ptr(nms))
        if err:
            raise RuntimeError(f"launch failed ({err})")
    return run, outs, geo[1] * geo[0] * b


def shapes(device) -> dict:
    """The op's arguments on kernel A's maps of random frames."""
    import numpy as np
    import torch

    from lvt_tpu_torch.configs import kitti_config, tum_rgbd_config
    from lvt_tpu_torch.ops import perception

    rs = np.random.RandomState(0)
    out = {}
    for name, config, b in (("path1 KITTI pair", kitti_config(), 2),
                            ("path3 16 images", kitti_config(), 16),
                            ("TUM fr1 1 image", tum_rgbd_config(1), 1),
                            ("TUM fr1 8 images", tum_rgbd_config(1), 8)):
        h, w = config.img_height, config.img_width
        imgs = torch.from_numpy(rs.randint(0, 256, (b, h, w)).astype(
            np.uint8)).to(device)
        nms = perception.perception_patch_maps_batched(imgs)[0]
        out[name] = (nms, nms.new_zeros((0,)), float(config.agast_threshold),
                     config.detection_cell_size,
                     config.max_keypoints_per_cell,
                     config.corners_low_threshold, True, config.kp_capacity)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", nargs="+", default=["256:4096"],
                   help="THREADS:TILE_TARGET pairs")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from lvt_tpu_torch.ops import detect

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"), flush=True)
    problems = shapes("cuda")
    want = {name: detect.select_corners_plain(*a)[:6]
            for name, a in problems.items()}
    for v in args.variants:
        threads, tile = map(int, v.split(":"))
        tag = f"t{threads}_s{tile}"
        lib, ptx = build(tag, source(threads, tile, False))
        clk_lib, _ = build(tag + "_clk", source(threads, tile, True))
        clk_lib.lvt_select_set_clk.argtypes = [ctypes.c_void_p]
        print(f"[{tag}] ptxas: {ptx}", flush=True)
        for name, a in problems.items():
            run, outs, blocks = launcher(lib, a)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(outs, want[name]))
            ms = chip_smoke.device_ms(run, chip_smoke.REPS)
            clk = torch.zeros(blocks * SLOTS, dtype=torch.int64,
                              device="cuda")
            clk_lib.lvt_select_set_clk(clk.data_ptr())
            run_c, _, _ = launcher(clk_lib, a)
            run_c()
            torch.cuda.synchronize()
            c = clk.view(blocks, SLOTS).cpu().numpy()
            parts = []
            for label, s0, s1 in PHASES:
                rows = c[(c[:, s0] > 0) & (c[:, s1] > 0)]
                d = rows[:, s1] - rows[:, s0]
                if len(d):
                    parts.append(f"{label} {int(np.median(d))} / "
                                 f"{int(d.max())} ({len(d)} blocks)")
            print(f"[{tag}] {name}: {blocks} blocks, {ms:.4f} ms, outputs "
                  f"{'equal' if same else 'DIFFER'}; cycles median / max: "
                  + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
