#!/usr/bin/env python3
"""Where the corner selection's kernel spends its time: the SM clock at
each phase boundary of ``csrc/select.cu``'s kernel, in every block, at
each block size it takes.

The script writes two copies of ``lvt_tpu_torch/csrc/select.cu`` (or of
``--source``) into ``build/select_clocks/``: one as it is, and one that
defines the kernel's
``SELECT_CLOCK(slot)`` markers as a block barrier and a ``clock64()``
stamp by thread 0. It builds them with nvcc for sm_90a (ptxas's registers
and spills printed) and launches them on kernel A's maps of uint8
frames: bench.py's sequence at path 1's shape (a KITTI pair, 250-px
cells keeping 150, 1536 slots) and path 3's 16 images, and path 4's
synthetic RGB-D world at TUM fr1's one cell of 640 x 480 keeping 1000, at
1 and 8 images.

It prints, per block size and shape: the blocks per cell (the cluster) and
how many clusters the card runs at once
(``cudaOccupancyMaxActiveClusters``), the plain copy's device time (the
mean of 200 launches, ``chip_smoke.device_ms``) and whether its outputs
equal the plain version's (``detect.select_corners_plain``); then the
instrumented copy's clocks (cycles) between stamps, the median and the
largest over the blocks: the load of the block's values, the select's
passes (each with the cluster's histogram exchange), the survivors and
the tie cut, the exchange of the cell's survivors, their ranks, the slot
writes, the count above t and the arrival; in each image's last cluster
the fallback and ``valid``.

    python3 scripts/torch_select_clocks.py [--threads 512 256]
        [--source DIR/select.cu --tag T]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc;
prints the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]
CSRC = ROOT / "lvt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "select_clocks"
SLOTS = 21
STAMPS = ('__device__ long long* g_clk;\n'
          '#define SELECT_CLOCK(slot) do { __syncthreads(); '
          'if (threadIdx.x == 0) g_clk[(blockIdx.x + gridDim.x * '
          '(blockIdx.y + gridDim.y * (long long)blockIdx.z)) * 21 + (slot)] '
          '= clock64(); } while (0)\n')
SET_CLK = ('\nextern "C" int lvt_select_set_clk(long long* p) {\n'
           '  return static_cast<int>(cudaMemcpyToSymbol(g_clk, &p, '
           'sizeof(p)));\n}\n')
PHASES = (("load", 0, 1), ("select passes", 1, 2),
          ("survivors and ties", 2, 3), ("exchange", 3, 4), ("ranks", 4, 5),
          ("slot writes", 5, 6), ("count and arrival", 6, 7),
          ("image: fallback and valid", 7, 8),
          *((f"pass {p}: count", 8 + 3 * p, 9 + 3 * p)
            for p in range(1, 4)),
          *((f"pass {p}: {what}", 9 + 3 * p + i, 10 + 3 * p + i)
            for p in range(4)
            for i, what in enumerate(("cluster barrier and exchange",
                                      "digit"))))


def source(path: Path, clocks: bool) -> str:
    src = path.read_text()
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
    lib.lvt_select_max_clusters.argtypes = kernels._SIGNATURES[
        "lvt_select_max_clusters"]
    return lib, " ".join(kernels.ptxas_report("select_corners_kernel",
                                              res.stderr + res.stdout))


def launcher(lib, args, threads):
    """A function that launches ``lib``'s kernel on the op's arguments
    (``detect.select_corners_op``'s, patch mode) into fixed outputs, the
    outputs, the grid's block count, the blocks per cell and the clusters
    the card runs at once."""
    import torch

    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.ops import detect
    from lvt_tpu_torch.ops.brief import PATCH, PATCH_C0, PATCH_R0

    nms, _, _, threshold, cell, k, low, spread, cap = args
    b, h, w = nms.shape
    geo = (ctypes.c_int * 7)()
    if lib.lvt_select_geometry(h, w, cell, k, cap, geo):
        raise ValueError("geometry out of the kernel's bounds")
    dev = nms.device
    counters = torch.empty(2 * b, dtype=torch.int32, device=dev)
    outs = (*(torch.empty((b, cap), dtype=torch.int32, device=dev)
              for _ in range(4)),
            torch.empty((b, cap), dtype=torch.float32, device=dev),
            torch.empty((b, cap), dtype=torch.bool, device=dev))
    t, t_low = detect._thresholds(threshold)

    def run():
        err = lib.lvt_select_corners(
            nms.data_ptr(), None, b, h, w, cell, k, cap, threads, t, t_low,
            low,
            int(spread), PATCH_C0, w - PATCH + PATCH_C0, PATCH_R0,
            h - PATCH + PATCH_R0, None, counters.data_ptr(),
            *(x.data_ptr() for x in outs), None, None, None, None,
            kernels.stream_ptr(nms))
        if err:
            raise RuntimeError(f"launch failed ({err})")
    return (run, outs, geo[1] * geo[0] * b, geo[1],
            lib.lvt_select_max_clusters(b, h, w, cell, k, cap, threads))


def shapes(device) -> dict:
    """The op's arguments on kernel A's maps: path 1's KITTI pair and path
    3's 16 images (8 frames of bench.py's sequence), and TUM fr1's one cell
    on 1 and 8 frames of path 4's synthetic RGB-D world (640 x 480)."""
    import numpy as np
    import torch

    import chip_smoke
    from lvt_tpu_torch import bench
    from lvt_tpu_torch.configs import kitti_config, tum_rgbd_config
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.ops import perception

    kitti, tum = kitti_config(), tum_rgbd_config(1)
    left, right = bench.render(kitti, 8)[:2]
    pairs = torch.from_numpy(np.stack([left, right], 1).reshape(
        16, kitti.img_height, kitti.img_width)).to(device)
    gray = torch.from_numpy(np.stack([
        np.clip(g, 0, 255).astype(np.uint8) for g, _, _ in
        SyntheticWorld().rgbd_sequence(8, speed=chip_smoke.RGBD_SPEED)])
    ).to(device)
    out = {}
    for name, config, imgs in (("path1 KITTI pair", kitti, pairs[:2]),
                               ("path3 16 images", kitti, pairs),
                               ("TUM fr1 1 image", tum, gray[:1]),
                               ("TUM fr1 8 images", tum, gray)):
        nms = perception.perception_patch_maps_batched(imgs)[0]
        out[name] = (nms, nms.new_zeros((0,)),
                     nms.new_zeros((0,), dtype=torch.int32),
                     float(config.agast_threshold),
                     config.detection_cell_size,
                     config.max_keypoints_per_cell,
                     config.corners_low_threshold, True, config.kp_capacity)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--threads", nargs="+", type=int, default=[512, 256],
                   help="block sizes (the kernel takes 512 and 256)")
    p.add_argument("--source", type=Path, default=CSRC / "select.cu",
                   help="the select.cu to clock")
    p.add_argument("--tag", default="tree", help="a name for the builds")
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
    lib, ptx = build(args.tag, source(args.source, False))
    clk_lib, _ = build(args.tag + "_clk", source(args.source, True))
    clk_lib.lvt_select_set_clk.argtypes = [ctypes.c_void_p]
    print(f"[{args.tag}] ptxas: {ptx}", flush=True)
    for threads in args.threads:
        tag = f"{args.tag} {threads} threads"
        for name, a in problems.items():
            run, outs, blocks, cluster, fit = launcher(lib, a, threads)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(outs, want[name]))
            ms = chip_smoke.device_ms(run, chip_smoke.REPS)
            clk = torch.zeros(blocks * SLOTS, dtype=torch.int64,
                              device="cuda")
            clk_lib.lvt_select_set_clk(clk.data_ptr())
            run_c = launcher(clk_lib, a, threads)[0]
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
            print(f"[{tag}] {name}: {blocks} blocks in clusters of "
                  f"{cluster} ({fit} clusters at once), {ms:.4f} ms, outputs "
                  f"{'equal' if same else 'DIFFER'}; cycles median / max: "
                  + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
