#!/usr/bin/env python3
"""Where a frame of path 1 (the port's main path) or path 2 (the shipped
KITTI YAML in the dense mode, local BA on) goes, stage by stage, on the
card: chip_smoke.py's eager profile unit (``chip_smoke._profile`` with
the host trace: the step's profiler ranges, host and device ms per frame,
device kernels per frame and the busy ms of the records inside each
stage's span), the same frames replayed from the step's CUDA graph
(device kernels and busy ms per frame), and each mode's frames/s over
TIMED units after them (host clock around ``track_chunk`` and a sync; no
trace; the eager system under ``disable_graphs``).

    python3 scripts/torch_stage_table.py [--path path1|path2] [--root DIR] [--out DIR]

``--root`` imports ``lvt_tpu_torch`` from another checkout (for example
the parent commit unpacked with ``git archive``), so that two trees can be
compared in one run on one card: run parent, change, change, parent. The
profiling code is this checkout's chip_smoke.py either way. Prints the
tables and, as the last line, one JSON object. Needs CUDA; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = 16   # frames per unit: a warm-up unit, the profiled one, then TIMED
TIMED = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose lvt_tpu_torch is profiled")
    p.add_argument("--path", default="path1", choices=["path1", "path2"],
                   help="path 1 (kitti_config) or path 2 "
                        "(kitti_ba_dense_config)")
    p.add_argument("--out", help="write the eager unit's op table here")
    args = p.parse_args(argv)

    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from lvt_tpu_torch import bench
    from lvt_tpu_torch.configs import kitti_ba_dense_config, kitti_config
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.core.system import VOSystem

    import lvt_tpu_torch
    if not os.path.abspath(lvt_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"lvt_tpu_torch came from {lvt_tpu_torch.__file__}"
                           f", not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    config = (kitti_config() if args.path == "path1"
              else kitti_ba_dense_config())
    # both paths take the prefix of bench.py's sequence (chip_smoke.py)
    il, ir, _, _ = bench.render(kitti_config(), (2 + TIMED) * UNIT)
    il = torch.from_numpy(il).to("cuda")
    ir = torch.from_numpy(ir).to("cuda")
    out = dict(root=root, card=card, path=args.path)
    for mode in ("eager", "graph"):
        vo = VOSystem(config, device="cuda")
        with disable_graphs() if mode == "eager" else contextlib.nullcontext():
            vo.track_chunk(il[:UNIT], ir[:UNIT])
            prof = chip_smoke._profile(
                lambda: vo.track_chunk(il[UNIT:2 * UNIT], ir[UNIT:2 * UNIT]),
                UNIT, args.out if mode == "eager" else None,
                host=mode == "eager")
            fps = []
            for u in range(2, 2 + TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vo.track_chunk(il[u * UNIT:(u + 1) * UNIT],
                               ir[u * UNIT:(u + 1) * UNIT])
                torch.cuda.synchronize()
                fps.append(UNIT / (time.perf_counter() - t0))
        out[f"{mode}_fps"] = sorted(fps)
        out[mode] = {k: prof[k] for k in ("busy_ms_per_frame",
                                          "span_ms_per_frame",
                                          "kernels_per_frame", "stages")}
        torch.cuda.synchronize()
    tail = out["eager"]["stages"].get("step_tail", {})
    print(f"[stage-table] {args.path} of {root} on {card}: eager "
          f"{out['eager']['kernels_per_frame']:.1f} kernels and "
          f"{out['eager']['busy_ms_per_frame']:.3f} busy ms per frame, graph "
          f"{out['graph']['kernels_per_frame']:.1f} and "
          f"{out['graph']['busy_ms_per_frame']:.3f}; step_tail "
          f"{tail.get('kernels')} kernels and {tail.get('span_busy_ms')} "
          f"busy ms per frame (eager unit); frames/s graph "
          f"{', '.join(f'{x:.2f}' for x in out['graph_fps'])}, eager "
          f"{', '.join(f'{x:.2f}' for x in out['eager_fps'])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
