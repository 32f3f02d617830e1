"""Frames/s of chip_smoke.py's timed paths 5 and 8a in one tree, for a
comparison of two trees on one card in turns.

Run from a checkout (or give its root with --root): the script imports that
tree's chip_smoke.py and lvt_tpu_torch, so two trees are compared by running
it in each in turn, in one call to the card, e.g. parent, change, change,
parent:

    for r in parent . . parent; do
        python scripts/torch_path_turns.py --root $r --label $r
    done

Each path runs as chip_smoke.py runs it (``_run_modes``: the graphed step
and an eager one on the same frames, unit by unit in turns, at the path's
RUNS settings): path 5, the rectified EuRoC step; path 8a, ShardedStreamVO
on one NCCL rank with the shipped KITTI YAML's local BA (BA's torch body
and its all-reduces in a CUDA IF node). Prints one JSON line per path:
median and spread of frames/s, graph and eager, capture seconds, and the
card's name and power limit. Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=".", help="the tree to run")
    p.add_argument("--label", default=None, help="names the tree's lines")
    p.add_argument("--paths", nargs="+", default=["path5", "path8a"],
                   choices=["path5", "path8a"])
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch_path_turns needs one CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.phase_device()
    label = args.label or root
    for path in args.paths:
        if path == "path5":
            from lvt_tpu_torch.core.system import VOSystem

            config, maps, il, ir, _ = cs.euroc_setup()
            chunk, n_units = cs.RUNS[path]
            a, b = il.to(cs.DEVICE), ir.to(cs.DEVICE)
            run = cs._run_modes(
                path, lambda: VOSystem(config, device=cs.DEVICE,
                                       rectify_maps=maps),
                cs._chunks_of(a, b, chunk), n_units, chunk)
            rep = cs._report_modes(path, run)
        else:
            from lvt_tpu_torch import bench
            from lvt_tpu_torch.configs import kitti_config
            from lvt_tpu_torch.parallel import mesh
            from lvt_tpu_torch.parallel.sharded_stream import ShardedStreamVO
            import torch.distributed as dist

            chunk, n_units = cs.RUNS[path]
            il, ir, _, _ = bench.render(kitti_config(), chunk * n_units)
            a, b = (torch.from_numpy(x).to(cs.DEVICE) for x in (il, ir))
            config = cs.sharded_config()
            with tempfile.TemporaryDirectory() as tmp:
                mesh.init("nccl", 1, 0, "file://" + os.path.join(tmp, "rdv"),
                          device=cs.DEVICE)
                try:
                    run = cs._run_modes(
                        path, lambda: ShardedStreamVO(config,
                                                      device=cs.DEVICE),
                        cs._chunks_of(a, b, chunk), n_units, chunk)
                    rep = cs._report_modes(path, run)
                finally:
                    dist.destroy_process_group()
        print(json.dumps(dict(
            tree=label, path=path, fps=rep["fps"],
            fps_eager=rep["fps_eager"], fps_spread=rep["fps_spread"],
            capture_s=rep["capture_s"], card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
