"""Command line of the port: ``python -m lvt_tpu_torch synthetic``.

Tracks a dataset-free synthetic stereo sequence (``io/synthetic.py``: the
same world and config as ``python -m lvt_tpu synthetic``) on the given
device and prints the absolute trajectory error. The default device is
``cuda``; without CUDA the run fails instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run_synthetic(args) -> int:
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.io.synthetic import SyntheticWorld, ate_rmse
    from lvt_tpu_torch.core.system import VOSystem

    world = SyntheticWorld()
    config = VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=160,
        max_keypoints_per_cell=100, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=200.0,
    )
    vo = VOSystem(config, device=args.device)
    est, gt = [], []
    t0 = time.perf_counter()
    for i, (img_l, img_r, (_, t)) in enumerate(
            world.stereo_sequence(args.frames, speed=0.8)):
        pose = vo.track(img_l, img_r)
        est.append(pose.t.cpu().numpy())
        gt.append(t)
        print(f"\rframe {i + 1}/{args.frames} "
              f"({(i + 1) / (time.perf_counter() - t0):.1f} frames/s)",
              end="", flush=True)
    err = ate_rmse(np.array(est), np.array(gt))
    dist = float(np.linalg.norm(gt[-1] - gt[0]))
    print(f"\nstatus: {vo.get_state().name}")
    print(f"ATE RMSE: {err:.3f} m over {dist:.1f} m trajectory "
          f"({100 * err / dist:.2f}%)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lvt-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("synthetic", help="dataset-free synthetic stereo run")
    s.add_argument("--frames", type=int, default=30)
    s.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to the CPU)")
    s.set_defaults(fn=run_synthetic)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
