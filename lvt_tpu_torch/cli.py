"""Command line of the port: the reference's three example drivers
(examples/kitti, examples/euroc, examples/tum_rgbd), a dataset-free
synthetic run and the benchmark, as lvt_tpu/cli.py has them.

    python -m lvt_tpu_torch kitti --sequences-dir D --seq 0 [--output 00.txt]
    python -m lvt_tpu_torch euroc --root D --dataset MH_01_easy [--output MH_01_easy.txt]
    python -m lvt_tpu_torch tum   --dataset-dir D [--freiburg 1] [--output tum_trajectory.txt]
    python -m lvt_tpu_torch synthetic [--frames 30]
    python -m lvt_tpu_torch bench [--ba] [--multistream [--streams 8]]

``bench`` is lvt_tpu's bench.py and its three modes (lvt_tpu_torch/bench.py):
one JSON line of frames/s per card on a synthetic KITTI-geometry sequence.

Every subcommand takes ``--device`` (default ``cuda``; without CUDA the
run fails instead of falling back to the CPU). Trajectories are written
in the formats the reference writes (KITTI 3x4 rows, TUM stamped
quaternions), byte for byte as lvt_tpu writes them for equal poses, so the
KITTI devkit, evo and the TUM scripts read them unchanged.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


def _progress(i, n, t0):
    dt = time.perf_counter() - t0
    fps = (i + 1) / dt if dt > 0 else 0.0
    sys.stdout.write(f"\rframe {i + 1}/{n}  ({fps:.1f} fps)")
    sys.stdout.flush()


def _make_viz(args):
    if not getattr(args, "viz", None):
        return None
    from lvt_tpu_torch.viz_html import HtmlMapViewer

    return HtmlMapViewer(args.viz)


def _finish_viz(viz):
    if viz is not None:
        print(f"viewer written to {viz.write_viewer()}")


def _track_sequence(vo, seq, chunk: int, viz=None):
    """The tracking loop of the three drivers; returns the poses on the
    host, up to and including the first LOST frame (the reference drivers
    stop there, kitti_example.cpp:133-137). Frames are decoded ``chunk``
    at a time, so only one chunk is in host memory (a whole EuRoC sequence
    would be 2.5 GB); ``chunk`` 1 is the online mode, one ``track`` call
    per frame. After each chunk (or frame) the host reads its status and
    poses in one transfer, the loop's only read of the device."""
    from lvt_tpu_torch.core.state import LOST
    from lvt_tpu_torch.geometry.se3 import Pose

    n = len(seq)
    poses = []
    t0 = time.perf_counter()
    it = iter(seq)
    while True:
        block = list(itertools.islice(it, max(chunk, 1)))
        if not block:
            break
        a = np.stack([f[0] for f in block])
        b = np.stack([f[1] for f in block])
        if chunk > 1:
            p, m = vo.track_chunk(a, b)
            status = m.status
        else:
            p = vo.track(a[0], b[0])
            p = Pose(p.t[None], p.q[None])
            status = vo.last_metrics.status[None]
        host = torch.cat([status[:, None].double(), p.t.double(),
                          p.q.double()], -1).cpu().numpy()
        lost = np.nonzero(host[:, 0] == LOST)[0]
        keep = int(lost[0]) + 1 if lost.size else len(block)
        for row in host[:keep]:
            poses.append(Pose(torch.from_numpy(row[1:4]).float(),
                              torch.from_numpy(row[4:8]).float()))
        if viz is not None:
            viz.update(vo)   # one snapshot per chunk
        _progress(len(poses) - 1, n, t0)
        if lost.size:
            break
    total = time.perf_counter() - t0
    print(f"\nAverage frame processing time: {total / max(len(poses), 1):.4f}s")
    return poses


def _recorder(args):
    from lvt_tpu_torch.observability import ValueRecorder

    return ValueRecorder() if args.record else None


def _finish(recorder, out):
    print(f"trajectory written to {out}")
    if recorder is not None:
        recorder.finish()
    return 0


def run_kitti(args) -> int:
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.device import resolve_device
    from lvt_tpu_torch.io.datasets import KittiSequence
    from lvt_tpu_torch.io.trajectory import dump_kitti

    device = resolve_device(args.device)
    seq = KittiSequence(args.sequences_dir, args.seq, args.calib)
    cfg_path = args.config or os.path.join(CONFIG_DIR, "kitti",
                                           "vo_config.yaml")
    config = seq.configure(load_config(cfg_path))
    recorder = _recorder(args)
    vo = VOSystem(config, metrics_recorder=recorder, device=device)
    viz = _make_viz(args)
    poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    out = args.output or f"{args.seq:02d}.txt"
    dump_kitti(out, poses)
    return _finish(recorder, out)


def run_euroc(args) -> int:
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.device import resolve_device
    from lvt_tpu_torch.io.datasets import EurocSequence, euroc_body_pose
    from lvt_tpu_torch.io.trajectory import dump_tum

    device = resolve_device(args.device)
    seq = EurocSequence(args.root, args.dataset, args.stamps)
    cfg_path = args.config or os.path.join(CONFIG_DIR, "euroc",
                                           "vo_config.yaml")
    config = seq.configure(load_config(cfg_path))
    recorder = _recorder(args)
    # raw frames in: the rectification remap runs inside the step
    vo = VOSystem(config, metrics_recorder=recorder,
                  rectify_maps=(seq.map_l, seq.map_r), device=device)
    viz = _make_viz(args)
    cam_poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    poses = [euroc_body_pose(p) for p in cam_poses]
    out = args.output or f"{args.dataset}.txt"
    dump_tum(out, poses, seq.stamps[:len(poses)])
    return _finish(recorder, out)


def run_tum(args) -> int:
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import SensorType, VOSystem
    from lvt_tpu_torch.device import resolve_device
    from lvt_tpu_torch.io.datasets import TumRgbdSequence
    from lvt_tpu_torch.io.trajectory import dump_tum

    device = resolve_device(args.device)
    seq = TumRgbdSequence(args.dataset_dir, args.association)
    cfg_path = args.config or os.path.join(
        CONFIG_DIR, "tum_rgbd", f"config_tum{args.freiburg}.yaml")
    config = load_config(cfg_path)
    recorder = _recorder(args)
    vo = VOSystem(config, SensorType.RGBD, metrics_recorder=recorder,
                  device=device)
    viz = _make_viz(args)
    poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    out = args.output or "tum_trajectory.txt"
    dump_tum(out, poses, seq.stamps[:len(poses)])
    return _finish(recorder, out)


def run_synthetic(args) -> int:
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld, ate_rmse

    world = SyntheticWorld()
    config = VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=160,
        max_keypoints_per_cell=100, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=200.0,
    )
    vo = VOSystem(config, device=args.device)
    viz = _make_viz(args)
    est, gt = [], []
    t0 = time.perf_counter()
    for i, (img_l, img_r, (_, t)) in enumerate(
            world.stereo_sequence(args.frames, speed=0.8)):
        pose = vo.track(img_l, img_r)
        est.append(pose.t.cpu().numpy())
        gt.append(t)
        if viz is not None:
            viz.update(vo)
        _progress(i, args.frames, t0)
    _finish_viz(viz)
    err = ate_rmse(np.array(est), np.array(gt))
    dist = float(np.linalg.norm(gt[-1] - gt[0]))
    print(f"\nstatus: {vo.get_state().name}")
    print(f"ATE RMSE: {err:.3f} m over {dist:.1f} m trajectory "
          f"({100 * err / dist:.2f}%)")
    return 0


def _common(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no fallback to "
                             "the CPU)")
    parser.add_argument("--viz", default=None, metavar="DIR",
                        help="write a browsable 3-D map viewer "
                             "(viewer.html)")


def _dataset(parser) -> None:
    _common(parser)
    parser.add_argument("--config", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--chunk", type=int, default=16,
                        help="frames per dispatch (1 = online mode)")
    parser.add_argument("--record", action="store_true",
                        help="write per-frame metrics CSV (measurments.txt)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lvt-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="run a KITTI odometry sequence")
    k.add_argument("--sequences-dir", required=True)
    k.add_argument("--seq", type=int, required=True)
    k.add_argument("--calib", default=None)
    _dataset(k)
    k.set_defaults(fn=run_kitti)

    e = sub.add_parser("euroc", help="run a EuRoC MAV sequence")
    e.add_argument("--root", required=True)
    e.add_argument("--dataset", required=True)
    e.add_argument("--stamps", default=None)
    _dataset(e)
    e.set_defaults(fn=run_euroc)

    t = sub.add_parser("tum", help="run a TUM RGB-D sequence")
    t.add_argument("--dataset-dir", required=True)
    t.add_argument("--association", default=None)
    t.add_argument("--freiburg", type=int, default=1, choices=(1, 2, 3))
    _dataset(t)
    t.set_defaults(fn=run_tum)

    s = sub.add_parser("synthetic", help="dataset-free synthetic stereo run")
    s.add_argument("--frames", type=int, default=30)
    _common(s)
    s.set_defaults(fn=run_synthetic)

    from lvt_tpu_torch import bench

    b = sub.add_parser("bench", help="the benchmark: frames/s per card on "
                                     "synthetic KITTI-geometry frames")
    bench.add_arguments(b)
    b.set_defaults(fn=bench.run)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
