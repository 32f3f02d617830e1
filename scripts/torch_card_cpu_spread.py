#!/usr/bin/env python3
"""How far the card's poses lie from the CPU's over several seeds, for the
scenarios of the card-vs-CPU tests that hold 1e-4 m
(``tests/test_torch_cuda.py``).

    python3 scripts/torch_card_cpu_spread.py [--seeds 8]

Seed 0 rebuilds each test's own inputs, so its line is that test's reading;
seed k > 0 offsets every random seed of the scenario by k (the synthetic
worlds' seeds, the EuRoC point cloud's). Each scenario tracks 4 frames on
the card and on the CPU, as its test does, and prints the largest
difference of a pose's translation and the card's final status; the last
line is a JSON object with every reading. Card and CPU round sums in other
orders, so an LM accept test whose two chi-squares lie within rounding of
each other can go either way on the two devices: the spread over seeds
shows how often that moves a pose past 1e-4 m.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          baseline=0.3, n_points=1500, extent_x=40.0, extent_y=18.0,
          extent_z=90.0)


def _config(**extra):
    from lvt_tpu_torch.config import VOConfig

    return VOConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, baseline=0.3,
                    img_width=320, img_height=240, detection_cell_size=80,
                    max_keypoints_per_cell=60, agast_threshold=15,
                    near_plane_distance=0.5, far_plane_distance=150.0,
                    **extra)


def _stereo(world, n=4):
    frames = list(world.stereo_sequence(n, speed=0.5))
    return (torch.from_numpy(np.stack([f[0].astype(np.uint8) for f in frames])),
            torch.from_numpy(np.stack([f[1].astype(np.uint8) for f in frames])))


def main_path(k, dev):
    """test_main_path_on_the_card_matches_the_cpu."""
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    il, ir = _stereo(SyntheticWorld(**KW, seed=7 + k))
    gpu, cpu = VOSystem(_config(), device=dev), VOSystem(_config(), device="cpu")
    pg, _ = gpu.track_chunk(il.to(dev), ir.to(dev))
    pc, _ = cpu.track_chunk(il, ir)
    return pg.t.cpu(), pc.t, gpu.get_state().name


def multistream(sensor):
    def run(k, dev):
        """test_multistream_on_the_card_matches_the_cpu[sensor]."""
        from lvt_tpu_torch.io.synthetic import SyntheticWorld
        from lvt_tpu_torch.parallel.multistream import MultiStreamVO

        rgbd = sensor == "rgbd"
        worlds = [SyntheticWorld(**KW, seed=7 + k),
                  SyntheticWorld(**KW, seed=99 + k)]
        cfg = _config(triangulation_policy=2 if rgbd else 1)
        seqs = [list(w.rgbd_sequence(4, speed=0.5) if rgbd
                     else w.stereo_sequence(4, speed=0.5)) for w in worlds]
        a = torch.from_numpy(np.stack([[np.clip(f[0], 0, 255).astype(np.uint8)
                                        for f in fs] for fs in zip(*seqs)]))
        b = torch.from_numpy(np.stack([[
            f[1].astype(np.float32) if rgbd
            else np.clip(f[1], 0, 255).astype(np.uint8) for f in fs]
            for fs in zip(*seqs)]))
        gpu = MultiStreamVO(cfg, 2, device=dev, rgbd=rgbd)
        cpu = MultiStreamVO(cfg, 2, device="cpu", rgbd=rgbd)
        pg, _ = gpu.track_chunk(a.to(dev), b.to(dev))
        pc, _ = cpu.track_chunk(a, b)
        return pg.t.cpu(), pc.t, str(gpu.status.tolist())
    return run


def rectified(k, dev):
    """test_rectified_path_on_the_card_matches_the_cpu."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io import datasets

    rs = np.random.RandomState(5 + k)
    points = np.stack([rs.uniform(-15, 15, 2500), rs.uniform(-8, 8, 2500),
                       rs.uniform(2.0, 30.0, 2500)], -1)
    shade = rs.uniform(60.0, 215.0, 2500)
    il, ir = (torch.from_numpy(np.stack([
        datasets.render_euroc_raw(points, shade, np.array([0, 0, 0.2 * i]), rt)
        for i in range(4)])) for rt in (False, True))
    p = datasets.EUROC_P
    cfg = VOConfig(fx=float(p[0, 0]), fy=float(p[1, 1]), cx=float(p[0, 2]),
                   cy=float(p[1, 2]), baseline=datasets.EUROC_BASELINE,
                   img_width=752, img_height=480, agast_threshold=15,
                   detection_cell_size=160, max_keypoints_per_cell=60,
                   near_plane_distance=0.5, far_plane_distance=100.0,
                   staged_threshold=0)
    maps = datasets.euroc_rectify_maps()
    gpu = VOSystem(cfg, device=dev, rectify_maps=maps)
    cpu = VOSystem(cfg, device="cpu", rectify_maps=maps)
    pg, _ = gpu.track_chunk(il.to(dev), ir.to(dev))
    pc, _ = cpu.track_chunk(il, ir)
    return pg.t.cpu(), pc.t, gpu.get_state().name


def external_corners(k, dev):
    """test_external_corners_on_the_card_match_the_cpu."""
    from lvt_tpu_torch.core.extract import extract_features
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    cfg = _config()

    def corners(img):
        f = extract_features(torch.from_numpy(img), cfg)
        return f.kp[f.valid].numpy()

    frames = [(l.astype(np.uint8), r.astype(np.uint8)) for l, r, _ in
              SyntheticWorld(**KW, seed=7 + k).stereo_sequence(4, speed=0.5)]
    seq = [(l, r, corners(l), corners(r)) for l, r in frames]
    gpu, cpu = VOSystem(cfg, device=dev), VOSystem(cfg, device="cpu")
    pg = torch.stack([gpu.track_with_external_corners(*f).t.cpu() for f in seq])
    pc = torch.stack([cpu.track_with_external_corners(*f).t for f in seq])
    return pg, pc, gpu.get_state().name


SCENARIOS = {"main_path": main_path,
             "multistream[stereo]": multistream("stereo"),
             "multistream[rgbd]": multistream("rgbd"),
             "rectified": rectified,
             "external_corners": external_corners}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    out = {}
    for name, run in SCENARIOS.items():
        out[name] = []
        for k in range(args.seeds):
            pg, pc, status = run(k, args.device)
            gap = float((pg - pc).abs().max())
            out[name].append(gap)
            print(f"{name} seed {k}: card vs CPU {gap:.3g} m "
                  f"({'over' if gap > 1e-4 else 'within'} 1e-4 m); card "
                  f"status {status}", flush=True)
        print(f"{name}: largest {max(out[name]):.3g} m, "
              f"{sum(g > 1e-4 for g in out[name])} of {args.seeds} seeds "
              f"over 1e-4 m", flush=True)
    print(json.dumps({"card_vs_cpu_m": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
