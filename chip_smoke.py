#!/usr/bin/env python3
"""Smoke run of lvt_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Phases, one line each; any failure raises
and the script exits non-zero without printing the final line:

1. device: the card's name and power limit, then the build of the CUDA
   kernels (``lvt_tpu_torch/csrc/*.cu``, one nvcc per source for sm_90a,
   in parallel) with its seconds;
2. kernels: A (perception), B (dense BRIEF planes), P (patches) and T
   (masked top-2) against their plain PyTorch versions on the card, at the
   main paths' shapes (a uint8 KITTI pair, its [2, 376, 1241] box sums,
   1536 keypoints, 1024x1536 dual and single radius, 1536x1536 row mode)
   -- bit for bit -- with median times of both;
3. path 1, the main path (patch descriptors, BA off): a synthetic
   KITTI-geometry stereo sequence (uint8, as bench.py builds it) through
   ``VOSystem(config, device="cuda").track_chunk`` in chunks of 16; the
   final status must be TRACKING, the ATE under 5% of the distance
   travelled, and the kernels must have launched (A and P once per frame,
   T three times). Prints the host syncs of one chunk under
   ``torch.cuda.set_sync_debug_mode("warn")`` and the frames/s of the
   timed chunks; then the card against the CPU: frame 0's features bit for
   bit, and the poses of frames 0-3 within 1e-3 m;
4. path 2, the shipped KITTI config (lvt_tpu/configs/kitti/vo_config.yaml:
   local BA, window 4 every 4 frames) in the dense descriptor mode, 48
   frames in the same way: A, B once per frame and T four times; the
   number of frames that ran BA (read once after the run) must be the
   schedule's; then the card against the CPU over frames 0-8 (two BA runs);
5. a JSON line with each kernel's launches, error and times, then the
   last line ``{"ok": true, "device": {...}}``.

Every kernel's launch count is set to 0 just before a path runs and read
just after it; the comparisons of phase 2 are not counted.

``--profile DIR`` also writes a torch.profiler table of one tracked chunk
to DIR. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CHUNK = 16
# chunk 0 warms up, chunk 1 counts host syncs, the rest are timed
N_CHUNKS = {"path1": 5, "path2": 3}
N_CPU_FRAMES = {"path1": 4, "path2": 9}
REPS = 20
DEVICE = "cuda"

KERNELS = {
    # name: (route, source, TPU kernel it replaces)
    "perception": ("cuda", "lvt_tpu_torch/csrc/perception.cu",
                   "lvt_tpu/ops/perception_pallas.py:153"),
    "brief": ("cuda", "lvt_tpu_torch/csrc/brief.cu",
              "lvt_tpu/ops/perception_pallas.py:288"),
    "patches": ("cuda", "lvt_tpu_torch/csrc/patches.cu",
                "lvt_tpu/ops/patches_pallas.py:109"),
    "top2": ("cuda", "lvt_tpu_torch/csrc/top2.cu",
             "lvt_tpu/ops/top2_pallas.py:35"),
}
# launches each path needs per frame
NEED_PER_FRAME = {
    "path1": {"perception": 1, "patches": 1, "top2": 3},
    "path2": {"perception": 1, "brief": 1, "top2": 4},
}


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _median_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` launches, each bracketed by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _max_abs_err(got, want) -> float:
    """Largest absolute difference over paired output tensors (exactness
    itself is checked with torch.equal)."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _require_equal(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        torch.cuda.synchronize()
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(
                f"{name}: output {i} differs from the plain version "
                f"(max abs err {_max_abs_err([g], [w])})")


def _world(config):
    from lvt_tpu.io.synthetic import SyntheticWorld

    # bench.py's KITTI-geometry world
    return SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )


def _kitti_config():
    """Path 1: KITTI sequence 00 geometry, patch descriptors, BA off."""
    from __graft_entry__ import _kitti_config as config

    return config()


def _kitti_ba_dense_config():
    """Path 2: the shipped KITTI YAML (local BA on) with sequence 00's
    calibration and frame size, in the dense descriptor mode."""
    from lvt_tpu.config import load_config, load_kitti_calib

    cfg_dir = os.path.join(ROOT, "lvt_tpu", "configs", "kitti")
    calib = load_kitti_calib(os.path.join(cfg_dir, "00.yaml"))
    return load_config(os.path.join(cfg_dir, "vo_config.yaml"), **calib,
                       img_width=1241, img_height=376,
                       descriptor_mode="dense")


def phase_device() -> str:
    from lvt_tpu_torch import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs one CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _say("device", f"{name}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}")
    print(smi.splitlines()[0], flush=True)
    kernels.build(verbose=True)
    kernels.lib()
    _say("device", f"kernels built in {kernels.build_seconds:.2f} s "
                   f"({kernels.library_path().name})")
    return name


def phase_kernels(config, frame_l, frame_r) -> dict:
    """Each kernel against its plain version on the card, bit for bit."""
    from lvt_tpu_torch.core.extract import _spread_ties
    from lvt_tpu_torch.ops import detect, hamming
    from lvt_tpu_torch.ops import patches as pt
    from lvt_tpu_torch.ops import perception, top2

    dev = torch.device(DEVICE)
    rs = np.random.RandomState(0)
    report = {}

    # ---- A: a uint8 KITTI stereo pair
    imgs = torch.from_numpy(np.stack([frame_l, frame_r])).to(dev)
    kern = perception.perception_patch_maps_batched(imgs)
    plain = perception.perception_plain(imgs)
    _require_equal("perception", kern, plain)
    report["perception"] = dict(
        max_abs_err=_max_abs_err(kern, plain),
        ms=_median_ms(lambda: perception.perception_patch_maps_batched(imgs)),
        plain_ms=_median_ms(lambda: perception.perception_plain(imgs)))

    # ---- B: the dense BRIEF planes of that pair's box sums
    nms, raw, smooth = kern
    kern = [perception.brief_planes(smooth)]
    plain = [perception.brief_planes_plain(smooth)]
    _require_equal("brief", kern, plain)
    report["brief"] = dict(
        max_abs_err=_max_abs_err(kern, plain),
        ms=_median_ms(lambda: perception.brief_planes(smooth)),
        plain_ms=_median_ms(lambda: perception.brief_planes_plain(smooth)))

    # ---- P: the selected corners of that pair, padded to kp_capacity
    h, w = imgs.shape[1:]
    det = detect.select_corners(
        nms, config.agast_threshold, cell_size=config.detection_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        corners_low_threshold=config.corners_low_threshold,
        img_hw=(h, w), spread_ties=_spread_ties(imgs))
    cap = config.kp_capacity
    pad = cap - det.valid.shape[1]
    xi = torch.nn.functional.pad(det.kp_int[..., 0], (0, pad))
    yi = torch.nn.functional.pad(det.kp_int[..., 1], (0, pad))
    valid = torch.nn.functional.pad(det.valid, (0, pad))
    xc, yc = pt.clamp_coords(xi, yi, h, w)
    args = (smooth, raw, xc.contiguous(), yc.contiguous(), valid.contiguous())
    kern = pt.extract_patches_batched(*args)
    plain = pt.extract_patches_plain(*args)
    _require_equal("patches", kern, plain)
    report["patches"] = dict(
        max_abs_err=_max_abs_err(kern, plain),
        ms=_median_ms(lambda: pt.extract_patches_batched(*args)),
        plain_ms=_median_ms(lambda: pt.extract_patches_plain(*args)))

    # ---- T: map match (dual radius), staged re-match (single), row match
    m, k = config.max_map_points, cap
    r = float(config.tracking_radius)

    def desc(n):
        return torch.from_numpy(
            rs.randint(-2**31, 2**31, (n, 8), dtype=np.int64)
            .astype(np.int32)).to(dev)

    def uv(n):
        return torch.from_numpy(np.stack(
            [rs.uniform(0, w, n), rs.uniform(0, h, n)], -1)
            .astype(np.float32)).to(dev)

    def mask(n, p):
        return torch.from_numpy(rs.rand(n) < p).to(dev)

    t_desc, t_kp, t_valid = desc(k), uv(k), mask(k, 0.8)
    dist_map = hamming.hamming_matrix(desc(m), t_desc)
    q_uv, q_valid = uv(m), mask(m, 0.9)
    y_l = torch.floor(uv(k)[:, 1])
    vr = config.row_matching_vertical_search_radius
    window = torch.stack([torch.clamp(y_l - vr, min=0.0),
                          torch.clamp(y_l + vr, max=float(h))], -1)
    sites = {
        "dual": (dist_map, q_uv, q_valid, t_kp, t_valid,
                 dict(r2a=r * r, r2b=4 * r * r)),
        "single": (dist_map, q_uv, q_valid, t_kp, t_valid,
                   dict(r2a=r * r, r2b=r * r)),
        "row": (hamming.hamming_matrix(desc(k), t_desc), window,
                mask(k, 0.6), t_kp, t_valid,
                dict(r2a=0.0, r2b=0.0, row_mode=True)),
    }
    t_rep = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, sites={})
    for site, (dist, qm, qv, tm, tv, kw) in sites.items():
        def run_k():
            return top2.masked_dual_top2(dist, qm, qv, tm, tv, **kw)

        def run_p():
            return top2.masked_dual_top2_plain(dist, qm, qv, tm, tv, **kw)

        kern = [x for pair in run_k() for x in pair]
        plain = [x for pair in run_p() for x in pair]
        _require_equal(f"top2/{site}", kern, plain)
        err = _max_abs_err(kern, plain)
        ms, plain_ms = _median_ms(run_k), _median_ms(run_p)
        t_rep["sites"][site] = dict(ms=ms, plain_ms=plain_ms)
        t_rep["max_abs_err"] = max(t_rep["max_abs_err"], err)
        # one frame of the main path runs each site once
        t_rep["ms"] += ms
        t_rep["plain_ms"] += plain_ms
    report["top2"] = t_rep

    for name, rep in report.items():
        _say("kernels", f"{name}: bit-exact vs plain, kernel "
                        f"{rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms "
                        f"(median of {REPS})")
    return report


def _counters():
    from lvt_tpu_torch.ops import patches, perception, top2

    return {"perception": perception.perception_patch_maps_batched,
            "brief": perception.brief_planes,
            "patches": patches.extract_patches_batched,
            "top2": top2.masked_dual_top2}


def phase_path(path, config, il, ir, gt, profile_dir=None):
    """One path: VOSystem.track_chunk on the card, chunk by chunk."""
    from lvt_tpu.io.synthetic import ate_rmse
    from lvt_tpu_torch.core.system import TrackingState, VOSystem

    n = il.shape[0]
    vo = VOSystem(config, device=DEVICE)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    poses_t, poses, ba_ran = [], [], []
    syncs = None
    t_timed = 0.0
    for c in range(n // CHUNK):
        a, b = il[c * CHUNK:(c + 1) * CHUNK], ir[c * CHUNK:(c + 1) * CHUNK]
        torch.cuda.synchronize()
        if c == 1:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    p, m = vo.track_chunk(a, b)
                    torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("called a synchronizing CUDA operation" in str(x.message)
                        for x in caught)
        else:
            t0 = time.perf_counter()
            p, m = vo.track_chunk(a, b)
            torch.cuda.synchronize()
            if c >= 2:
                t_timed += time.perf_counter() - t0
        poses.append(p)
        ba_ran.append(m.local_ba_ran)
        poses_t.append(p.t.cpu().numpy())
    launches = {k: fn.launches for k, fn in counters.items()}
    n_ba = int(torch.cat(ba_ran).sum())
    window, every = config.local_ba_window, config.local_ba_every
    # every frame tracks; BA runs once the window is full, on its schedule
    want_ba = (sum(f >= window and f % every == 0 for f in range(n))
               if window > 0 else 0)

    status = vo.get_state()
    est = np.concatenate(poses_t)
    err = ate_rmse(est, gt[:n])
    dist = float(np.linalg.norm(gt[n - 1] - gt[0]))
    timed_frames = n - 2 * CHUNK
    fps = timed_frames / t_timed
    _say(path, f"{n} frames {il.shape[1]}x{il.shape[2]} uint8 in chunks of "
               f"{CHUNK}, descriptor mode {config.descriptor_mode or 'patch'}, "
               f"BA window {window}: status {status.name}, map {vo.map_size} "
               f"points")
    _say(path, f"host syncs in one tracked chunk "
               f"(set_sync_debug_mode warn): {syncs}")
    _say(path, f"{fps:.2f} frames/s over {timed_frames} timed frames "
               f"(after a warm-up chunk and the sync-count chunk)")
    _say(path, f"ATE RMSE {err:.4f} m over {dist:.2f} m "
               f"({100 * err / dist:.3f}%)")
    _say(path, f"frames that ran local BA: {n_ba} (schedule: {want_ba})")
    _say(path, f"launches during the run: {launches}")
    if status != TrackingState.TRACKING:
        raise AssertionError(f"{path}: final status {status.name}, not TRACKING")
    if not err < 0.05 * dist:
        raise AssertionError(
            f"{path}: ATE {err:.4f} m is not under 5% of {dist:.2f} m")
    if n_ba != want_ba:
        raise AssertionError(f"{path}: {n_ba} frames ran BA, the schedule "
                             f"says {want_ba}")
    need = {k: v * n for k, v in NEED_PER_FRAME[path].items()}
    short = {k: (launches[k], v) for k, v in need.items() if launches[k] < v}
    if short:
        raise AssertionError(
            f"{path}: kernels launched too rarely (got, need): {short}")

    if profile_dir:
        _profile(vo, il[-CHUNK:], ir[-CHUNK:], os.path.join(profile_dir, path))
    from lvt_tpu_torch.tree import tree_map

    first = tree_map(lambda *xs: torch.cat(xs)[:N_CPU_FRAMES[path]], *poses)
    return dict(launches=launches, first_poses=first, fps=fps, syncs=syncs)


STAGES = ("perception", "corner_select", "patch_extract", "describe_refine",
          "corner_select_describe", "motion_predict", "map_matching",
          "pnp_solve", "map_bookkeeping", "staged_update", "triangulation",
          "local_ba")


def _profile(vo, a, b, out_dir):
    """torch.profiler over one chunk: the op table, and host and device
    time per stage (the profiler ranges of core/step.py and extract.py)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vo.track_chunk(a, b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    n = a.shape[0]
    lines = [f"{'stage':<16} {'host ms/frame':>14} {'device ms/frame':>16}"]
    for e in events:
        if e.key in STAGES:
            dev = getattr(e, "device_time_total", None)
            dev = e.cuda_time_total if dev is None else dev
            lines.append(f"{e.key:<16} {e.cpu_time_total / 1e3 / n:>14.3f} "
                         f"{dev / 1e3 / n:>16.3f}")
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    for line in lines:
        _say("profile", line)
    _say("profile", f"op table of one chunk written to {out_dir}")


def phase_cpu(path, config, il, ir, first_poses):
    """The first frames of a path again through the port on the CPU."""
    from lvt_tpu_torch.core.extract import extract_features_stereo
    from lvt_tpu_torch.core.system import VOSystem

    cuda_feats = extract_features_stereo(il[0], ir[0], config)
    cpu_feats = extract_features_stereo(il[0].cpu(), ir[0].cpu(), config)
    for side, g, c in zip(("left", "right"), cuda_feats, cpu_feats):
        g = type(g)(*(x.cpu() for x in g))
        if not torch.equal(g.valid, c.valid):
            raise AssertionError(
                f"{path} frame 0 {side}: valid differs card vs CPU")
        v = c.valid
        for field in ("kp", "desc"):
            if not torch.equal(getattr(g, field)[v], getattr(c, field)[v]):
                raise AssertionError(
                    f"{path} frame 0 {side}: {field} differs card vs CPU")
    n = N_CPU_FRAMES[path]
    vo = VOSystem(config, device="cpu")
    poses, _ = vo.track_chunk(il[:n].cpu(), ir[:n].cpu())
    dt = float((poses.t - first_poses.t.cpu()).abs().max())
    _say(path, f"card vs CPU: frame 0 features bit-equal "
               f"({int(cpu_feats[0].valid.sum())} + "
               f"{int(cpu_feats[1].valid.sum())} valid); poses of frames "
               f"0-{n - 1} differ by at most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(
            f"{path}: CPU vs card pose difference {dt} m >= 1e-3 m")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler table of one chunk to DIR")
    args = p.parse_args(argv)

    name = phase_device()
    configs = {"path1": _kitti_config(), "path2": _kitti_ba_dense_config()}
    n = CHUNK * max(N_CHUNKS.values())
    frames = list(_world(configs["path1"]).stereo_sequence(n, speed=0.9))
    il = torch.from_numpy(np.stack([f[0].astype(np.uint8) for f in frames]))
    ir = torch.from_numpy(np.stack([f[1].astype(np.uint8) for f in frames]))
    gt = np.array([f[2][1] for f in frames])

    report = phase_kernels(configs["path1"], il[0].numpy(), ir[0].numpy())
    il, ir = il.to(DEVICE), ir.to(DEVICE)
    torch.cuda.synchronize()
    runs = {}
    for path, config in configs.items():
        k = CHUNK * N_CHUNKS[path]
        runs[path] = phase_path(path, config, il[:k], ir[:k], gt,
                                args.profile)
        phase_cpu(path, config, il, ir, runs[path]["first_poses"])

    print(json.dumps({"kernels": [
        dict(name=k, route=KERNELS[k][0], source=KERNELS[k][1],
             replaces=KERNELS[k][2],
             launches=sum(r["launches"][k] for r in runs.values()),
             launches_by_path={p: r["launches"][k] for p, r in runs.items()},
             **report[k])
        for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
