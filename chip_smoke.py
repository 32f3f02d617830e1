#!/usr/bin/env python3
"""Smoke run of lvt_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Phases, one line each; any failure raises
and the script exits non-zero without printing the final line:

1. device: the card's name and power limit, its SM count and maximum SM
   clock (for the bounds below), then the build of the CUDA kernels
   (``lvt_tpu_torch/csrc/*.cu``, one nvcc per source for sm_90a, in
   parallel, with ptxas's registers and spills) with its seconds;
2. kernels: A (perception), B (dense BRIEF planes), P (describe + refine
   at the keypoints) and T (Hamming distances + masked dual top-2) against
   their plain PyTorch versions on the card, bit for bit, at the main
   paths' shapes: a uint8 KITTI pair and its [2, 376, 1241] maps (A also
   on the same pair made non-integer float32), the 2 x
   1536 keypoint slots selected on it, and T at its four sites with the
   real descriptor sets of two frames (map match, dual radius, 1024 x 1536;
   staged re-match, one radius, 1024 x 1536; row match and BA row match,
   row window, 1536 x 1536). Each kernel is timed as the mean of REPS
   back-to-back launches between one pair of CUDA events (queued while a
   spin kernel holds the card, so host time between launches is not
   counted); the plain versions the same way with PLAIN_REPS; and each
   gets its bound (see ``bound``; A and B also the bound of the
   one-pixel-per-thread designs they replaced) and, where one PyTorch call
   computes the same function, that call's time;
3. path 1, the main path (patch descriptors, BA off): a synthetic
   KITTI-geometry stereo sequence (uint8, as bench.py builds it) through
   ``VOSystem(config, device="cuda").track_chunk`` in chunks of 16; the
   final status must be TRACKING, the ATE under 5% of the distance
   travelled, the host syncs of one chunk (under
   ``torch.cuda.set_sync_debug_mode("warn")``) 0, and the kernels must have
   launched (A and P once per frame, T three times); prints the frames/s of
   the timed chunks; then the card against the CPU: frame 0's features bit
   for bit, and the poses of frames 0-3 within 1e-3 m;
4. path 2, the shipped KITTI config (lvt_tpu_torch/configs/kitti/
   vo_config.yaml: local BA, window 4 every 4 frames) in the dense
   descriptor mode, 48 frames in the same way: A, B once per frame and T
   four times; the number of frames that ran BA (read once after the run)
   must be the schedule's; then the card against the CPU over frames 0-8
   (two BA runs);
5. a JSON line with each kernel's launches, error, times and bound (T per
   site and per frame of each path), then the last line
   ``{"ok": true, "device": {...}}``.

Every kernel's launch count is set to 0 just before a path runs and read
just after it; the comparisons of phase 2 are not counted.

``--profile DIR`` also writes a torch.profiler table of one tracked chunk
per path to DIR, and prints the profiler's mean device time per launch of
each kernel beside the event times of phase 2. Imports nothing of JAX.
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
REPS = 200          # back-to-back launches per kernel timing
PLAIN_REPS = 5      # ... per plain-version timing
DEVICE = "cuda"

KERNELS = {
    # name: (route, source, TPU kernel it replaces)
    "perception": ("cuda", "lvt_tpu_torch/csrc/perception.cu",
                   "lvt_tpu/ops/perception_pallas.py:153"),
    "brief": ("cuda", "lvt_tpu_torch/csrc/brief.cu",
              "lvt_tpu/ops/perception_pallas.py:288"),
    "describe_refine": ("cuda", "lvt_tpu_torch/csrc/patches.cu",
                        "lvt_tpu/ops/patches_pallas.py:109"),
    "hamming_top2": ("cuda", "lvt_tpu_torch/csrc/top2.cu",
                     "lvt_tpu/ops/top2_pallas.py:35"),
}
# the kernels' CUDA function names, as the profiler lists them
SYMBOLS = {"perception": "perception_kernel", "brief": "brief_kernel",
           "describe_refine": "describe_refine_kernel",
           "hamming_top2": "hamming_top2_kernel"}
# launches each path needs per frame
NEED_PER_FRAME = {
    "path1": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path2": {"perception": 1, "brief": 1, "hamming_top2": 4},
}
# kernel T's sites in one frame of each path
T_SITES = {"path1": ("map", "staged", "row"),
           "path2": ("map", "staged", "row", "ba_row")}

# ---- the card model behind every bound
# device memory: H100 SXM, 3.35 TB/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# issue rates per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 32-bit integer
# add/subtract/min/max/logic/compare and float compare on the ALU pipe 64;
# float32 add/multiply 128; population count 16
RATE_PER_SM_CLOCK = {"alu": 64, "fp32": 128, "popc": 16}
# kernel A on uint8 frames, per PAIR of pixels: Hopper's DPX instructions
# take the min or max of 3 values in each of two 16-bit lanes, one
# instruction for two pixels (csrc/perception.cu). FAST: per arc type 16
# windows of 3 and 16 of 9 (3 x 3), then 8 to reduce the 16 arcs (2 x 40),
# and 4 to take the centre off and clamp; NMS: 2 for the earlier
# neighbours, 3 for the later ones and the + 1, 4 to select; box sum: one
# 3-input add per pass of sliding sums (2); 6 byte permutes to unpack the
# three maps' lanes (ALU), then 6 f32 adds. The f32 adds run on their own
# pipe.
A_ALU_PER_PIXEL = (2 * 40 + 4 + 9 + 2 + 6) / 2
A_FP32_PER_PIXEL = 3
# kernel B per pixel: 256 comparisons and 256 bit inserts (the SASS of
# csrc/brief.cu has exactly these: FSETP and a predicated VIADD per bit)
B_ALU_PER_PIXEL = 2 * 256
# the model of the designs these replaced, one pixel per thread in 32-bit
# operations, kept for comparison: A (box 16 adds; FAST 16 differences,
# 2 x 64 min/max in doubling windows, 2 x 15 to reduce the arcs, 3 to
# clamp; NMS 6 max, 2 compares, 1 select), B as above
ONE_PIXEL_ALU_PER_PIXEL = {"perception": 16 + 16 + 128 + 30 + 3 + 9,
                           "brief": 2 * 256}


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bound(card: dict, nbytes: int, ops: dict) -> tuple[float, str]:
    """The least time the card could take for ``nbytes`` of device-memory
    traffic (each input read once, each output written once) and ``ops``
    ({pipe: count} of RATE_PER_SM_CLOCK's pipes, which run side by side):
    the larger of the two, in ms, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    per_s = card["sms"] * card["clock_hz"]
    t_ops = max([n / (RATE_PER_SM_CLOCK[p] * per_s) for p, n in ops.items()],
                default=0.0)
    return ((1e3 * t_bytes, "bytes") if t_bytes >= t_ops
            else (1e3 * t_ops, "operations"))


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls queued
    back to back between one pair of CUDA events. A spin kernel holds the
    card while the host queues the calls, so the host's time between
    launches is not counted; the spin grows until the host has queued them
    all before it ends (or reaches about a second)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]) or cycles >= 1 << 30:
            return ev[1].elapsed_time(ev[2]) / reps
        cycles <<= 2


def _flat(out):
    """Output tensors of a call, nested tuples flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _max_abs_err(got, want) -> float:
    """Largest absolute difference over paired output tensors (exactness
    itself is checked with torch.equal)."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _require_equal(name: str, got, want) -> float:
    got, want = _flat(got), _flat(want)
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, plain {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(
                f"{name}: output {i} differs from the plain version "
                f"(max abs err {_max_abs_err([g], [w])})")
    return _max_abs_err(got, want)


def _measure(card, name, run_k, run_p, nbytes, ops, library=None) -> dict:
    """Kernel vs plain bit for bit, then both timed, the bound, and the
    library call's time (None where no one PyTorch call computes the same
    function)."""
    err = _require_equal(name, run_k(), run_p())
    b_ms, b_by = bound(card, nbytes, ops)
    return dict(max_abs_err=err, ms=device_ms(run_k, REPS),
                plain_ms=device_ms(run_p, PLAIN_REPS), bound_ms=b_ms,
                bound_by=b_by,
                library_ms=None if library is None else device_ms(library,
                                                                  REPS))


def _world(config):
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    # bench.py's KITTI-geometry world
    return SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def phase_device() -> dict:
    from lvt_tpu_torch import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs one CUDA device")
    name = torch.cuda.get_device_name(0)
    _say("device", f"{name}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}")
    print(_smi("name,power.limit"), flush=True)
    card = dict(name=name, sms=torch.cuda.get_device_properties(0)
                .multi_processor_count,
                clock_hz=1e6 * float(_smi("clocks.max.sm").split()[0]))
    _say("device", f"{card['sms']} SMs, max SM clock "
                   f"{card['clock_hz'] / 1e6:.0f} MHz; bounds at "
                   f"{HBM_BYTES_PER_S / 1e12} TB/s and {RATE_PER_SM_CLOCK} "
                   f"per SM per clock")
    kernels.build(verbose=True)
    kernels.lib()
    _say("device", f"kernels built in {kernels.build_seconds:.2f} s "
                   f"({kernels.library_path().name})")
    return card


def _distinct(shape, b, rows, cols) -> int:
    """Distinct map elements that the (b, rows, cols) index triples touch."""
    hit = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    hit[b, rows, cols] = True
    return int(hit.sum())


def kernel_inputs(config, il, ir) -> dict:
    """The kernels' inputs at the main paths' shapes, from two uint8 frames
    per side (``il``, ``ir`` on the card): the first pair; its maps (kernel
    A); its corners selected and padded to kp_capacity with P's arguments;
    and T's arguments at its four sites, from the real descriptor sets of
    both frames."""
    from lvt_tpu_torch.core.extract import _spread_ties, extract_features_stereo
    from lvt_tpu_torch.ops import detect, perception
    from lvt_tpu_torch.ops import patches as pt

    imgs = torch.stack([il[0], ir[0]])
    nms, raw, smooth = perception.perception_patch_maps_batched(imgs)
    h, w = imgs.shape[1:]
    det = detect.select_corners(
        nms, config.agast_threshold, cell_size=config.detection_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        corners_low_threshold=config.corners_low_threshold,
        img_hw=(h, w), spread_ties=_spread_ties(imgs))
    cap = config.kp_capacity
    pad = cap - det.valid.shape[1]
    xi = torch.nn.functional.pad(det.kp_int[..., 0], (0, pad)).contiguous()
    yi = torch.nn.functional.pad(det.kp_int[..., 1], (0, pad)).contiguous()
    sel = torch.nn.functional.pad(det.valid, (0, pad)).contiguous()
    xc, yc = (c.contiguous() for c in pt.clamp_coords(xi, yi, h, w))

    (l0, r0), (l1, _) = (extract_features_stereo(il[i], ir[i], config)
                         for i in (0, 1))
    m, rad = config.max_map_points, float(config.tracking_radius)
    y_l = torch.floor(l0.kp[:, 1])
    vr = config.row_matching_vertical_search_radius
    window = torch.stack([torch.clamp(y_l - vr, min=0.0),
                          torch.clamp(y_l + vr, max=float(h))], -1)
    # the BA row match queries the map-matched features, the triangulation
    # row match the rest: half and half here
    matched = torch.from_numpy(np.random.RandomState(0).rand(cap) < 0.5).to(
        imgs.device)
    sites = {
        # frame 1's features stand for the map and staged points
        "map": ((l1.desc[:m], l0.desc, l1.kp[:m], l1.valid[:m], l0.kp,
                 l0.valid), dict(r2a=rad * rad, r2b=4 * rad * rad)),
        "staged": ((l1.desc[-m:], l0.desc, l1.kp[-m:], l1.valid[-m:], l0.kp,
                    l0.valid & ~matched), dict(r2a=rad * rad, r2b=rad * rad)),
        "row": ((l0.desc, r0.desc, window, l0.valid & ~matched, r0.kp,
                 r0.valid), dict(r2a=0.0, r2b=0.0, row_mode=True)),
        "ba_row": ((l0.desc, r0.desc, window, l0.valid & matched, r0.kp,
                    r0.valid), dict(r2a=0.0, r2b=0.0, row_mode=True)),
    }
    return dict(imgs=imgs, p_args=(smooth, raw, xc, yc, xi, yi, sel, h, w),
                sites={k: (tuple(x.contiguous() for x in a), kw)
                       for k, (a, kw) in sites.items()})


def p_bytes(p_args) -> int:
    """Kernel P's device-memory bytes at these slots: the pool samples and
    5-point raw stencils of the selected slots (distinct pixels), the slot
    inputs (4 int32 + 1 bool) and the outputs (8 int32 + 1 bool + 2 f32)."""
    from lvt_tpu_torch.ops import brief

    smooth, _, xc, yc, _, _, sel, _, _ = p_args
    dev = smooth.device
    bi = torch.arange(sel.shape[0], device=dev)[:, None].expand_as(xc)[sel]
    pool = torch.as_tensor(brief.sample_pool(), device=dev).long()
    stencil = torch.tensor([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]],
                           device=dev)

    def touched(offsets):
        return _distinct(smooth.shape, bi[:, None].expand(-1, len(offsets)),
                         yc[sel].long()[:, None] + offsets[:, 1],
                         xc[sel].long()[:, None] + offsets[:, 0])

    return 4 * (touched(pool) + touched(stencil)) + sel.numel() * (17 + 41)


def t_work(args, kw, out) -> tuple[int, dict]:
    """Kernel T's bytes and operations at one site, from its arguments and
    its (plain) outputs: descriptors, coordinates and flags in; d1, d2,
    best, n_cand for two predicates out; per valid pair the mask test
    (radius: 2 sub, 2 mul, 1 add and 2 compares; window: 2 compares); per
    candidate pair 8 XOR + popcount, 7 adds and 4 to pack and keep the
    key."""
    q_n, t_n = args[0].shape[0], args[1].shape[0]
    n_valid = int(args[3].sum()) * int(args[5].sum())
    n_cand = int(out[1 if kw["r2b"] > kw["r2a"] else 0][3].sum())
    radius = not kw.get("row_mode", False)
    return ((q_n + t_n) * (32 + 8 + 1) + q_n * 2 * (4 + 4 + 8 + 8),
            {"fp32": 5 * n_valid * radius, "alu": 2 * n_valid + 19 * n_cand,
             "popc": 8 * n_cand})


def float_frames(imgs):
    """A non-integer float32 pair from a uint8 one: each pixel plus a
    fraction in [0, 1) drawn with a fixed seed."""
    frac = np.random.RandomState(0).rand(*imgs.shape).astype(np.float32)
    return imgs.float() + torch.from_numpy(frac).to(imgs.device)


def measure_a_b(card, imgs, smooth) -> dict:
    """Kernels A (on a uint8 pair) and B (on its box sums), each against
    its plain version, timed, with its bound and the bound of the
    one-pixel-per-thread model;
    then A on a non-integer float32 pair, bit for bit and timed."""
    from lvt_tpu_torch.ops import perception

    n_px = imgs.numel()
    fimgs = float_frames(imgs)
    rep = {
        "perception": _measure(
            card, "perception",
            lambda: perception.perception_patch_maps_batched(imgs),
            lambda: perception.perception_plain(imgs),
            nbytes=n_px * (1 + 3 * 4),
            ops={"alu": n_px * A_ALU_PER_PIXEL,
                 "fp32": n_px * A_FP32_PER_PIXEL}),
        "brief": _measure(
            card, "brief", lambda: perception.brief_planes(smooth),
            lambda: perception.brief_planes_plain(smooth),
            nbytes=n_px * (4 + 32), ops={"alu": n_px * B_ALU_PER_PIXEL}),
    }
    for name, nbytes in (("perception", 1 + 3 * 4), ("brief", 4 + 32)):
        rep[name]["bound_ms_one_pixel"] = bound(
            card, n_px * nbytes,
            {"alu": n_px * ONE_PIXEL_ALU_PER_PIXEL[name]})[0]
    rep["perception"]["float_frames"] = dict(
        max_abs_err=_require_equal(
            "perception (float32 frames)",
            perception.perception_patch_maps_batched(fimgs),
            perception.perception_plain(fimgs)),
        ms=device_ms(lambda: perception.perception_patch_maps_batched(fimgs),
                     REPS),
        plain_ms=device_ms(lambda: perception.perception_plain(fimgs),
                           PLAIN_REPS))
    return rep


def phase_kernels(card, inp) -> dict:
    """Each kernel against its plain version on the card, bit for bit,
    with times and bounds, on ``kernel_inputs``."""
    from lvt_tpu_torch.ops import brief, top2
    from lvt_tpu_torch.ops import patches as pt

    imgs, args = inp["imgs"], inp["p_args"]
    smooth = args[0]
    report = measure_a_b(card, imgs, smooth)

    # ---- P: the selected corners of that pair, padded to kp_capacity
    xc, yc, sel = args[2], args[3], args[6]
    n_sel = int(sel.sum())
    rows, cols = pt.window_index(xc, yc, brief.PATCH, brief.PATCH_R0,
                                 brief.PATCH_C0)
    b_idx = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None, None]
    report["describe_refine"] = _measure(
        card, "describe_refine", lambda: pt.describe_refine_batched(*args),
        lambda: pt.describe_refine_plain(*args), nbytes=p_bytes(args),
        ops={"alu": n_sel * (2 * brief.N_BITS), "fp32": n_sel * 2 * 6},
        # one advanced-indexing call: the 32x32 smooth windows that the TPU
        # kernel copies out (ops/patches.py::_windows' gather)
        library=lambda: smooth[b_idx, rows, cols])

    # ---- T at its four sites
    t_sites = {}
    for site, (a, kw) in inp["sites"].items():
        nbytes, ops = t_work(a, kw, top2.hamming_top2_plain(*a, **kw))
        t_sites[site] = _measure(
            card, f"hamming_top2/{site}",
            lambda a=a, kw=kw: top2.hamming_top2(*a, **kw),
            lambda a=a, kw=kw: top2.hamming_top2_plain(*a, **kw),
            nbytes=nbytes, ops=ops)
        t_sites[site].update(m=a[0].shape[0], k=a[1].shape[0],
                             candidates=ops["popc"] // 8)
    per_frame = {path: {key: sum(t_sites[s][key] for s in names)
                        for key in ("ms", "plain_ms", "bound_ms")}
                 for path, names in T_SITES.items()}
    report["hamming_top2"] = dict(
        t_sites["map"], site="map",
        max_abs_err=max(s["max_abs_err"] for s in t_sites.values()),
        sites=t_sites, per_frame=per_frame)

    for name, rep in report.items():
        lib = ("" if rep["library_ms"] is None
               else f", library call {rep['library_ms']:.4f} ms")
        _say("kernels", f"{name}: bit-exact vs plain, kernel "
                        f"{rep['ms']:.4f} ms (bound {rep['bound_ms']:.4f} ms, "
                        f"{rep['bound_by']}), plain {rep['plain_ms']:.4f} ms"
                        f"{lib}")
    for name in ("perception", "brief"):
        _say("kernels", f"{name}: bound {report[name]['bound_ms']:.4f} ms "
                        f"(this PR's instruction model), "
                        f"{report[name]['bound_ms_one_pixel']:.4f} ms (one pixel per "
                        f"thread in 32-bit operations)")
    ff = report["perception"]["float_frames"]
    _say("kernels", f"perception on a non-integer float32 pair: bit-exact vs "
                    f"plain, kernel {ff['ms']:.4f} ms, plain "
                    f"{ff['plain_ms']:.4f} ms")
    for site, rep in t_sites.items():
        _say("kernels", f"hamming_top2 at {site} ({rep['m']} x {rep['k']}, "
                        f"{rep['candidates']} candidate pairs): "
                        f"{rep['ms']:.4f} ms (bound {rep['bound_ms']:.4f} ms, "
                        f"{rep['bound_by']}), plain {rep['plain_ms']:.4f} ms")
    for path, rep in per_frame.items():
        _say("kernels", f"hamming_top2 per frame of {path} "
                        f"({' + '.join(T_SITES[path])}): {rep['ms']:.4f} ms, "
                        f"plain {rep['plain_ms']:.4f} ms")
    _say("kernels", f"times: mean of {REPS} back-to-back launches "
                    f"({PLAIN_REPS} for plain versions) between two events")
    return report


def _counters():
    from lvt_tpu_torch.ops import patches, perception, top2

    return {"perception": perception.perception_patch_maps_batched,
            "brief": perception.brief_planes,
            "describe_refine": patches.describe_refine_batched,
            "hamming_top2": top2.hamming_top2}


def phase_path(path, config, il, ir, gt, profile_dir=None):
    """One path: VOSystem.track_chunk on the card, chunk by chunk."""
    from lvt_tpu_torch.core.system import TrackingState, VOSystem
    from lvt_tpu_torch.io.synthetic import ate_rmse

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
    if syncs != 0:
        raise AssertionError(f"{path}: {syncs} host syncs in one chunk")
    need = {k: v * n for k, v in NEED_PER_FRAME[path].items()}
    short = {k: (launches[k], v) for k, v in need.items() if launches[k] < v}
    if short:
        raise AssertionError(
            f"{path}: kernels launched too rarely (got, need): {short}")

    prof = None
    if profile_dir:
        prof = _profile(vo, il[-CHUNK:], ir[-CHUNK:],
                        os.path.join(profile_dir, path))
        busy = prof["busy_ms_per_frame"]
        _say(path, f"device busy {busy:.3f} ms per frame: "
                   f"{100 * busy * fps / 1e3:.1f}% of the unprofiled frame "
                   f"time ({1e3 / fps:.2f} ms)")
    from lvt_tpu_torch.tree import tree_map

    first = tree_map(lambda *xs: torch.cat(xs)[:N_CPU_FRAMES[path]], *poses)
    return dict(launches=launches, first_poses=first, fps=fps, syncs=syncs,
                profile=prof)


STAGES = ("perception", "corner_select", "patch_describe",
          "corner_select_describe", "motion_predict", "map_matching",
          "pnp_solve", "map_bookkeeping", "staged_update", "triangulation",
          "local_ba")


def _device_us(e) -> float:
    dev = getattr(e, "device_time_total", None)
    return e.cuda_time_total if dev is None else dev


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _profile(vo, a, b, out_dir) -> dict:
    """torch.profiler over one chunk: the op table; per stage (the profiler
    ranges of core/step.py and extract.py) the host time and the device
    time of the torch ops' kernels inside it (the hand-written kernels,
    launched through ctypes, are listed on their own); each hand-written
    kernel's launches and mean device time per launch; and the device's
    busy time, the sum of all kernel times."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vo.track_chunk(a, b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    n = a.shape[0]
    lines = [f"{'stage':<22} {'host ms/frame':>14} {'device ms/frame':>16}"]
    for e in events:
        # a range is listed twice: on the host, and as its span on the
        # device's timeline (idle gaps included), which is left out
        if e.key in STAGES and not _on_device(e):
            lines.append(f"{e.key:<22} {e.cpu_time_total / 1e3 / n:>14.3f} "
                         f"{_device_us(e) / 1e3 / n:>16.3f}")
    kernels = {}
    for name, sym in SYMBOLS.items():
        rows = [e for e in events if sym in e.key and e.count > 0
                and _device_us(e) > 0]
        if rows:
            count = sum(e.count for e in rows)
            kernels[name] = dict(launches=count, device_ms=sum(
                _device_us(e) for e in rows) / 1e3 / count)
            lines.append(f"kernel {name:<15} {count:>5} launches, "
                         f"{kernels[name]['device_ms']:.4f} ms each "
                         f"(profiler device time)")
    busy = sum(_device_us(e) for e in events
               if _on_device(e) and e.key not in STAGES) / 1e3
    lines.append(f"device busy {busy:.2f} ms in {n} frames "
                 f"({busy / n:.3f} ms per frame, the sum of kernel times)")
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    for line in lines:
        _say("profile", line)
    _say("profile", f"op table of one chunk written to {out_dir}")
    return dict(kernels, busy_ms_per_frame=busy / n)


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

    card = phase_device()
    from lvt_tpu_torch.configs import kitti_ba_dense_config, kitti_config

    configs = {"path1": kitti_config(), "path2": kitti_ba_dense_config()}
    n = CHUNK * max(N_CHUNKS.values())
    frames = list(_world(configs["path1"]).stereo_sequence(n, speed=0.9))
    il = torch.from_numpy(np.stack([f[0].astype(np.uint8) for f in frames]))
    ir = torch.from_numpy(np.stack([f[1].astype(np.uint8) for f in frames]))
    gt = np.array([f[2][1] for f in frames])

    il, ir = il.to(DEVICE), ir.to(DEVICE)
    report = phase_kernels(card, kernel_inputs(configs["path1"], il[:2],
                                               ir[:2]))
    torch.cuda.synchronize()
    runs = {}
    for path, config in configs.items():
        k = CHUNK * N_CHUNKS[path]
        runs[path] = phase_path(path, config, il[:k], ir[:k], gt,
                                args.profile)
        phase_cpu(path, config, il, ir, runs[path]["first_poses"])

    entries = []
    for k, (route, source, replaces) in KERNELS.items():
        entry = dict(name=k, route=route, source=source, replaces=replaces,
                     launches=sum(r["launches"][k] for r in runs.values()),
                     launches_by_path={p: r["launches"][k]
                                       for p, r in runs.items()},
                     reps=REPS, plain_reps=PLAIN_REPS, **report[k])
        if args.profile:
            entry["profiler_ms_by_path"] = {
                p: r["profile"].get(k, {}).get("device_ms")
                for p, r in runs.items()}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
