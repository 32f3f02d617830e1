#!/usr/bin/env python3
"""lvt_tpu_torch's kernels A, B and T, PnP's fused solve, the corner
selection, the tracking branch's staged promotion and triangulation, the
map match's acceptance, the map's upkeep and the motion model's
prediction and projection of two trees on one NVIDIA GPU, in one run.

    git archive <parent commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_before_after.py --parent build/parent

Runs kernels A (perception), B (dense BRIEF planes) and T (Hamming
top-2, the single-stream call at its four sites), ``pnp_solve``,
``select_corners``, ``staged_promote``, ``triangulate_insert``,
``map_accept``, ``upkeep_pre`` and ``predict_project`` of the parent tree
("old") and of this
tree ("new") in
turns, old, new, new, old, one process each, on the same inputs: those of
``chip_smoke.kernel_inputs`` at the main paths' shapes (a uint8 KITTI
pair, its box sums, and T's arguments from the descriptors of two
frames); PnP problems as ``tests/test_torch_cuda.py`` poses them at M =
1024 and 4096 points and S = 1 and 8 streams; kernel A's maps of path
1's KITTI pair, path 3's 16 images and TUM fr1's one cell (one random
640 x 480 frame) for the selection; the five tracking ops at path 1's,
path 3's and path 5's shapes as ``scripts/torch_track_clocks.py`` poses
them (the ``cuda`` tests' problems); all made once by this tree. Each
process builds its tree's kernels (printing ptxas's registers and
spills) and measures them with this tree's ``chip_smoke.measure_a_b``:
each kernel against its plain version, bit for bit, timed with
``chip_smoke.device_ms``, with ``chip_smoke.bound``; A also on the pair
made non-integer float32; T, the solve, the selection and the tracking
ops timed with ``device_ms`` at each of their shapes. The parent tree's wrappers must
take the same arguments as this tree's.

The script then checks that old and new give the same bits (A's three maps
on both pairs, B's planes, T's, the solve's, the selection's and the
tracking ops' outputs at every shape; NaN where the other has NaN), says
for A, B, the solve, the selection and the tracking ops whether every new
run was faster than every old run, prints T's times, and writes every
run and the mean of each side to ``--out`` (default
``build/before_after/result.json``, under the checkout). It needs the
card: without one it fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "before_after")
ORDER = ("old", "new", "new", "old")
PNP_SHAPES = ((1024, 1), (1024, 8), (4096, 1), (4096, 8))
TRACK_OPS = ("staged_promote", "triangulate_insert", "map_accept",
             "upkeep_pre", "predict_project")


def _smoke():
    """This tree's chip_smoke.py, for its inputs, timing and bounds. Load
    it after the side's lvt_tpu_torch: the package stays the one imported
    first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare(path: str) -> None:
    sys.path.insert(0, ROOT)
    smoke = _smoke()
    from lvt_tpu_torch import bench
    from lvt_tpu_torch.configs import kitti_config

    config = kitti_config()
    left, right = (torch.from_numpy(x).cuda()
                   for x in bench.render(config, 8)[:2])
    inp = smoke.kernel_inputs(config, left[:2], right[:2])
    torch.save(dict(imgs=inp["imgs"], smooth=inp["p_args"][0],
                    t_sites=inp["sites"], pnp=pnp_problems(),
                    select=select_problems(config, left, right),
                    **track_problems()), path)


def _load(name: str, *path: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def track_problems() -> dict:
    """The arguments of TRACK_OPS at scripts/torch_track_clocks.py's
    shapes, on the card."""
    cases = _load("test_torch_cuda", "tests", "test_torch_cuda.py")
    clocks = _load("torch_track_clocks", "scripts", "torch_track_clocks.py")
    out = {name: {} for name in TRACK_OPS}
    for (name, label), (_, args) in clocks.problems(cases, "cuda").items():
        out[name][label] = args
    return out


def pnp_problems() -> dict:
    """The fused solve's arguments at each (M, S) of PNP_SHAPES:
    tests/test_torch_cuda.py's problems, loaded from its file."""
    cases = _load("test_torch_cuda", "tests", "test_torch_cuda.py")
    cam = dict(cases.PNP_CAM, reprojection_th2=5.991)
    return {f"M={m} S={s}": (cases._pnp_problem(np.random.RandomState(m + s),
                                                 s, m, "cuda"),
                              tuple(cam.values()))
            for m, s in PNP_SHAPES}


def select_problems(config, left, right) -> dict:
    """The selection's arguments on kernel A's maps: path 1's KITTI pair,
    path 3's 16 images (8 frames of bench.py's sequence) and TUM fr1's one
    cell of 640 x 480 keeping 1000 (a random frame)."""
    from lvt_tpu_torch.configs import tum_rgbd_config
    from lvt_tpu_torch.ops import perception

    kitti = torch.stack([left, right], 1).flatten(0, 1)
    tum = tum_rgbd_config(1)
    frame = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, tum.img_height, tum.img_width)).astype(np.uint8)).cuda()
    out = {}
    for name, c, imgs in (("path1 KITTI pair", config, kitti[:2]),
                          ("path3 16 images", config, kitti),
                          ("TUM fr1 cell", tum, frame)):
        nms = perception.perception_patch_maps_batched(imgs)[0]
        out[name] = (nms, nms.new_zeros((0,)),
                     nms.new_zeros((0,), dtype=torch.int32),
                     float(c.agast_threshold),
                     c.detection_cell_size, c.max_keypoints_per_cell,
                     c.corners_low_threshold, True, c.kp_capacity)
    return out


def worker(side: str, root: str, inputs: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import lvt_tpu_torch  # noqa: F401  (this side's package, first)
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.ops import detect, matching, perception, top2
    from lvt_tpu_torch.solver import pnp

    smoke = _smoke()
    card = smoke.card_info()
    print(smoke._smi("name,power.limit"), flush=True)
    kernels.build(verbose=True)   # prints ptxas's registers and spills
    inp = torch.load(inputs, map_location="cuda")
    imgs, smooth = inp["imgs"], inp["smooth"]
    rep = smoke.measure_a_b(card, imgs, smooth)
    outs = {"a_uint8": perception.perception_patch_maps_batched(imgs),
            "a_float32": perception.perception_patch_maps_batched(
                smoke.float_frames(imgs)),
            "b": (perception.brief_planes(smooth),)}
    rep["hamming_top2"] = {}
    for site, (a, kw) in inp["t_sites"].items():
        outs[f"t_{site}"] = smoke._flat(top2.hamming_top2(*a, **kw))
        rep["hamming_top2"][site] = dict(ms=smoke.device_ms(
            lambda a=a, kw=kw: top2.hamming_top2(*a, **kw), smoke.REPS))
    for group, op, sites in (("pnp_solve", pnp.pnp_solve_op, inp["pnp"]),
                             ("select_corners", detect.select_corners_op,
                              inp["select"]),
                             *((name, getattr(matching if name == "map_accept"
                                              else track, f"{name}_op"),
                                inp[name]) for name in TRACK_OPS)):
        rep[group] = {}
        for site, args in sites.items():
            args = (*args[0], *args[1]) if group == "pnp_solve" else args
            outs[f"{group}:{site}"] = smoke._flat(op(*args))
            rep[group][site] = dict(ms=smoke.device_ms(
                lambda a=args: op(*a), smoke.REPS))
    torch.save({k: [t.cpu() for t in v] for k, v in outs.items()}, out)
    print(json.dumps(dict(side=side, card=card, kernels=rep)), flush=True)


def _mean(runs, side):
    """Mean over a side's runs of every number of the first run's tree."""
    def avg(vals):
        if isinstance(vals[0], dict):
            return {k: avg([v[k] for v in vals]) for k in vals[0]}
        if isinstance(vals[0], float):
            return sum(vals) / len(vals)
        return vals[0]
    return avg([r["kernels"] for r in runs if r["side"] == side])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="checkout of the parent tree")
    p.add_argument("--out", default=os.path.join(WORK, "result.json"))
    p.add_argument("--side", choices=("old", "new"), help=argparse.SUPPRESS)
    p.add_argument("--root", help=argparse.SUPPRESS)
    p.add_argument("--inputs", help=argparse.SUPPRESS)
    p.add_argument("--result", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.side:
        worker(args.side, args.root, args.inputs, args.result)
        return 0
    if not args.parent:
        p.error("--parent is required")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    os.makedirs(WORK, exist_ok=True)
    inputs = os.path.join(WORK, "inputs.pt")
    prepare(inputs)
    runs, results = [], []
    for i, side in enumerate(ORDER):
        root = args.parent if side == "old" else ROOT
        result = os.path.join(WORK, f"{i}_{side}.pt")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--side", side,
             "--root", root, "--inputs", inputs, "--result", result],
            capture_output=True, text=True, check=False)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"run {i} ({side}) failed:\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        results.append((side, torch.load(result)))
    old = next(r for s, r in results if s == "old")
    new = next(r for s, r in results if s == "new")
    for key in old:
        for a, b in zip(old[key], new[key], strict=True):
            if not (torch.equal(a, b) or (
                    a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                    and torch.equal(a.nan_to_num(), b.nan_to_num()))):
                raise AssertionError(f"{key}: the new kernel differs from "
                                     "the old one")
    print("old and new give the same bits: A's nms, raw and smooth on the "
          "uint8 and the float32 pair, B's planes, T's outputs at "
          f"{', '.join(k[2:] for k in old if k.startswith('t_'))}; "
          f"{', '.join(k for k in old if ':' in k)}", flush=True)
    for group in ("pnp_solve", "select_corners", *TRACK_OPS):
        for site in runs[0]["kernels"][group]:
            ms = [r["kernels"][group][site]["ms"] for r in runs]
            by = {s: [m for m, r in zip(ms, runs) if r["side"] == s]
                  for s in ("old", "new")}
            verdict = ("faster in every run" if max(by["new"]) < min(by["old"])
                       else "NOT faster in every run")
            print(f"{group} {site} ms by run ({', '.join(ORDER)}): {ms}: "
                  f"new {verdict}", flush=True)
    for site in runs[0]["kernels"]["hamming_top2"]:
        print(f"hamming_top2 at {site} ms by run ({', '.join(ORDER)}): "
              f"{[r['kernels']['hamming_top2'][site]['ms'] for r in runs]}",
              flush=True)
    for name in ("perception", "brief"):
        ms = {s: [r["kernels"][name]["ms"] for r in runs if r["side"] == s]
              for s in ("old", "new")}
        verdict = ("faster in every run" if max(ms["new"]) < min(ms["old"])
                   else "NOT faster in every run")
        print(f"{name} ms by run ({', '.join(ORDER)}): "
              f"{[r['kernels'][name]['ms'] for r in runs]}: new {verdict}",
              flush=True)
    summary = {side: _mean(runs, side) for side in ("old", "new")}
    for side, rep in summary.items():
        for name in ("perception", "brief"):
            r = rep[name]
            print(f"{side} {name}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f} ms, {r['bound_by']}; one-pixel model "
                  f"{r['bound_ms_one_pixel']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms", flush=True)
        ff = rep["perception"]["float_frames"]
        print(f"{side} perception on float32 frames: {ff['ms']:.4f} ms, "
              f"plain {ff['plain_ms']:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(order=ORDER, runs=runs, mean=summary), f, indent=1)
    print(f"written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
