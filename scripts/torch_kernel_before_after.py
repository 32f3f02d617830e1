#!/usr/bin/env python3
"""lvt_tpu_torch's kernels of two trees on one NVIDIA GPU, in one run.

    git archive <parent commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_before_after.py --parent build/parent

Runs the kernels of the parent tree ("old") and of this tree ("new") in
turns, old, new, new, old, one process each, on the same inputs: those of
``chip_smoke.kernel_inputs`` at the main paths' shapes (a uint8 KITTI
pair, its maps, 2 x 1536 selected keypoint slots, kernel T's four sites on
the real descriptor sets of two frames), made once by this tree. Each
process builds its tree's kernels (printing ptxas's registers and spills)
and times them with ``chip_smoke.device_ms`` against its plain versions,
bit for bit, with ``chip_smoke.bound``:

* A and B as they are;
* old P (patch extraction) and old T (masked top-2 over a Hamming matrix)
  alone, and with what this tree's fused kernels absorbed: P's describe and
  refine steps, T's Hamming matrix ("replaced_ms");
* new P (describe + refine) and new T (Hamming + masked top-2).

The script then checks that old and new give the same bits (P's desc,
valid and kp; T's outputs at every site), and writes every run and the
mean of each side to ``--out`` (default ``build/before_after/result.json``,
under the checkout). It needs the card:
without one it fails. The parent tree must be the one whose kernels P and
T are ``extract_patches_batched`` and ``masked_dual_top2``.
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
P_REPS = 50   # the old describe chain is ~20 launches


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
    from lvt_tpu_torch.configs import kitti_config

    config = kitti_config()
    frames = list(smoke._world(config).stereo_sequence(2, speed=0.9))
    il, ir = (torch.from_numpy(np.stack([f[i].astype(np.uint8)
                                         for f in frames])).cuda()
              for i in (0, 1))
    torch.save(smoke.kernel_inputs(config, il, ir), path)


def _old(smoke, card, inp):
    """The parent tree's P and T, alone and with what the fusion absorbed."""
    from lvt_tpu_torch.ops import brief, detect, hamming, patches, top2

    smooth, raw, xc, yc, xi, yi, sel, h, w = inp["p_args"]
    rep = smoke.measure_a_b(card, inp["imgs"], smooth)

    def p_chain():
        pat, rawp = patches.extract_patches_batched(smooth, raw, xc, yc, sel)
        desc, valid = brief.descriptors_from_patches(pat, xi, yi, sel, h, w)
        xf, yf = detect.subpixel_from_patches(rawp, xi, yi)
        return desc, valid, torch.stack([xf, yf], dim=-1)

    # the 32x32 smooth windows at (y - 15, x - 16) and, inside them at
    # (12, 12), the 8x8 raw windows at (y - 3, x - 4)
    off = torch.arange(32, device=xc.device)
    rows = ((yc.long() - 15)[..., None, None] + off[:, None]).expand(
        *xc.shape, 32, 32)
    cols = ((xc.long() - 16)[..., None, None] + off[None, :]).expand(
        *xc.shape, 32, 32)
    bi = torch.arange(smooth.shape[0], device=smooth.device)[:, None, None,
                                                             None]
    bi_sel = bi.expand_as(rows)[sel]
    touched = (smoke._distinct(smooth.shape, bi_sel, rows[sel], cols[sel])
               + smoke._distinct(smooth.shape, bi_sel[..., :8, :8],
                                 rows[sel][..., 12:20, 12:20],
                                 cols[sel][..., 12:20, 12:20]))
    rep["describe_refine"] = dict(
        smoke._measure(
            card, "extract_patches",
            lambda: patches.extract_patches_batched(smooth, raw, xc, yc, sel),
            lambda: patches.extract_patches_plain(smooth, raw, xc, yc, sel),
            # the windows of the selected slots in, the zero-filled patch
            # tensors out (32x32 + 8x8 f32 per slot), 9 B of slot inputs
            nbytes=4 * touched + sel.numel() * (9 + 4 * (32 * 32 + 8 * 8)),
            ops={}, library=lambda: smooth[bi, rows, cols]),
        kernel="extract_patches_batched",
        replaced_ms=smoke.device_ms(p_chain, P_REPS))
    outs = {"p": p_chain(), "t": {}}
    sites = {}
    for site, (a, kw) in inp["sites"].items():
        dist = hamming.hamming_matrix(a[0], a[1])
        targs = (dist,) + a[2:]
        q_n, t_n = dist.shape
        n_valid = int(a[3].sum()) * int(a[5].sum())
        radius = not kw.get("row_mode", False)
        sites[site] = dict(
            smoke._measure(
                card, f"masked_dual_top2/{site}",
                lambda targs=targs, kw=kw: top2.masked_dual_top2(*targs, **kw),
                lambda targs=targs, kw=kw: top2.masked_dual_top2_plain(
                    *targs, **kw),
                # the [M, K] int32 matrix, coordinates and flags in; two
                # predicates' (d1, d2, best, n_cand) out
                nbytes=4 * q_n * t_n + (q_n + t_n) * 9 + q_n * 48,
                ops={"fp32": 5 * n_valid * radius, "alu": 4 * n_valid}),
            replaced_ms=smoke.device_ms(
                lambda a=a, kw=kw: top2.masked_dual_top2(
                    hamming.hamming_matrix(a[0], a[1]), *a[2:], **kw), 50))
        outs["t"][site] = top2.masked_dual_top2(*targs, **kw)
    rep["hamming_top2"] = dict(sites["map"], kernel="masked_dual_top2",
                               sites=sites)
    return rep, outs


def _new(smoke, card, inp):
    """This tree's kernels, as chip_smoke measures them."""
    from lvt_tpu_torch.ops import patches, top2

    rep = smoke.phase_kernels(card, inp)
    outs = {"p": patches.describe_refine_batched(*inp["p_args"]),
            "t": {site: top2.hamming_top2(*a, **kw)
                  for site, (a, kw) in inp["sites"].items()}}
    return rep, outs


def worker(side: str, root: str, inputs: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import lvt_tpu_torch  # noqa: F401  (this side's package, first)

    smoke = _smoke()
    card = smoke.phase_device()
    inp = torch.load(inputs, map_location="cuda")
    rep, outs = (_old if side == "old" else _new)(smoke, card, inp)
    torch.save({"p": [t.cpu() for t in outs["p"]],
                "t": {s: [t.cpu() for t in smoke._flat(o)]
                      for s, o in outs["t"].items()}}, out)
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
    for a, b in zip(old["p"], new["p"]):
        if not torch.equal(a, b):
            raise AssertionError("P: the fused kernel differs from the old "
                                 "patch + describe + refine chain")
    for site in old["t"]:
        for a, b in zip(old["t"][site], new["t"][site]):
            if not torch.equal(a, b):
                raise AssertionError(f"T at {site}: the fused kernel differs "
                                     "from the old matrix + top-2")
    print("old and new give the same bits: P's desc, valid, kp; T at "
          f"{', '.join(old['t'])}", flush=True)
    summary = {side: _mean(runs, side) for side in ("old", "new")}
    for side, rep in summary.items():
        for name in ("perception", "brief", "describe_refine",
                     "hamming_top2"):
            r = rep[name]
            print(f"{side} {r.get('kernel', name)}: {r['ms']:.4f} ms "
                  f"(bound {r['bound_ms']:.4f} ms, {r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, replaced "
                  f"{r.get('replaced_ms', r['ms']):.4f} ms", flush=True)
        for site, r in rep["hamming_top2"]["sites"].items():
            print(f"{side} T at {site}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f} ms), replaced "
                  f"{r.get('replaced_ms', r['ms']):.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(order=ORDER, runs=runs, mean=summary), f, indent=1)
    print(f"written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
