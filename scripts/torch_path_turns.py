"""Frames/s of chip_smoke.py's timed paths 1, 2, 3, 5, 6 and 8a in one tree,
for a comparison of two trees on one card in turns.

Run from a checkout (or give its root with --root): the script imports that
tree's chip_smoke.py and lvt_tpu_torch, so two trees are compared by running
it in each in turn, in one call to the card, e.g. parent, change, change,
parent:

    for r in parent . . parent; do
        python scripts/torch_path_turns.py --root $r --label $r
    done

Each path runs as chip_smoke.py runs it (``_run_modes``: the graphed step
and an eager one on the same frames, unit by unit in turns, at the path's
RUNS settings): path 1, VOSystem.track_chunk on the KITTI frames; path 2,
the same with the shipped KITTI YAML in the dense mode (local BA in a CUDA
IF node); path 3,
MultiStreamVO with 8 streams (frames/s summed over the streams); path 5,
the rectified EuRoC step; path 6, one track_with_external_corners call a
frame; path 8a, ShardedStreamVO on one NCCL rank with the shipped KITTI
YAML's local BA (BA's body and its all-reduces in a CUDA IF node).
``--reps`` runs the chosen paths that many times in the process. Prints one
JSON line per path and run: median and spread of frames/s, graph and
eager, the graph's host ms a frame, capture seconds, and the card's name
and power limit; for every path also one more graphed unit traced with
the host's activity (the tree's ``dryrun.traced``): the card's busy ms
and kernels a frame, and the host's launches a frame by runtime-API call
(graph replays apart; the trace's opening markers left out); for path 8a
also the tree's ``chip_smoke._frame_types``: the kernels of a BA frame
and of any other frame (``frame_types``). Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter
from functools import partial

# the runtime API calls that launch work on the card from the host, by
# their names' starts: a graph's replay, and kernels, copies and fills
GRAPH_LAUNCH = "cudaGraphLaunch"
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
            "cuMemset")


def traced_unit(run, drive, n_units: int, chunk: int) -> dict:
    """The graphed system of ``run`` tracks its last unit again under the
    profiler (host and card): busy ms and kernels a frame on the card
    (copies and fills in the busy time, not in the kernels), and the host's
    launches a frame by call, the trace's opening markers left out."""
    import torch
    from torch.autograd import DeviceType

    from lvt_tpu_torch.parallel.dryrun import TRACE_MARKERS, traced

    _, prof = traced(lambda: drive(run["graph"]["system"], n_units - 1),
                     host=True)
    events = list(prof.profiler.kineto_results.events())
    device = [(e.name(), e.end_ns() - e.start_ns()) for e in events
              if e.device_type() == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", lambda: False)()
              and "spin_kernel" not in e.name()]
    host = [e.name() for e in sorted(
        (e for e in events if e.device_type() == DeviceType.CPU
         and e.name().startswith((GRAPH_LAUNCH, *LAUNCHES))),
        key=lambda e: e.start_ns())][TRACE_MARKERS:]
    torch.cuda.synchronize()
    names = Counter(n[:60] for n, _ in device)
    return dict(
        kernel_names={k: v / chunk for k, v in names.most_common()},
        busy_ms=sum(d for _, d in device) / 1e6 / chunk,
        kernels=sum(not n.startswith(("Memcpy", "Memset"))
                    for n, _ in device) / chunk,
        replays=sum(n.startswith(GRAPH_LAUNCH) for n in host) / chunk,
        host_launches={k: v / chunk for k, v in Counter(
            n for n in host if not n.startswith(GRAPH_LAUNCH)).items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=".", help="the tree to run")
    p.add_argument("--label", default=None, help="names the tree's lines")
    p.add_argument("--paths", nargs="+", default=["path5", "path8a"],
                   choices=["path1", "path2", "path3", "path5", "path6",
                            "path8a"])
    p.add_argument("--reps", type=int, default=1,
                   help="runs of the chosen paths, one after another")
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
    kitti = {}

    def frames(n):
        """The first n frames of path 1's sequence on the card."""
        from lvt_tpu_torch import bench
        from lvt_tpu_torch.configs import kitti_config

        if kitti.get("n", 0) < n:
            il, ir, _, _ = bench.render(kitti_config(), n)
            kitti.update(n=n, il=torch.from_numpy(il).to(cs.DEVICE),
                         ir=torch.from_numpy(ir).to(cs.DEVICE))
        return kitti["il"][:n], kitti["ir"][:n]

    for path in [p for _ in range(args.reps) for p in args.paths]:
        if path in ("path1", "path2", "path3"):
            from lvt_tpu_torch.configs import (kitti_ba_dense_config,
                                               kitti_config)
            from lvt_tpu_torch.core.system import VOSystem
            from lvt_tpu_torch.parallel.multistream import MultiStreamVO

            chunk, n_units = cs.RUNS[path]
            n, s = chunk * n_units, cs.MS_STREAMS
            if path in ("path1", "path2"):
                a, b = frames(n)
                make = partial(VOSystem, kitti_config() if path == "path1"
                               else kitti_ba_dense_config(), device=cs.DEVICE)
            else:
                il, ir = frames(n + cs.MS_START_STEP * (s - 1))
                starts = [cs.MS_START_STEP * i for i in range(s)]
                a = torch.stack([il[k:k + n] for k in starts], 1)
                b = torch.stack([ir[k:k + n] for k in starts], 1)
                make = partial(MultiStreamVO, kitti_config(), s,
                               device=cs.DEVICE)
            drive = cs._chunks_of(a, b, chunk)
            run = cs._run_modes(path, make, drive, n_units, chunk)
            rep = cs._report_modes(path, run, per=s if path == "path3" else 1)
            rep["trace"] = traced_unit(run, drive, n_units, chunk)
        elif path == "path6":
            from lvt_tpu_torch.configs import kitti_config
            from lvt_tpu_torch.core.system import VOSystem

            config = kitti_config()
            il, ir = frames(cs.EXT_FRAMES)
            corners = cs._external_corners(config, il, ir)
            unit = cs.EXT_UNIT

            def drive(vo, u):
                out = [(vo.track_with_external_corners(il[i], ir[i],
                                                       *corners[i]),
                        vo.last_metrics)
                       for i in range(u * unit, (u + 1) * unit)]
                stack = lambda *xs: torch.stack(xs)  # noqa: E731
                return tuple(type(o[0])(*map(stack, *o)) for o in zip(*out))

            run = cs._run_modes(path, lambda: VOSystem(config,
                                                       device=cs.DEVICE),
                                drive, cs.EXT_FRAMES // unit, unit)
            rep = cs._report_modes(path, run)
            rep["trace"] = traced_unit(run, drive, cs.EXT_FRAMES // unit,
                                       unit)
        elif path == "path5":
            from lvt_tpu_torch.core.system import VOSystem

            config, maps, il, ir, _ = cs.euroc_setup()
            chunk, n_units = cs.RUNS[path]
            a, b = il.to(cs.DEVICE), ir.to(cs.DEVICE)
            drive = cs._chunks_of(a, b, chunk)
            run = cs._run_modes(
                path, lambda: VOSystem(config, device=cs.DEVICE,
                                       rectify_maps=maps),
                drive, n_units, chunk)
            rep = cs._report_modes(path, run)
            rep["trace"] = traced_unit(run, drive, n_units, chunk)
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
            make = partial(ShardedStreamVO, config, device=cs.DEVICE)
            drive = cs._chunks_of(a, b, chunk)
            with tempfile.TemporaryDirectory() as tmp:
                mesh.init("nccl", 1, 0, "file://" + os.path.join(tmp, "rdv"),
                          device=cs.DEVICE)
                try:
                    run = cs._run_modes(path, make, drive, n_units, chunk)
                    rep = cs._report_modes(path, run)
                    rep["trace"] = traced_unit(run, drive, n_units, chunk)
                    n_types = max(cs.TRACED_FRAMES)
                    fa, fb = frames(n_types)
                    rep["trace"]["frame_types"] = cs._frame_types(
                        path, config, make, fa, fb)
                finally:
                    dist.destroy_process_group()
        print(json.dumps(dict(
            tree=label, path=path, fps=rep["fps"],
            fps_eager=rep["fps_eager"], fps_spread=rep["fps_spread"],
            host_ms=rep["host_ms"], capture_s=rep["capture_s"],
            trace=rep.get("trace"), card=card)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
