"""The port's benchmark: frames/s per card of the stereo VO on a synthetic
KITTI-geometry sequence, lvt_tpu's ``bench.py`` and its three modes.

    python -m lvt_tpu_torch bench [--ba] [--multistream [--streams N]] [--device cuda]
    python -m lvt_tpu_torch.bench ...

Prints ONE JSON line: ``{"metric": ..., "value": N, "unit": "frames/s",
"vs_baseline": N, "device": ...}``, with bench.py's keys and ``metric``
strings, and the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them (``cpu``
on the CPU). ``vs_baseline`` is against bench.py's denominator, 70
frames/s (BASELINE.md).

Timing as bench.py times it:

* main: ``configs.kitti_config()`` on CHUNK * (N_CHUNKS + 1) uint8 frames
  of bench.py's world, uploaded to the device before the timed region and
  split into chunk views there. Chunk 0 warms up: the step's CUDA graph is
  captured there (core/graphs.py), and its poses are read back once.
  Chunks 1..N_CHUNKS are timed with the host clock, which stops after one
  read of the last chunk's ``poses.t`` to the host; nothing is read
  between chunks.
* ``--ba``: the same with ``local_ba_window=4``. BA runs on its frames
  only, inside the graph's CUDA IF node.
* ``--multistream``: MS_STREAMS streams per card (``--streams N``: N),
  every stream fed the same frames ([N, S, H, W]), through
  ``MultiStreamVO``, in chunks of MS_CHUNK, MS_N_CHUNKS timed after one
  warm-up chunk; aggregate frames/s per card. In a process group (one rank
  per card, ``torch.distributed``) S is N times the world size, each rank
  feeds and tracks its own block of streams on a ``stream`` mesh, and the
  slowest rank's time sets the figure (:func:`multistream_rank` is the
  job for ``parallel.dryrun.spawn``).

On the card the timed loop also runs under
``torch.cuda.set_sync_debug_mode("warn")``: the run's ``syncs`` counts
the host syncs it made (0 expected; the final read is outside the count).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_FPS = 70.0
CHUNK = 16
N_CHUNKS = 24
# --multistream: streams per card, frames per chunk, timed chunks
MS_STREAMS = 8
MS_CHUNK = 8
MS_N_CHUNKS = 12
# --ba: the windowed-BA cost variant (BASELINE.md's windowed-BA row)
BA_WINDOW = 4
# bench.py's world: 6000 points in +-80 x +-20 x [2, 160] m, the camera
# moving 0.9 m per frame
N_POINTS = 6000
EXTENT = (80.0, 20.0, 160.0)
SPEED = 0.9


def bench_config(ba: bool = False):
    """bench.py's config: ``configs.kitti_config()`` (= lvt_tpu's
    ``__graft_entry__._kitti_config()``), with ``--ba`` local BA over a
    window of BA_WINDOW frames."""
    from lvt_tpu_torch.configs import kitti_config

    config = kitti_config()
    return config.replace(local_ba_window=BA_WINDOW) if ba else config


def world(config):
    """bench.py's synthetic world seen by ``config``'s camera."""
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    return SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=N_POINTS,
        extent_x=EXTENT[0], extent_y=EXTENT[1], extent_z=EXTENT[2])


def render(config, n_frames: int):
    """The first ``n_frames`` of bench.py's sequence at ``config``'s
    camera: (left, right) [N, H, W] uint8 and the ground truth, rotations
    [N, 3, 3] and positions [N, 3] of the camera in the world. The camera
    drives out of the world's points: 14 are in view at frame 159, none
    from frame 173 on, and tracking is lost from frame 160 (lvt_tpu's
    too, scripts/bench_world.py)."""
    frames = list(world(config).stereo_sequence(n_frames, speed=SPEED))
    return (np.stack([f[0].astype(np.uint8) for f in frames]),
            np.stack([f[1].astype(np.uint8) for f in frames]),
            np.array([f[2][0] for f in frames]),
            np.array([f[2][1] for f in frames]))


def stream_frames(x: torch.Tensor, s: int) -> torch.Tensor:
    """Frames [N, H, W] as S streams that all see them, [N, S, H, W]
    (bench.py's ``np.broadcast_to``), in memory of their own on ``x``'s
    device."""
    return x[:, None].expand(x.shape[0], s, *x.shape[1:]).contiguous()


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _timed(system, chunks) -> dict:
    """bench.py's timed region over ``system.track_chunk``: chunk 0 warms
    up (capture) and is read back, the rest are timed until one read of
    the last chunk's positions. Returns the seconds, the host syncs of the
    timed loop (None off the card), the poses and metrics of every chunk
    (concatenated) and the graphs captured, after the warm-up and in
    all."""
    from lvt_tpu_torch.parallel.dryrun import count_syncs
    from lvt_tpu_torch.tree import tree_map

    out = [system.track_chunk(*chunks[0])]
    out[0][0].t.cpu()
    captured = sum(r.capture_seconds is not None
                   for r in system.runners.values())
    if _distributed():
        import torch.distributed as dist

        dist.barrier()

    def loop():
        for a, b in chunks[1:]:
            out.append(system.track_chunk(a, b))

    t0 = time.perf_counter()
    _, syncs = count_syncs(loop)
    out[-1][0].t.cpu().numpy()
    seconds = time.perf_counter() - t0
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    poses, metrics = (tree_map(cat, *x) for x in zip(*out))
    return dict(seconds=seconds, syncs=syncs, poses=poses, metrics=metrics,
                captures_warmup=captured,
                captures=sum(r.capture_seconds is not None
                             for r in system.runners.values()),
                system=system)


def _line(metric: str, fps: float, device: torch.device) -> dict:
    return {"metric": metric, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3),
            "device": device_name(device)}


def _upload(x, n: int, device: torch.device) -> torch.Tensor:
    from lvt_tpu_torch.device import upload

    return upload(x[:n], device)


def run_main(config=None, *, ba: bool = False, chunk: int = CHUNK,
             n_chunks: int = N_CHUNKS, device="cuda", frames=None) -> dict:
    """bench.py's ``main`` (``ba``: ``--ba``) on ``device``: returns the
    JSON line (``line``), frames/s (``fps``) and :func:`_timed`'s record.
    ``config`` defaults to :func:`bench_config`; ``frames`` (left, right),
    arrays or tensors of at least ``chunk * (n_chunks + 1)`` frames, to
    :func:`render`'s."""
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    config = bench_config() if config is None else config
    if ba:
        config = config.replace(local_ba_window=BA_WINDOW)
    n = chunk * (n_chunks + 1)
    left, right = frames if frames is not None else render(config, n)[:2]
    il, ir = _upload(left, n, dev), _upload(right, n, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    chunks = [(il[c * chunk:(c + 1) * chunk], ir[c * chunk:(c + 1) * chunk])
              for c in range(n_chunks + 1)]
    run = _timed(VOSystem(config, device=dev), chunks)
    fps = n_chunks * chunk / run["seconds"]
    suffix = f", local BA window={BA_WINDOW}" if ba else ""
    return dict(run, fps=fps, config=config, line=_line(
        "frames/sec/chip (KITTI-geometry stereo VO, "
        f"synthetic world{suffix})", fps, dev))


def run_multistream(config=None, *, streams: int = MS_STREAMS,
                    chunk: int = MS_CHUNK, n_chunks: int = MS_N_CHUNKS,
                    device="cuda", frames=None) -> dict:
    """bench.py's ``main_multistream`` on ``device`` with ``streams`` per
    card: S = ``streams`` x the world size of the process group (1
    without one), this rank's block of them fed the same frames; returns
    the JSON line (``line``), aggregate frames/s per card (``fps``), S
    (``streams``), the world size (``world``) and :func:`_timed`'s record,
    whose ``seconds`` are the slowest rank's. ``config`` and ``frames`` as
    :func:`run_main`'s."""
    from lvt_tpu_torch.device import resolve_device
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    dev = resolve_device(device)
    config = bench_config() if config is None else config
    mesh, world = None, 1
    if _distributed():
        import torch.distributed as dist

        from lvt_tpu_torch.parallel.mesh import stream_mesh

        world = dist.get_world_size()
        mesh = stream_mesh(device_type=dev.type)
    s = streams * world
    msvo = MultiStreamVO(config, s, mesh, device=dev)
    n = chunk * (n_chunks + 1)
    left, right = frames if frames is not None else render(config, n)[:2]
    local = len(msvo.local_streams)
    il = stream_frames(_upload(left, n, dev), local)
    ir = stream_frames(_upload(right, n, dev), local)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    chunks = [(il[c * chunk:(c + 1) * chunk], ir[c * chunk:(c + 1) * chunk])
              for c in range(n_chunks + 1)]
    run = _timed(msvo, chunks)
    if world > 1:
        # the slowest rank's time, on a tensor the group's backend takes
        slowest = torch.tensor(
            run["seconds"], dtype=torch.float64,
            device=dev if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        run["seconds"] = float(slowest)
    fps = n_chunks * chunk * s / run["seconds"] / world
    return dict(run, fps=fps, streams=s, world=world, config=config,
                line=_line(f"frames/sec/chip (multistream S={s}, {world} "
                           "devices, KITTI-geometry stereo VO)", fps, dev))


def multistream_rank(rank, n, **kw) -> dict:
    """:func:`run_multistream` in every rank of a process group (a job for
    ``parallel.dryrun.spawn``); returns its figures, no tensors."""
    run = run_multistream(**kw)
    return dict(line=run["line"], fps=run["fps"], seconds=run["seconds"],
                streams=run["streams"], world=run["world"],
                local_streams=run["system"].local_streams.tolist())


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no fallback to "
                             "the CPU)")
    parser.add_argument("--ba", action="store_true",
                        help=f"local BA over a window of {BA_WINDOW} frames")
    parser.add_argument("--multistream", action="store_true",
                        help="many streams on one card, all fed the same "
                             "frames")
    parser.add_argument("--streams", type=int, default=MS_STREAMS,
                        help=f"--multistream: streams per card (default "
                             f"{MS_STREAMS})")


def run(args) -> int:
    """One mode as ``args`` (:func:`add_arguments`) asks, at bench.py's
    sizes (read when called); prints its JSON line."""
    if args.multistream:
        out = run_multistream(streams=args.streams, chunk=MS_CHUNK,
                              n_chunks=MS_N_CHUNKS, device=args.device)
    else:
        out = run_main(bench_config(), ba=args.ba, chunk=CHUNK,
                       n_chunks=N_CHUNKS, device=args.device)
    print(json.dumps(out["line"]), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m lvt_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
