"""Run the sharded modes in n processes, and the worker jobs that do it.

    python -m lvt_tpu_torch.parallel.dryrun --processes 4 --device cpu

The port's counterpart of lvt_tpu's ``__graft_entry__.dryrun_multichip``
and ``scripts/multihost_dryrun.py``: :func:`spawn` starts n processes with
the ``spawn`` start method (never ``fork``: a parent that holds threads,
a test process with JAX's, must not be copied), joins them into one
process group (gloo for ``--device cpu``, NCCL or gloo for ``cuda``;
rendezvous through a file in a fresh temporary directory, so concurrent
runs never collide), runs a list of jobs in each and returns every rank's
results in rank order. A job that raises in any rank raises in the parent
with that rank's traceback; the other ranks are killed. Each child takes
one CPU thread and, on ``cuda``, device ``cuda:0`` (ranks that share one
card share it). The jobs (:func:`sharded_stream`, :func:`stream_point`,
:func:`multistream`, :func:`pnp_sharded`, :func:`collectives_check`,
:func:`resolve_check`, :func:`stream_indices`, :func:`loaded_modules`) live here so that a child imports only the port;
the tests and ``chip_smoke.py`` reuse them. A job's frames may come as
:class:`SavedArray` files, which each rank reads itself.

The command line runs, at a tiny size (96x64 noise frames, 256 map
points): the stream-parallel ``MultiStreamVO(mesh=...)``,
``solve_pnp_sharded``, ``ShardedStreamVO`` and, for 4 processes,
``StreamPointVO`` on a 2 x 2 mesh; it prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch


def _child(jobs, rank, n, init_method, backend, device, out,
           started) -> None:
    """One rank: the process group, the kernels' library (CUDA), the jobs
    in order; puts (rank, ok, results or the trace, seconds) where seconds
    holds the rank's start-up (``started``, the parent's wall clock when
    it started the ranks, to the child's first line: the interpreter, the
    imports and unpickling the jobs), the process group's set-up, the
    library's load (with the CUDA context) and each job's."""
    secs = dict(start=time.time() - started)
    torch.set_num_threads(1)
    try:
        from lvt_tpu_torch.parallel import mesh as mesh_mod

        t0 = time.perf_counter()
        mesh_mod.init(backend, n, rank, init_method, device=device)
        secs["group"] = time.perf_counter() - t0
        if device == "cuda":
            from lvt_tpu_torch import kernels

            t0 = time.perf_counter()
            kernels.lib()
            torch.cuda.synchronize()
            secs["library"] = time.perf_counter() - t0
        results, secs["jobs"] = [], []
        for fn, args, kw in jobs:
            t0 = time.perf_counter()
            results.append(fn(rank, n, *args, **kw))
            secs["jobs"].append(time.perf_counter() - t0)
        out.put((rank, True, results, secs))
    except Exception:  # noqa: BLE001 - re-raised in the parent, with its trace
        out.put((rank, False, traceback.format_exc(), secs))
        return
    import torch.distributed as dist

    dist.destroy_process_group()


def job(fn, *args, **kw):
    """One job for :func:`spawn`: ``fn(rank, n, *args, **kw)`` in every
    rank (``fn`` importable from a module of the port)."""
    return (fn, args, kw)


class SavedArray(NamedTuple):
    """A job's array argument as a file that ``np.save`` wrote: each rank
    reads it itself, so :func:`spawn` does not pickle the frames into
    every rank's start, one rank after another."""
    path: str

    @staticmethod
    def save(array, directory: str, name: str) -> "SavedArray":
        path = os.path.join(directory, f"{name}.npy")
        np.save(path, np.ascontiguousarray(array))
        return SavedArray(path)


def _array(x):
    """A job's array argument: a :class:`SavedArray` read, else as given."""
    return np.load(x.path) if isinstance(x, SavedArray) else x


def spawn(jobs, n: int, *, device: str = "cpu", backend: str | None = None,
          timeout_s: float = 900.0, seconds: list | None = None) -> list:
    """Run ``jobs`` (a list of :func:`job`) in order in each of ``n``
    spawned processes joined in one process group; returns
    ``[rank 0's results, rank 1's, ...]``, each a list with one entry per
    job. ``backend`` defaults to gloo on the CPU and NCCL on CUDA. Given a
    list, ``seconds`` receives each rank's seconds (:func:`_child`) in
    rank order."""
    import multiprocessing as mp

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        started = time.time()
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(jobs, r, n, init, backend, device, out,
                                   started))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            while len(results) < n:
                try:
                    rank, ok, value, secs[rank] = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks did not finish in "
                                           f"{timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if seconds is not None:
        seconds.extend(secs[r] for r in range(n))
    return [results[r] for r in range(n)]


# ---- jobs: each runs in every rank of a process group that exists


def _host(tree):
    from lvt_tpu_torch.tree import tree_map

    return tree_map(lambda x: x.cpu().numpy(), tree)


def count_syncs(fn):
    """``fn()``'s result and the host syncs it made, counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` (None off CUDA)."""
    import warnings

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _chunks(vo, a, b, chunk: int, after=None, syncs_seen=True) -> dict:
    """``vo.track_chunk`` over the frames of ``a`` and ``b`` in chunks,
    the collectives and the wrappers' kernel launches counted from 0: each
    chunk's host seconds (to its end on the device), chunk 1's host syncs
    and chunk 0's kernels as the card ran them (``device_launches``: the
    graph's warm-up step and each replay, which no wrapper counts) on
    CUDA where ``syncs_seen`` (not on gloo, whose syncs happen in its own
    threads, where the count does not see them, and whose step runs
    eagerly), the poses and metrics on the host, and
    ``after(vo)`` after each chunk (outside the timed region, its
    collectives not counted), and the modes its runners ran in (graph or
    eager, core/graphs.py)."""
    from lvt_tpu_torch.ops.collectives import all_reduce
    from lvt_tpu_torch.tree import tree_map

    launches = zero_kernel_counters()
    all_reduce.calls = 0
    poses, metrics, snapshots, seconds, syncs = [], [], [], [], None
    device = None
    on_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for c, lo in enumerate(range(0, a.shape[0], chunk)):
        x, y = a[lo:lo + chunk], b[lo:lo + chunk]
        t0 = time.perf_counter()
        if c == 1 and syncs_seen:
            (p, m), syncs = count_syncs(lambda: vo.track_chunk(x, y))
        elif c == 0 and syncs_seen and on_cuda:
            (p, m), device = device_launches(lambda: vo.track_chunk(x, y))
        else:
            p, m = vo.track_chunk(x, y)
            if on_cuda:
                torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        poses.append(p)
        metrics.append(m)
        if after is not None:
            calls = all_reduce.calls
            snapshots.append(after(vo))
            all_reduce.calls = calls
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    return dict(
        poses=_host(tree_map(cat, *poses)),
        metrics=_host(tree_map(cat, *metrics)),
        collectives=all_reduce.calls,
        launches={k: fn.launches for k, fn in launches.items()},
        device_launches=device, first_chunk=min(chunk, a.shape[0]),
        syncs=syncs, chunk_seconds=seconds, after_chunks=snapshots,
        modes=sorted({r.mode for r in vo.runners.values()}))


def zero_kernel_counters() -> dict:
    """Every kernel wrapper by name, each launch count set to 0."""
    from lvt_tpu_torch.core import graphs, tail, track
    from lvt_tpu_torch.ops import detect, matching, patches, perception, top2
    from lvt_tpu_torch.solver import bundle, pnp

    counters = {"perception": perception.perception_patch_maps_batched,
                "brief": perception.brief_planes,
                "describe_refine": patches.describe_refine_batched,
                "hamming_top2": top2.hamming_top2,
                "pnp_solve": pnp.pnp_solve, "pnp_phase": pnp.pnp_phase,
                "pnp_normal_eqs": pnp.normal_equations,
                "stream_sum": pnp.stream_sum, "ba_refine": bundle.ba_refine,
                "ba_phase": bundle.ba_phase,
                **{name: getattr(track, name) for name in track.OPS},
                "select_corners": detect.select_slots,
                "map_accept": matching.map_accept,
                "step_tail": tail.step_tail,
                "copy_leaves": graphs.copy_leaves}
    for fn in counters.values():
        fn.launches = 0
    return counters


# the hand-written kernels' CUDA functions, as a kernel trace names them
KERNEL_SYMBOLS = {"perception": "perception_kernel", "brief": "brief_kernel",
                  "describe_refine": "describe_refine_kernel",
                  "hamming_top2": "hamming_top2_kernel",
                  "pnp_solve": "pnp_solve_kernel",
                  "pnp_phase": "pnp_phase_kernel",
                  "pnp_normal_eqs": "pnp_normal_eqs_kernel",
                  "stream_sum": "stream_sum_kernel",
                  "ba_refine": "ba_refine_kernel",
                  "ba_phase": "ba_phase_kernel",
                  "predict_project": "predict_project_kernel",
                  "upkeep_pre": "upkeep_pre_kernel",
                  "staged_promote": "staged_promote_kernel",
                  "triangulate_insert": "triangulate_insert_kernel",
                  "ba_observe": "ba_observe_kernel",
                  "select_corners": "select_corners_kernel",
                  "map_accept": "map_accept_kernel",
                  "step_tail": "step_tail_kernel",
                  "copy_leaves": "copy_leaves_kernel"}


# spin kernels that open a trace; no count reads them
TRACE_MARKERS = 16


def traced(fn, host=False):
    """``fn()``'s result and the ``torch.profiler`` trace of it: the
    device's activity (CUPTI), with ``host`` the host's too. On the card a
    trace sometimes lacked its first few records (the first replay's
    input copies and first kernels), so the trace opens with
    TRACE_MARKERS spin kernels (``spin_kernel``) that take such a loss,
    then 50 ms with the device idle before the traced work, and 50 ms
    after it before the window closes (Kineto keeps only what lies inside
    its window)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        for _ in range(TRACE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return out, prof


def device_records(prof) -> list:
    """(name, start ns, end ns) of each kernel, copy and fill on the
    device in a ``traced`` trace, read from Kineto's records as they are
    (torch's event tree, which ``key_averages`` builds, costs seconds of
    host time for a trace of tens of thousands of records)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]


# the kernel that sets a CUDA IF node's predicate before the node
# (csrc/graph_cond.cu, core/graphs.py::cond), one per node and replay
IF_NODE_SYMBOL = "set_if_kernel"


def _count(names) -> dict:
    """Each hand-written kernel's launches in ``names`` (a trace's record
    names), the NCCL kernels (``nccl``), the IF nodes' predicate kernels
    (``if_node``), the markers (``markers``) and every kernel but copies,
    fills and markers (``kernels``)."""
    counts = dict.fromkeys([*KERNEL_SYMBOLS, "nccl", "if_node", "markers",
                            "kernels"], 0)
    for name in names:
        for kernel, sym in KERNEL_SYMBOLS.items():
            counts[kernel] += sym in name
        counts["nccl"] += "nccl" in name.lower()
        counts["if_node"] += IF_NODE_SYMBOL in name
        counts["markers"] += "spin_kernel" in name
        counts["kernels"] += not name.startswith(
            ("Memcpy", "Memset")) and "spin_kernel" not in name
    return counts


def ba_launches() -> dict:
    """Local BA's kernels' launches on the current device so far, counted
    by each kernel itself (``bundle.device_launches`` and
    ``phase_device_launches``; 0 where the library never loaded):
    {"ba_refine": n, "ba_phase": n}."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.solver import bundle

    if kernels._lib is None:
        return dict.fromkeys(BA_KERNELS, 0)
    return {"ba_refine": bundle.device_launches(),
            "ba_phase": bundle.phase_device_launches()}


# the kernels that count their own launches (local BA's: an IF node's body,
# whose records a trace can lose)
BA_KERNELS = ("ba_refine", "ba_phase")


def device_launches(fn):
    """``fn()``'s result and what the card ran during it, from a kernel
    trace (``traced``): each hand-written kernel's launches by name, a
    CUDA graph's replays included (no wrapper call counts those); under
    ``nccl`` the NCCL kernels, under ``if_node`` the kernels that set a
    CUDA IF node's predicate, under ``markers`` the trace's markers that
    it kept (of TRACE_MARKERS), under ``kernels`` all kernels. Local BA's
    kernel, which runs in an IF node's body whose records a trace can
    lose, from the kernels' own counts (``ba_launches``)."""
    before = ba_launches()
    out, prof = traced(fn)
    counts = _count(name for name, _, _ in device_records(prof))
    after = ba_launches()
    counts.update({k: after[k] - before[k] for k in BA_KERNELS})
    return out, counts


def frame_launches(track, n: int):
    """``[track(i) for i in range(n)]`` and what the card ran for each
    call, from one kernel trace (``traced``) with a marker kernel
    (``spin_kernel``) queued after each call: per call, the counts of
    :func:`_count` and the kernels' names in order (``names``). A call is
    one frame of a system: so launches split by frame type (local BA's
    frames and the others, core/graphs.py's IF node). Local BA's kernel
    from its own count, read after each call (``device_launches``)."""
    ba = [ba_launches()]

    def run():
        out = []
        for i in range(n):
            out.append(track(i))
            torch.cuda._sleep(1)
            ba.append(ba_launches())
        return out

    out, prof = traced(run)
    records = sorted(device_records(prof), key=lambda r: r[1])
    first = next(i for i, r in enumerate(records)
                 if "spin_kernel" not in r[0])
    frames, names = [], []
    for name, _, _ in records[first:]:
        if "spin_kernel" in name:
            frames.append(dict(_count(names), names=names))
            names = []
        else:
            names.append(name)
    if len(frames) != n:
        raise RuntimeError(f"the trace holds {len(frames)} frames' markers, "
                           f"not {n}")
    for f, a, b in zip(frames, ba, ba[1:]):
        # the kernels' own counts (device_launches)
        f.update({k: b[k] - a[k] for k in BA_KERNELS})
    return out, frames


def _backend() -> str:
    import torch.distributed as dist

    return str(dist.get_backend())


def sharded_stream(rank, n, config, left, right, *, chunk: int,
                   device: str = "cpu", axis: str | None = None,
                   keep_state: bool = False, initial=None) -> dict:
    """``ShardedStreamVO`` over all ranks (a 1-D mesh named ``axis``) on
    frames [N, H, W] (every rank the same), in chunks: poses, metrics,
    after each chunk the summed map size, the status and this rank's valid
    points, counts and times; with ``keep_state`` this rank's state on the
    host. ``initial``: a whole state (the port's tree, numpy leaves) to
    start from, cut into this rank's block."""
    from lvt_tpu_torch import convert
    from lvt_tpu_torch.core import graphs
    from lvt_tpu_torch.parallel.sharded_stream import (POINT_AXIS,
                                                       ShardedStreamVO,
                                                       state_specs)

    axis = axis or POINT_AXIS
    left, right = _array(left), _array(right)
    vo = ShardedStreamVO(config, axis=axis, device=device)
    if initial is not None:
        graphs.copy_into(vo.state, convert.shard_state(
            initial, rank, n, axis_of=convert.axes_of(state_specs(axis), axis),
            device=device))
    run = _chunks(vo, torch.as_tensor(left).to(device),
                  torch.as_tensor(right).to(device), chunk,
                  after=lambda v: dict(map_size=v.map_size, status=v.status,
                                       local_valid=v.local_map_size),
                  syncs_seen=_backend() != "gloo")
    run.update(rank=rank, n=n, backend=_backend(), axis=axis,
               mesh_dim_names=list(vo.mesh.mesh_dim_names),
               status=vo.status, map_size=vo.map_size,
               local_valid=vo.local_map_size,
               block=int(vo.state.map.valid.shape[0]))
    if keep_state:
        run["state"] = convert.to_numpy(vo.state)
    return run


def stream_point(rank, n, config, left, right, *, n_stream: int,
                 n_point: int, chunk: int, device: str = "cpu") -> dict:
    """``StreamPointVO`` on an ``n_stream x n_point`` mesh over frames [N,
    S, H, W] (every rank the whole batch): this rank's streams' poses,
    metrics, statuses and summed map sizes, and the warnings of ops that
    fell back to vmap's per-sample loop."""
    import warnings

    from lvt_tpu_torch.parallel import mesh as mesh_mod
    from lvt_tpu_torch.parallel.stream_point import StreamPointVO

    left, right = _array(left), _array(right)
    mesh = mesh_mod.stream_point_mesh(n_stream, n_point,
                                      device_type=torch.device(device).type)
    vo = StreamPointVO(config, left.shape[1], mesh=mesh, device=device)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = _chunks(vo, torch.as_tensor(left), torch.as_tensor(right),
                      chunk, syncs_seen=_backend() != "gloo")
    run.update(rank=rank, n=n, backend=_backend(),
               local_streams=vo.local_streams.tolist(), status=vo.status,
               map_sizes=vo.map_sizes(),
               fallback_warnings=[str(w.message) for w in caught
                                  if "fallback" in str(w.message).lower()])
    return run


def multistream(rank, n, config, left, right, *, chunk: int,
                device: str = "cpu", multihost: bool = False) -> dict:
    """``MultiStreamVO`` on a ``stream`` mesh over all ranks (or, with
    ``multihost``, ``MultiHostStreamVO`` fed only this rank's streams) on
    frames [N, S, H, W]: this rank's streams' poses and statuses, and every
    stream's final poses gathered."""
    from lvt_tpu_torch.parallel import mesh as mesh_mod
    from lvt_tpu_torch.parallel.multihost import (MultiHostStreamVO,
                                                  local_stream_indices)
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    left, right = _array(left), _array(right)
    s = left.shape[1]
    mesh = mesh_mod.stream_mesh(device_type=torch.device(device).type)
    left, right = torch.as_tensor(left), torch.as_tensor(right)
    if multihost:
        vo = MultiHostStreamVO(config, s, mesh, device=device)
        local = local_stream_indices(mesh, s)
        left, right = left[:, local], right[:, local]
    else:
        vo = MultiStreamVO(config, s, mesh, device=device)
    run = _chunks(vo, left, right, chunk)
    run.update(rank=rank, n=n, local_streams=vo.local_streams.tolist(),
               status=vo.status)
    if multihost:
        from lvt_tpu_torch.geometry.se3 import Pose

        last = Pose(*(torch.as_tensor(x[-1]).to(device)
                      for x in run["poses"]))
        run["all_poses"] = vo.all_poses(last)
    return run


def pnp_sharded(rank, n, pose, points, obs, weights, *, cam: dict,
                device: str = "cpu") -> dict:
    """``solve_pnp_sharded`` on this rank's contiguous block of the
    correspondences (whole arrays given): pose, inlier count, chi-square
    and this block's inlier mask."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.parallel import ba, mesh as mesh_mod

    mesh = mesh_mod.point_mesh(device_type=torch.device(device).type)
    blk = slice(rank * len(points) // n, (rank + 1) * len(points) // n)
    up = lambda x: torch.as_tensor(np.asarray(x)).to(device)  # noqa: E731
    res = ba.solve_pnp_sharded(Pose(up(pose[0]), up(pose[1])),
                               up(points[blk]), up(obs[blk]),
                               up(weights[blk]), mesh, **cam)
    return dict(t=res.pose.t.cpu().numpy(), q=res.pose.q.cpu().numpy(),
                inlier_count=int(res.inlier_count), chi2=float(res.chi2),
                inlier_mask=res.inlier_mask.cpu().numpy())


def ba_phases_check(rank, n, window, *, cam: dict, poison=None,
                    device: str = "cpu") -> dict:
    """Local BA's sharded body on this rank's contiguous block of a
    window's points (``window``: t, q, pos, obs, w, obs_r, w_r as whole
    arrays), as the phases (``refine_structure_phases``) and as the plain
    group version (``refine_structure_plain(group=)``): each one's
    positions of the block, chi2, n_obs and accept bits, and its
    all-reduces; of the phases also each trial's non-finite flag as its
    K_TRIAL launch left it in the state row (``trial_bad``, one per LM
    iteration). ``poison`` (rank, call): on that rank the point step's
    call-th call (0-based, in each body) returns a non-finite dp at the
    block's first point, a fault of this rank's block alone."""
    import torch.distributed as dist

    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.ops.collectives import all_reduce
    from lvt_tpu_torch.solver import bundle

    t, q, pos, obs, w, obs_r, w_r = (torch.as_tensor(np.asarray(x)).to(device)
                                     for x in window)
    blk = slice(rank * pos.shape[0] // n, (rank + 1) * pos.shape[0] // n)
    args = (Pose(t, q), pos[blk], obs[:, blk], w[:, blk], obs_r[:, blk],
            w_r[:, blk])
    group = dist.group.WORLD
    real, calls = bundle._point_step, [0]
    real_phase, bad = bundle.ba_phase, []

    def phase(kind, it, *a, **kw):
        res = real_phase(kind, it, *a, **kw)
        if kind == bundle.K_TRIAL:
            bad.append(float(res[0][0, bundle._offset(obs.shape[0], "bad")]))
        return res

    def point_step(*a):
        dp = real(*a)
        if poison is not None and rank == poison[0] and \
                calls[0] == poison[1]:
            dp = dp.clone()
            dp[0, 0] = float("inf")
        calls[0] += 1
        return dp

    out = {}
    bundle._point_step, bundle.ba_phase = point_step, phase
    phase.launches = 0
    try:
        for name, fn in (("phases", lambda: bundle.refine_structure_phases(
                              *args, group=group, **cam).outputs()),
                         ("plain", lambda: bundle.refine_structure_plain(
                              *args, group=group, **cam))):
            calls[0], before = 0, all_reduce.calls
            res = fn()
            out[name] = [x.cpu().numpy() for x in res]
            out[f"{name}_collectives"] = all_reduce.calls - before
    finally:
        bundle._point_step, bundle.ba_phase = real, real_phase
        real_phase.launches += phase.launches
    out["trial_bad"] = bad
    return out


def collectives_check(rank, n, *, device: str = "cpu") -> dict:
    """The collectives on a group of all ranks, from values that differ
    per rank: psum_if, pmin_if, por_if, axis_index, axis_size, each
    under vmap against a loop of unbatched calls, and the loop's sum
    against this rank's own values (which a sum that reduced nothing would
    return)."""
    import warnings

    import torch.distributed as dist
    from torch.func import vmap

    from lvt_tpu_torch.ops import collectives as c

    group = dist.group.WORLD
    x = (torch.arange(12, dtype=torch.float32).reshape(3, 4)
         * (rank + 1)).to(device)
    ints = (torch.arange(6, dtype=torch.int32).reshape(3, 2) - rank).to(device)
    mask = (torch.arange(8).reshape(2, 4) % n == rank).to(device)
    out = dict(rank=rank, axis_index=c.axis_index(group),
               axis_size=c.axis_size(group))
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c.all_reduce.calls = 0
        out.update(
            psum=c.psum_if(x, group).cpu().numpy(),
            pmin=c.pmin_if(ints, group).cpu().numpy(),
            por=c.por_if(mask, group).cpu().numpy(),
            unbatched_calls=c.all_reduce.calls)
        c.all_reduce.calls = 0
        loops = {
            "psum": torch.stack([c.psum_if(v, group) for v in x]),
            "pmin": torch.stack([c.pmin_if(v, group) for v in ints.T]).T,
            "por": torch.stack([c.por_if(v, group) for v in mask]),
        }
        c.all_reduce.calls = 0
        batched = {
            "psum": vmap(lambda v: c.psum_if(v, group))(x),
            "pmin": vmap(lambda v: c.pmin_if(v, group), in_dims=1,
                         out_dims=1)(ints),
            "por": vmap(lambda v: c.por_if(v, group))(mask),
        }
        out["batched_calls"] = c.all_reduce.calls
    out["fallback_warnings"] = [str(w.message) for w in caught
                                if "fallback" in str(w.message).lower()]
    out["batched_equal"] = {k: bool(torch.equal(batched[k], loops[k]))
                            for k in loops}
    # a sum that reduced nothing would return this rank's own values
    out["unreduced_equal"] = bool(torch.equal(x, loops["psum"]))
    return out


def resolve_check(rank, n, match_idx, d1, num_targets: int, *,
                  device: str = "cpu") -> np.ndarray:
    """``resolve_one_to_one(group=)`` on this rank's contiguous block of
    the queries (whole arrays given); returns the block's result."""
    import torch.distributed as dist

    from lvt_tpu_torch.ops import hamming

    q = len(match_idx) // n
    blk = slice(rank * q, (rank + 1) * q)
    return hamming.resolve_one_to_one(
        torch.as_tensor(match_idx[blk]).to(device),
        torch.as_tensor(d1[blk]).to(device), num_targets,
        dist.group.WORLD).cpu().numpy()


def loaded_modules(rank, n) -> list:
    """The top-level names of the modules this rank has imported."""
    return sorted({name.split(".")[0] for name in sys.modules})


def stream_indices(rank, n, n_streams: int) -> list:
    """``local_stream_indices`` of this rank on a ``stream`` mesh over all
    ranks."""
    from lvt_tpu_torch.parallel import mesh as mesh_mod
    from lvt_tpu_torch.parallel.multihost import local_stream_indices

    return local_stream_indices(mesh_mod.stream_mesh(device_type="cpu"),
                                n_streams).tolist()


# ---- the command line


def _tiny():
    """lvt_tpu's dry-run geometry: 96x64 noise frames, 256 map points."""
    from lvt_tpu_torch.config import VOConfig

    config = VOConfig(
        fx=60.0, fy=60.0, cx=48.0, cy=32.0, baseline=0.2,
        img_width=96, img_height=64, detection_cell_size=48,
        max_keypoints_per_cell=32, agast_threshold=10,
        near_plane_distance=0.2, far_plane_distance=50.0,
        max_map_points=256, max_staged_points=256)
    rs = np.random.RandomState(0)
    il = rs.uniform(0, 255, (4, 64, 96)).astype(np.float32)
    ir = rs.uniform(0, 255, (4, 64, 96)).astype(np.float32)
    m = 64
    pts = rs.uniform(-5, 5, (m, 3)).astype(np.float32)
    pts[:, 2] += 20.0
    uv = np.stack([60.0 * pts[:, 0] / pts[:, 2] + 48.0,
                   60.0 * pts[:, 1] / pts[:, 2] + 32.0], -1).astype(np.float32)
    return config, il, ir, pts, uv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"),
                   help="default: gloo on the CPU, NCCL on CUDA")
    args = p.parse_args(argv)
    n, dev = args.processes, args.device
    config, il, ir, pts, uv = _tiny()
    # every rank tracks 2 frames of one stream per rank, twice (chunk 2)
    frames = np.stack([il[:2]] * n, 1), np.stack([ir[:2]] * n, 1)
    identity = (np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32))
    jobs = [
        job(multistream, config, *frames, chunk=2, device=dev),
        job(pnp_sharded, identity, pts, uv, np.ones(len(pts), np.float32),
            cam=dict(fx=60.0, fy=60.0, cx=48.0, cy=32.0), device=dev),
        job(sharded_stream, config, il[:2], ir[:2], chunk=2, device=dev),
    ]
    if n >= 4 and n % 2 == 0:
        jobs.append(job(stream_point, config, *frames, n_stream=2,
                        n_point=n // 2, chunk=2, device=dev))
    t0 = time.perf_counter()
    results = spawn(jobs, n, device=dev, backend=args.backend)
    names = ["multistream", "pnp_sharded", "sharded_stream", "stream_point"]
    workers = []
    for rank, res in enumerate(results):
        w = {"rank": rank}
        for name, r in zip(names, res):
            if name == "pnp_sharded":
                w[name] = dict(inlier_count=r["inlier_count"],
                               t=r["t"].tolist())
            else:
                w[name] = dict(status=np.asarray(r["status"]).tolist(),
                               collectives=r["collectives"])
        workers.append(w)
    ok = all(w["pnp_sharded"]["t"] == workers[0]["pnp_sharded"]["t"]
             for w in workers)
    print(json.dumps({"ok": ok, "processes": n, "device": dev,
                      "seconds": round(time.perf_counter() - t0, 3),
                      "workers": workers}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
