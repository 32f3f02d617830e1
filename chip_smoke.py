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
   their plain PyTorch versions on the card, bit for bit, at paths 1 and
   2's shapes: a uint8 KITTI pair and its [2, 376, 1241] maps (A also
   on the same pair made non-integer float32), the 2 x
   1536 keypoint slots selected on it, and T at its sites with the
   real descriptor sets of two frames (map match, dual radius, 1024 x 1536;
   staged re-match, one radius, 1024 x 1536; the row match, row window
   computed from the keypoints, 1536 x 1536, and the dual row launch that
   serves the triangulation's and local BA's row matches at once). Each kernel is timed as the mean of REPS
   back-to-back launches between one pair of CUDA events (queued while a
   spin kernel holds the card, so host time between launches is not
   counted); the plain versions the same way with PLAIN_REPS; and each
   gets its bound (see ``bound``; A and B also the bound of the
   one-pixel-per-thread designs they replaced) and, where one PyTorch call
   computes the same function, that call's time;
3. path 1, the main path (patch descriptors, BA off): a synthetic
   KITTI-geometry stereo sequence (uint8, as bench.py builds it) through
   ``VOSystem(config, device="cuda").track_chunk``, 112 frames in chunks
   of 16, graph and eager (above); the
   final status must be TRACKING, the ATE under 5% of the distance
   travelled, the host syncs of one chunk (under
   ``torch.cuda.set_sync_debug_mode("warn")``) 0, and the kernels must have
   launched (A and P once per frame, T three times); then the card against
   the CPU: frame 0's features bit for bit, and the poses of frames 0-3
   within 1e-3 m;
4. path 2, the shipped KITTI config (lvt_tpu_torch/configs/kitti/
   vo_config.yaml: local BA, window 4 every 4 frames) in the dense
   descriptor mode, 42 frames in chunks of 6: A, B once per frame, T
   three times (one dual row launch) and local BA's observations
   (``ba_observe``) once; the number of frames that ran BA (read once after the run)
   must be the schedule's; local BA is a CUDA IF node in the graph, so
   per frame type (``_frame_types``: a new system's frames 5-16 one at a
   time in a kernel trace) every frame sets the node's predicate once and
   launches the path's kernels, a BA frame (12, 16; 8 may list fewer)
   runs exactly an other frame's kernels and as many more as the node's
   body holds (local BA's kernel ``ba_refine`` on BA frames, none on the
   others), and the eager step runs the same kernels on every frame
   (``ba_refine`` once: BA computed and selected); then the card against
   the CPU over frames 0-8 (BA runs at frames 4 and 8); then local BA's
   kernel (``lvt_tpu_torch::ba_refine``, csrc/ba.cu: the whole body, one
   cluster of blocks per stream; not a TPU kernel) on the windows it took
   at frames 4 and 8 in one launch, and on them cut to 3-8 observed
   points, against its plain version (``refine_structure_plain``, torch
   ops) on the card: every output (positions, chi2, n_obs, the accept
   bits) bit-equal, and each stream bit-equal to its own S = 1 launch (the
   same after the bench's ``--ba``, on path 7 kitti's windows, and on the
   8-stream unit's 8 windows of frame 8, where it is timed at S = 1 and 8
   beside its bound and the plain version captured in a CUDA graph; the
   kernel's cluster size, threads per block and ptxas's registers and
   spills printed at the build); then the sparse
   descriptor mode (path 1's config),
   card vs CPU: frame 0's features bit-equal, the poses of frames 0-3
   within 1e-3 m; then 8 streams of path 2's config (``MultiStreamVO``,
   whose vmapped step selects BA) over 9 frames, streams 0 and 1 against
   the card's ``VOSystem``: poses, map positions and BA runs bit-equal (a
   gap under 1e-5 m tolerated and printed); then ``measure_if_node``
   (with the node's body count);
5. the benchmark entry point (``lvt_tpu_torch/bench.py``, ``python -m
   lvt_tpu_torch bench``): its three modes at bench.py's sizes, each
   printing its JSON line: main (path 1's config, 400 frames, 24 timed
   chunks of 16), ``--ba`` (local BA window 4) and ``--multistream`` (8
   streams fed the same frames, 12 timed chunks of 8), on the prefix of
   the sequence every path takes. Each must capture one graph, in its
   warm-up chunk, make 0 host syncs in its timed loop, keep TRACKING on
   every frame (of every stream) that sees at least BENCH_IN_VIEW of the
   world's points, with the ATE under 5% over them, and BA on its schedule
   (bench.py's camera drives out of its world: the port and lvt_tpu lose
   track at frame 160, ``scripts/bench_world.py``); one
   untimed chunk more in a kernel trace must launch per frame exactly A 1,
   P 1, T 3 (``--ba`` also ``ba_observe`` 1 and one IF-node predicate;
   ``--multistream`` for
   all 8 streams at once) and the PnP solve 1. main's poses must equal
   path 1's over its 112 frames bit for bit, ``--ba``'s frames run BA's
   body on BA frames only (``_frame_types``) and PnP is held on its
   inputs, and the 8 streams must equal each other bit for bit and main
   within 1e-5 m. A, P and T against their plain versions at each mode's
   shapes;
6. path 3, many streams (bench.py --multistream's shape): path 1's config
   through ``MultiStreamVO(config, 8, device="cuda").track_chunk``, 56
   frames in chunks of 8, stream i from frame 2i of the same sequence: every
   stream TRACKING with its ATE under 5% of its distance, 0 host syncs in
   a chunk, and per frame exactly one launch of A and P and three of T
   for all 8 streams; prints the aggregate and per-stream frames/s; then
   at the shapes of the path's frame 0, bit for bit against the plain
   versions: A on all 16 images, P on their [16, 1536] slots, T in one
   launch over the 8 streams at each of the path's sites (map, staged,
   row), and frame 0's features of all 16 images card against CPU;
   streams 0 and 1 within 1e-3 m of the card's single-stream VOSystem
   over the same frames, and streams 0-1 over frames 0-3 within 1e-3 m of
   the CPU; phase 2 has also timed T's batched launch at 8 streams of
   real descriptor sets (and at TUM fr1's 8192 x 1024) beside its bound
   and 8 single launches;
7. path 4, RGB-D at 640x480 (the oracle's `rgbd` scenario: its world and
   config): ``VOSystem(config, SensorType.RGBD, device="cuda")
   .track_chunk`` over 56 frames (TRACKING, ATE under 5%, 0 syncs, per
   frame exactly one A, one P and two T: map match and staged re-match),
   A, P and T against their plain versions at the shapes of frame 0 for
   one stream and for 4 (T at both sites), frame 0's features card
   against CPU, the card against the CPU over frames 0-3 (1e-3 m), then
   ``MultiStreamVO(rgbd=True)`` with 4 streams over 16 frames (all
   TRACKING, graph = eager bit for bit), then one frame through ``extract_features_rgbd`` at the TUM
   fr1 YAML with its distortion, card against CPU (``valid`` and ``desc``
   equal, ``kp`` within 1e-3 px). The synthetic world renders an ideal
   pinhole, so tracking a sequence under the YAML's distortion would be
   meaningless: the distortion is checked on extraction only;
8. PnP (not a TPU kernel: lvt_tpu runs solve_pnp,
   lvt_tpu/solver/pnp.py:109-214, as XLA ops): the fused solve
   ``lvt_tpu_torch::pnp_solve`` (``csrc/pnp_lm.cu``, one block per stream,
   one sweep over the points per LM iteration, the step on one warp)
   on the inputs it took in one more frame of path 3's 8 streams, at S =
   1 and S = 8, against its plain version on the card stream by stream:
   every output (pose, inlier mask and count, chi2) bit-equal (the gaps
   printed); then again on the same inputs with 3-70 valid points per stream
   (``few_inliers``) (every gap printed; the same checks after paths 1,
   2, 4, 5, 6, each tree of path 7 and path 8's reference, a VOSystem's
   8 more frames stacked as 8 streams); every stream of the S = 8 launch
   bit-equal to its S = 1 launch; the sharded solve's phases
   (``lvt_tpu_torch::pnp_phase``) on one rank bit-equal to the fused
   kernel; the kernel timed beside its bound, the plain version captured
   in a CUDA graph and the phases. Then the plain version's two
   reduction ops (``csrc/pnp.cu``, no longer on the main path):
   ``lvt_tpu_torch::pnp_normal_eqs`` and ``lvt_tpu_torch::stream_sum`` on
   the inputs they took in the plain solves of the same streams: within
   1e-5 of the sum of each output's term magnitudes of their plain
   versions, every stream of the S = 8 launch bit-equal to its S = 1
   launch, timed beside the bound and one PyTorch call; path 3's streams
   0 and 1 must equal the single stream (any gap printed, and under 1e-5
   m);
9. path 5, EuRoC rectified stereo (``configs.euroc_config()``: 752x480,
   896 keypoint slots, 4096 map points, no staged points): raw distorted
   uint8 frames of the EuRoC rig (``io.datasets.render_euroc_raw``)
   through ``VOSystem(config, rectify_maps=io.datasets
   .euroc_rectify_maps())``, remapped inside the step, 56 frames in chunks
   of 8: every frame TRACKING, ATE under 5%, 0 host syncs per chunk,
   exactly A 1, P 1, T 2 (map, row) per frame; frame 0's remapped pair and
   features card vs CPU bit-equal; kernel A's float32 kernel, P and T (map
   4096 x 896, row) against their plain versions at its shapes; poses of
   frames 0-3 card vs CPU within 1e-3 m; PnP as in phase 8 at this path's
   M = 4096 (the other paths have path 3's 1024), on 8 more frames as S
   = 8 streams;
10. path 6, external corners (``configs.kitti_config()``, path 1's frames):
   corners from the port's own extraction on the card, passed as host
   [N, 2] arrays to ``VOSystem.track_with_external_corners`` for 32 frames
   (one call each):
   every frame TRACKING, ATE under 5%, 0 host syncs in the step, exactly A
   0, P 0, T 3 per frame; frame 0's descriptors card vs CPU bit-equal;
   poses of frames 0-3 card vs CPU within 1e-3 m;
11. path 7, the dataset CLIs: 48 frames each of paths 1 and 5 and of
   path 4's camera over a cloud 2-12 m deep (the TUM depth format holds
   13.1 m) written as PNG trees in the KITTI, EuRoC and TUM layouts
   (``write_png``: Python's zlib, no OpenCV), every PNG decoded bit-equal
   by the port's decoder (built here with g++, its seconds printed), then
   ``lvt_tpu_torch.cli.main`` kitti (the shipped YAML: patch mode, local
   BA), euroc and tum in-process on the card with ``--chunk 16
   --record``: each trajectory file byte-equal to ``dump_kitti`` /
   ``dump_tum`` of an in-process ``VOSystem.track_chunk`` on the card over
   the decoded arrays in the same chunks, every frame TRACKING, aligned
   ATE under 5%, ``measurments.txt`` 48 rows and the reference titles,
   per frame exactly A 1, P 1, T 3 / 2 / 2, the PnP solve 1 and B 0, and
   the host syncs of the whole run, by the Python line that made each,
   exactly one per chunk in ``cli._track_sequence`` (statuses and poses)
   and one in ``observability._series_on_host`` (the recorder); without
   ``--record`` the first only, and the same file; A, P and T against
   their plain versions at each tree's frame 0 (T at the BA row site on
   kitti); frames/s end to end and in process, decode ms per frame and
   the set-up apart;
12. the C ABI: ``liblvt_c_torch.so`` and ``lvt_tpu_torch/native/
   lvt_c_example.c`` built here, 8 KITTI frames through ``lvt_track`` on
   the card in a subprocess: status 1, 2 after each frame, 1 after
   ``lvt_reset``, every pose equal at ``%.9g`` to the in-process card run;
13. path 8, the sharded modes on ``torch.distributed`` (ranks are
   processes started with the ``spawn`` method by
   ``lvt_tpu_torch.parallel.dryrun.spawn``, after the kernels are built
   here; every rank on ``cuda:0``), with path 7 kitti's config (the
   shipped KITTI YAML: patch mode, local BA window 4 every 4) on path 1's
   frames: 8a, ``ShardedStreamVO`` on one NCCL rank in this process (its
   all-reduces captured in the graph), 24 frames in units of 3, graph
   and eager: poses, statuses and map sizes bit-equal to
   ``VOSystem`` on the card, 0 host syncs per chunk, per frame exactly A
   1, P 1, T 3, PnP's phases 23, ``predict_project``, ``upkeep_pre`` and
   ``ba_observe`` 1 each (their kernels on the rank's block), and
   ``collectives_per_frame`` all-reduces (eager: 60; in the graph 60 on BA
   frames, 45 on the others, whose NCCL kernels ``_frame_types`` reads:
   none on one rank), local BA's phases (``ba_phase``, BA_PHASES a BA by
   the kernel's own count: on BA frames only in the graph, on every frame
   eagerly); the three tracking ops on 8a's eager frames bit-equal to
   their plain group versions (``check_group_ops``);
   kernels A, P and T (map and staged at M / 2 and M / 4 rows) against
   their plain versions at the shard shapes, T's map site, the PnP solve
   and its phases (checked as in phase 8 on the reference's inputs cut to
   M / n points) and the plain version's two ops timed at M = 512 and
   256; whether NCCL
   takes 2 ranks on one card (if not, 8b-8d carry their collectives on
   gloo with CUDA tensors, staged through the host, and the backend is
   printed); 8b, ``ShardedStreamVO`` on 2 and 4 ranks over the same
   frames: every rank and frame TRACKING, the poses equal on all ranks
   and within 3e-4 m of the unsharded run (the gap printed), the summed
   map size equal to the unsharded one (per-frame gaps printed), each
   rank's valid points within its block, the launches and collectives of
   8a on every rank; 8c, ``StreamPointVO`` with 2 streams x 2 point
   shards on 4 ranks, 16 frames, stream i from frame 2i: each stream
   within 3e-4 m of the card's ``VOSystem`` over its frames, every frame
   TRACKING, no vmap fallback; 8d, ``MultiStreamVO`` on a 2-rank stream
   mesh with path 3's 8 streams, 16 frames: each rank's 4 streams
   bit-equal to path 3's one-process run, no collective; then 8b at 2
   ranks on gloo CPU processes over frames 0-2, within 1e-3 m of the card;
   frames/s of each;
14. a JSON line with each kernel's launches and largest error against its
   plain version (in all, and by path), times and bound (T per site, per
   frame of paths 1-2, batched and at path 8's shard rows; PnP's solve,
   phases and ops at S = 1 and 8, and at path 8's M; ``ba_refine``, the
   tracking kernels, the selection and the map match's acceptance at S =
   1 and 8), then the last line
   ``{"ok": true, "device": {...}}``.

Every path runs its step as the port does by default: a CUDA graph of the
step captured at the first frame of each system and entry point and
replayed per frame (``lvt_tpu_torch/core/graphs.py``). Paths 1-6 and 8a
also run the same frames on a second system under
``graphs.disable_graphs()`` (the eager step), in turns with the graph,
unit by unit (``RUNS``: a unit is one ``track_chunk`` call, on path 6
EXT_UNIT calls of one frame): unit 0 warms up (the graphs are captured),
unit 1 counts the host syncs of both modes (0 each), the rest (5 or more)
are timed, the mode that goes first alternating. The graph must equal the
eager step bit for bit (poses, statuses, every metrics leaf,
``local_ba_ran``; a pose gap under 1e-5 m is printed and tolerated,
1e-5 m fails); each path prints both modes' frames/s (median, min, max),
the host ms per frame of the replay loop, the capture seconds per graph,
the peak device memory, and, from one more graphed unit under
``torch.profiler``, the device busy time against the span from its first
kernel's start to its last one's end, the device kernels per frame and
each hand-written kernel's launches as the card ran them. 8b and 8c run
eagerly (gloo), 8d graphed, and each says so; path 7's StreamingVO runs
16 frames of path 7 kitti's config (local BA) graphed in its worker
thread, its poses bit-equal to ``VOSystem.track``'s. Local BA is a CUDA
IF node in every graph whose step is not vmapped (paths 2, 7 kitti, 8a;
core/graphs.py), so on those paths a frame's kernels depend on its type:
``_frame_types`` reads them per frame (NEED_PER_FRAME and one predicate
kernel on every frame; BA's kernels, on 8a its phases and their 3 + 2
per iteration all-reduces, on BA frames only).

Every path launches the fused PnP solve once per frame; paths 8a-8c,
whose points are sharded, launch its phases instead, 23 per frame (2
passes x (a setup + 5 x (normal equations, trial step)) + the last
demotion). The plain version's two reduction ops run on no path. Every
unsharded path launches the tracking branch's four kernels (``csrc/track.cu``, not
TPU kernels: ``predict_project``, ``upkeep_pre``, ``staged_promote``,
which paths 5 and 7 euroc, without staged points, do not run, and
``triangulate_insert``) once per frame each; 8a-8c launch the first two
on the rank's block (``upkeep_pre`` followed by its two collectives) and
run the plain versions of the other two (torch ops and collectives).
Every path that extracts (all but
path 6) launches the corner selection's kernel (``select_corners``,
``csrc/select.cu``: a thread-block cluster per cell) once per frame for
all its images, and every
unsharded path the map match's acceptance after T (``map_accept``,
``csrc/track.cu``) and the step's tail (``step_tail``, ``csrc/tail.cu``:
the selects on the frame's outcome and the metrics) once per frame (path
3 once for its 8 streams). The tail's launch ends the frame (the new
state into the runner's buffers, MultiStreamVO's reset, the pose and the
metrics into the chunk's rows, the next frame into the input buffers, a
counter on the card), so a graphed frame is one replay and nothing else
from the host; every chunk starts with one launch of the runner's copy
(``copy_leaves``, ``csrc/tail.cu``: its table, frame 0), on every path
(NEED_PER_CHUNK), and paths 8a-8c end each frame with one more after
their tail's torch ops; none is a TPU kernel. Paths 1-7 hold the host's
launches around a graphed unit's replays (path 6: its calls, path 7:
StreamingVO's worker thread) at exactly, per chunk, the caller's uploads,
the chunk's start and one replay a frame with nothing between
(``host_between_replays``, a trace's runtime-API records named by what
they ran on the card). Wherever
PnP's inputs are captured (``capture_pnp_inputs``: after paths 1-6, each
tree of path 7, path 8's reference, the bench's modes) the same frames'
inputs of these seven kernels are held bit-equal to their plain versions
on the card, frame 0 as launched and the last 8 streams (images) in one
launch, each stream against its S = 1 launch, the selection also with
the low-corner fallback never and always taken (``check_track_kernels``;
the selection also on TUM fr1's one cell of 640 x 480 keeping 1000, at 1
and 8 images, after path 4), and the tail ending a runner's frame
against the plain tail and the runner's copies, with the reset on and
off and two buffers swapped, and the copies (a chunk's start, a group's
frame end, a state) against torch ops (``check_frame_end``); after path
2 they are timed on path 1's inputs at S = 1 (the selection: a frame's 2
images) and 8 beside their bounds, their plain versions graphed and, for
the selection, ``torch.topk`` of its packed keys (``measure_track_kernels``);
the tail ending a frame also at M = 4096, 8192 and 16384
(``measure_step_tail``); the chunk's start against
``torch._foreach_copy_`` (``measure_copy_leaves``). Local
BA's kernel runs on BA_KERNEL_PATHS (path 2, path 7 kitti, the bench's
``--ba``): once per BA frame in a graph, once per frame eagerly, once in
a graph's warm-up and once in its capture. On 8a-8c its phases
(``ba_phase``, ``bundle.refine_structure_phases``: ``ba_refine``'s code
split at its sums over the points, an all-reduce of their float64
partials between launches) run BA_PHASES times per BA the same way, and
BA's torch ops on no path; wherever ``ba_refine`` is held against its
plain version, the phases on one rank are held bit-equal to it, at S
streams in one launch per phase, each stream alone, and on the windows
cut to M / 2 and M / 4 points (``check_ba_phase``), and timed beside it
on the 8-stream unit's windows (``measure_ba_refine``).
Every kernel's launch count is set to 0 just before a path runs (on
path 7, each CLI run; on path 8, in each rank; on the bench, each mode)
and read just after it. A
wrapper counts where Python calls it: at every frame of an eager step,
at a graph's warm-up and capture (a replay calls no Python). So where a
graph ran, what the card ran is read from a kernel trace
(``dryrun.device_launches``): on paths 1-6 and 8a the profiled graphed
unit, on path 7 each CLI run, in path 8's graphed ranks (8d) chunk 0
(with the graph's warm-up step), on the bench one untimed chunk after the
timed ones. Each must be exactly NEED_PER_FRAME per frame and
NEED_PER_CHUNK per chunk; the wrappers' counts must be NEED_PER_FRAME per
eager frame and twice per graph, and NEED_PER_CHUNK per chunk in both. The ``kernels`` line's launches are the traced ones where a graph
ran, the wrappers' where the step ran eagerly (8b, 8c). The comparisons
of phase 2 and the cross-checks after each path (path 7's in-process
runs, path 8's unsharded reference) are not counted.

``--profile DIR`` also writes a torch.profiler table of one eager unit per
path to DIR, with host and device time per stage (the profiler ranges of
the step fire only in an eager step). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from collections import Counter
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CHUNK = 16          # path 7's chunks, path 8's reference chunks
# paths 1-5, 8a: (frames per unit, units): unit 0 warms up (the graphs are
# captured), unit 1 counts host syncs, the rest are timed, graph and eager
# in turns (a unit is a track_chunk call; path 3's and 4's streams and
# path 8a's ranks as below)
RUNS = {"path1": (16, 7), "path2": (6, 7), "path3": (8, 7), "path4": (8, 7),
        "path5": (8, 7), "path8a": (3, 8)}
N_CPU_FRAMES = {"path1": 4, "path2": 9, "path4": 4, "path5": 4,
                "path6": 4, "sparse": 4}
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
    # not TPU kernels: lvt_tpu's PnP solve (XLA ops under jit), whole
    # (one block per stream) and, on the points-sharded paths, split at
    # its reductions; then the plain version's two reductions in a fixed
    # order, which the main path no longer runs
    "pnp_solve": ("cuda", "lvt_tpu_torch/csrc/pnp_lm.cu",
                  "lvt_tpu/solver/pnp.py:109-214"),
    "pnp_phase": ("cuda", "lvt_tpu_torch/csrc/pnp_lm.cu",
                  "lvt_tpu/solver/pnp.py:109-214 (axis_name set)"),
    "pnp_normal_eqs": ("cuda", "lvt_tpu_torch/csrc/pnp.cu",
                       "lvt_tpu/solver/pnp.py:155-156"),
    "stream_sum": ("cuda", "lvt_tpu_torch/csrc/pnp.cu",
                   "lvt_tpu/solver/pnp.py:148"),
    # not TPU kernels: lvt_tpu's local BA body (XLA ops under jit, the run
    # branch of the lax.cond at lvt_tpu/core/step.py:269-318), one cluster
    # of blocks per stream, whole on the unsharded BA paths and, on the
    # points-sharded paths (8a-8c; lvt_tpu's psum_axis under shard_map),
    # split at its sums over the points
    "ba_refine": ("cuda", "lvt_tpu_torch/csrc/ba.cu",
                  "lvt_tpu/solver/bundle.py:93-378"),
    "ba_phase": ("cuda", "lvt_tpu_torch/csrc/ba.cu",
                 "lvt_tpu/solver/bundle.py:93-395 (psum_axis set)"),
    # not TPU kernels: the tracking branch's per-point work around kernel
    # T, which XLA fuses under jit (core/track.py); on every unsharded path,
    # and predict_project and upkeep_pre on the sharded ones too (the
    # sharded step keeps the torch ops and collectives of the other two)
    "predict_project": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                        "lvt_tpu/core/motion.py:36 + "
                        "lvt_tpu/ops/matching.py:83-100"),
    "upkeep_pre": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                   "lvt_tpu/core/map.py:71-99 + "
                   "lvt_tpu/core/step.py:171-190"),
    "staged_promote": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                       "lvt_tpu/core/step.py:190-231 + "
                       "lvt_tpu/core/map.py:28-68"),
    "triangulate_insert": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                           "lvt_tpu/ops/triangulate.py:40-160 + "
                           "lvt_tpu/core/step.py:111-155"),
    # not a TPU kernel: local BA's row match after kernel T and the
    # observation window's slide (XLA ops under jit), on every BA path
    "ba_observe": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                   "lvt_tpu/core/step.py:486-512 + "
                   "lvt_tpu/core/step.py:232-267"),
    # not TPU kernels: the per-cell corner selection with its padding and
    # clamps (XLA ops under jit; every path that extracts: not path 6),
    # and the map match after kernel T with the step's glue before PnP
    # (every unsharded path)
    "select_corners": ("cuda", "lvt_tpu_torch/csrc/select.cu",
                       "lvt_tpu/ops/detect.py:280-382 + "
                       "lvt_tpu/core/extract.py:115,168-189"),
    "map_accept": ("cuda", "lvt_tpu_torch/csrc/track.cu",
                   "lvt_tpu/ops/matching.py:76-151 + "
                   "lvt_tpu/core/step.py:400-401"),
    # not TPU kernels: the step's tail, the selects on the frame's outcome
    # and the metrics (XLA ops under jit; every unsharded path), and the
    # runner's copy of the new state into its static buffers (lvt_tpu's
    # lax.scan carries its state in XLA's buffers; every path)
    "step_tail": ("cuda", "lvt_tpu_torch/csrc/tail.cu",
                  "lvt_tpu/core/step.py:531-570 + "
                  "lvt_tpu/core/step.py:597-612"),
    "copy_leaves": ("cuda", "lvt_tpu_torch/csrc/tail.cu",
                    "lvt_tpu/core/step.py:665 (lax.scan's carry)"),
}
# the tracking branch's four ops, in the step's order
TRACK_KERNELS = ("predict_project", "upkeep_pre", "staged_promote",
                 "triangulate_insert")
# the selection and the map match's acceptance: captured and checked with
# the tracking branch's ops (STEP_OPS, check_track_kernels), timed apart;
# local BA's observations (BA paths only) and kernel T's row-mode launches
# (T_ROW: the stereo paths' one row launch a frame, single or dual)
SELECT_ACCEPT = ("select_corners", "map_accept")
T_ROW = "hamming_top2_row"
STEP_OPS = TRACK_KERNELS + SELECT_ACCEPT + ("step_tail", "ba_observe", T_ROW)
# the paths without a right camera: no row launch of kernel T
RGBD_PATHS = ("path4", "path7-tum")
# the paths whose config has no staged set (staged_threshold 0): no staged
# re-match, so no staged_promote
NO_STAGED_PATHS = ("path5", "path7-euroc")
# the paths whose local BA body is the ba_refine kernel: once per BA frame
# in a graph (the IF node's body), once per frame in an eager step (BA
# computed and selected), once in a graph's warm-up and once in its capture
BA_KERNEL_PATHS = ("path2", "path7-kitti", "bench-ba")
# lvt_tpu's one lax.cond (local BA on its schedule) as a CUDA IF node:
# the predicate kernel and the node it sets, made in a captured graph by
# core/graphs.py::cond; held against the select it replaces
IF_NODE = ("cuda", "lvt_tpu_torch/csrc/graph_cond.cu",
           "lvt_tpu/core/step.py:323 (jax.lax.cond: an XLA conditional, "
           "not a TPU kernel)")
IF_REPS = 20        # back-to-back replays per timing of measure_if_node
# the TPU kernels' counterparts, held against their plain versions at
# every path's shapes
SITE_KERNELS = ("perception", "brief", "describe_refine", "hamming_top2")
# the two ways of running a step: the graph of it replayed (the main
# path) and the step called eagerly (graphs.disable_graphs())
MODES = ("graph", "eager")
# path 3: bench.py --multistream's shape, S streams in RUNS' units; stream
# i starts at frame MS_START_STEP * i of the path-1 sequence, so the
# streams differ
MS_STREAMS = 8
MS_START_STEP = 2
MS_CPU = (2, 4)         # streams x frames rerun on the CPU
# path 4: RGB-D at 640x480 (the oracle's `rgbd` scenario), then S = 4
# streams of RGB-D over 16 frames
RGBD_SPEED = 0.5
RGBD_MS = (4, 16)
# path 5: EuRoC rectified, raw frames of a point cloud (N_PTS points in
# +-X x +-Y x [2, Z] m) seen from a rig moving EUROC_SPEED m per frame
# along its optical axis
EUROC_SPEED = 0.2
EUROC_CLOUD = dict(n=4000, x=15.0, y=8.0, z=40.0)
# path 6: external corners, frames of path 1, one call per frame; units
# of EXT_UNIT frames for _run_modes
EXT_FRAMES = 32
EXT_UNIT = 4
# path 7: the dataset CLIs over 48 frames written as PNG trees: paths 1
# and 5's frames; for TUM path 4's camera and config over a cloud within
# the format's depth range (65535 / 5000 = 13.1 m; path 4's world reaches
# 120 m), 2-12 m deep, the camera moving TUM_SPEED m per frame. EuRoC
# stamps from MH_01_easy's first, 20 Hz
CLI_STAMP0_NS = 1403636579763555584
CLI_DT_NS = 50000000
TUM_CLOUD = dict(x=6.0, y=4.5, z=12.0)
TUM_SPEED = 0.05
# PnP per frame: one launch of the fused solve; on the points-sharded
# paths (8a-8c) its phases instead, 2 passes x (a setup + 5 iterations x
# (normal equations, trial step)) + the last demotion
PNP_PHASES = 2 * (1 + 2 * 5) + 1
SHARDED_PATHS = ("path8a", "path8b-2", "path8b-4", "path8c")
# local BA's body on the points-sharded paths, per BA: the launches of its
# phases (bundle.n_phases) at path 8's config's 6 LM iterations: the
# gate's two, the weights and first chi-square, 6 x (sums, trial step),
# the writeback
BA_ITERATIONS = 6
BA_PHASES = 4 + 2 * BA_ITERATIONS
# the plain version's launches of each of its two reduction ops per solve:
# 2 passes x (the damping's diagonal or the starting chi-square + 5 LM
# iterations)
PNP_PLAIN_OPS = 12
# the work per point that the solve needs (the plain version's, which
# keeps each projection; csrc/pnp_lm.cu recomputes it and folds all of
# [H | g]): float32 operations, 2 setups of 64 (projection 30, Cauchy
# weight 4, Jacobian 14, jw 12, chi-square term 4, a division or log1p
# counted as one), 10 iterations of 30 at the kept projection (Cauchy
# weight, Jacobian, jw) and 34 at the trial pose (projection, chi-square
# term), and 2 demotions of 2; float64 fused multiply-adds, 10 x 54 for
# [H | g] (H is symmetric: its upper triangle and g, 27 sums per
# Jacobian row) and 2 x 12 for H's diagonal, all of them sums of a matrix
# product, so at the tensor cores' float64 rate; bytes, 24 in (points,
# obs, weights) and 1 out (the inlier mask), and per stream 28 in (t, q)
# and 40 out (t, q, count, chi2)
PNP_FP32_PER_POINT = 2 * 64 + 10 * (30 + 34) + 2 * 2
PNP_FP64_PER_POINT = 10 * 54 + 2 * 12
# local BA's body (csrc/ba.cu), the work the function needs: per LM
# iteration, per observation that takes part (a gated weight > 0; left and
# right apart) 82 float32 operations (the camera point 15, the projection
# and e2 13, the Cauchy weight 4, the Jacobian's factors 6, jc_w 12, and at
# the trial state the camera point, projection, e2 and the chi-square term
# 32) and 144 float64 fused multiply-adds (jc 24 and jp 12, the non-zero
# products; h_cp 36; the symmetric products by their upper triangles, as
# PnP's H: h_pp 12, h_cc 42; g_p = J_p^T W r 6, g_c 12); per point that
# takes part 60 float32 (h_pp's inverse 50, the point step 10) and, for F
# poses of which F - 1 are free, 18 F + 9 (the point step) + 54 (F - 1)
# (h_cp h_pp^-1) + S's Schur sums by its upper triangle, 108 per pair of
# free poses and 63 per free pose (the upper half of a diagonal block) +
# 18 (F - 1) (g_red's) float64;
# the 6 (F - 1) reduced system's LU and solves, n^3 / 3 + n^2; once, per
# observation with a positive input weight 152 float32 (the gate's two
# sweeps and the weights' third, at 30 each; the starting chi-square 32;
# the fit before and after, 30 each) and per map point 15 (the trust
# region). Every float64 operation is a sum of a matrix product, so at the
# tensor cores' float64 rate. Bytes: per stream the window's poses (28 F),
# per point its position in and out (24) and per pose its two
# observations and weights (24 F), and chi2, n_obs and the accept bits
BA_FP32_PER_OBS_ITER = 82
BA_FP64_PER_OBS_ITER = 144
BA_FP32_PER_POINT_ITER = 60
BA_FP32_PER_OBS = 152
BA_FP32_PER_POINT = 15
# the points that stream i keeps in check_ba_refine's few-point windows
FEW_BA_POINTS = (3, 8, 16, 40, 100, 200, 400, 700)
# launches each path makes per frame, exactly (path 3's for all S streams
# at once: one batch, not S)
NEED_PER_FRAME = {
    "path1": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path2": {"perception": 1, "brief": 1, "hamming_top2": 3},
    "path3": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path4": {"perception": 1, "describe_refine": 1, "hamming_top2": 2},
    # staged_threshold 0: no staged re-match
    "path5": {"perception": 1, "describe_refine": 1, "hamming_top2": 2},
    # descriptors from the box sums at the corners: no A, no P
    "path6": {"hamming_top2": 3},
    # the CLIs (patch mode): kitti with the shipped YAML's local BA (T's
    # row launch serving both row matches), euroc without staged points,
    # tum with them
    "path7-kitti": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path7-euroc": {"perception": 1, "describe_refine": 1, "hamming_top2": 2},
    "path7-tum": {"perception": 1, "describe_refine": 1, "hamming_top2": 2},
    # the sharded modes, per rank: path 7 kitti's config (T's dual row
    # launch) on 8a-8c, path 3's on 8d (per rank, for its 4 streams)
    "path8a": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path8b-2": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path8b-4": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path8c": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "path8d": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    # the benchmark's modes: main is path 1, --ba path 1's config with
    # local BA (T's dual row launch), --multistream path 3's
    "bench": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "bench-ba": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
    "bench-ms": {"perception": 1, "describe_refine": 1, "hamming_top2": 3},
}
for _path, _need in NEED_PER_FRAME.items():
    _need.update({"pnp_phase": PNP_PHASES} if _path in SHARDED_PATHS
                 else {"pnp_solve": 1})
    if _path in SHARDED_PATHS:
        # the frame's end after the tail's torch ops (the unsharded paths'
        # tail ends the frame itself); the tracking ops that launch their
        # kernels on a rank's block (core/track.py GROUP_OPS), local BA's
        # observations among them
        _need["copy_leaves"] = 1
        _need.update(dict.fromkeys(("predict_project", "upkeep_pre",
                                    "ba_observe"), 1))
    else:
        _need.update(dict.fromkeys(TRACK_KERNELS, 1), map_accept=1,
                     step_tail=1)
        if _path in NO_STAGED_PATHS:
            del _need["staged_promote"]
        if _path in BA_KERNEL_PATHS:   # local BA's observations
            _need["ba_observe"] = 1
    if _path != "path6":   # external corners: no selection
        _need["select_corners"] = 1
# launches each chunk makes on every path, exactly: its start (the
# runner's table, frame 0's inputs; core/graphs.py::Epilogue.start)
NEED_PER_CHUNK = {"copy_leaves": 1}
# chunks per unit of _run_modes: a track_chunk call, but on path 6 one
# track_with_external_corners call a frame (a chunk of one)
CHUNKS_PER_UNIT = {"path6": EXT_UNIT}
# on the paths whose local BA is a CUDA IF node in their graph, per frame
# type (a BA frame, any other): the kernel that sets the node's predicate
# (csrc/graph_cond.cu) and the NCCL kernels (on one rank NCCL's
# all-reduce launches none: every traced unit of 8a counts 0).
# NEED_PER_FRAME's kernels are the same on both types; BA's own, the
# node's body, run on BA frames only (_frame_types). 8b-8c run eagerly on
# gloo, BA computed and selected: their wrappers and all-reduces count
# alike on both types
NEED_BY_FRAME_TYPE = {
    path: {"ba": {"if_node": 1, "nccl": 0,
                  "ba_refine": int(path in BA_KERNEL_PATHS),
                  "ba_phase": BA_PHASES * (path in SHARDED_PATHS)},
           "other": {"if_node": 1, "nccl": 0, "ba_refine": 0, "ba_phase": 0}}
    for path in ("path2", "path7-kitti", "path8a", "bench-ba")}
# kernel T's sites in one frame of each path
T_SITES = {"path1": ("map", "staged", "row"),
           "path2": ("map", "staged", "row_dual"),
           "path3": ("map", "staged", "row"),
           "path4": ("map", "staged"),
           "path5": ("map", "row"),
           "path7-kitti": ("map", "staged", "row_dual"),
           "path7-euroc": ("map", "row"),
           "path7-tum": ("map", "staged"),
           "bench": ("map", "staged", "row"),
           "bench-ba": ("map", "staged", "row_dual"),
           "bench-ms": ("map", "staged", "row")}

# ---- the card model behind every bound
# device memory: H100 SXM, 3.35 TB/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# issue rates per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 32-bit integer
# add/subtract/min/max/logic/compare and float compare on the ALU pipe 64;
# float32 add/multiply 128; float64 add/multiply/fused multiply-add 64;
# population count 16; and float64 fused multiply-adds on the tensor cores
# (DMMA) 128: 67 TFLOP/s at 132 SMs and 1.98 GHz (NVIDIA's data sheet),
# the card's peak for float64 work that is a matrix product
RATE_PER_SM_CLOCK = {"alu": 64, "fp32": 128, "fp64": 64, "popc": 16,
                     "fp64_tensor": 128}
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


def _n_frames(path: str) -> int:
    chunk, n_units = RUNS[path]
    return chunk * n_units


def write_png(path: str, img: np.ndarray) -> None:
    """A grayscale PNG of ``img`` (uint8: 8-bit, uint16: 16-bit), filter
    type 0 on every row, deflated with Python's zlib: path 7's trees are
    written without OpenCV, which the card's machine lacks."""
    h, w = img.shape
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[img.dtype]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


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
    """Output tensors of a call, nested tuples flattened (other values
    left out)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return []


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


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def card_info() -> dict:
    """The card's name, SM count and maximum SM clock (for the bounds)."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs one CUDA device")
    return dict(name=torch.cuda.get_device_name(0),
                sms=torch.cuda.get_device_properties(0).multi_processor_count,
                clock_hz=1e6 * float(_smi("clocks.max.sm").split()[0]))


def phase_device() -> dict:
    from lvt_tpu_torch import kernels

    card = card_info()
    _say("device", f"{card['name']}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}, driver "
                   f"{_smi('driver_version')}")
    print(_smi("name,power.limit"), flush=True)
    _say("device", f"{card['sms']} SMs, max SM clock "
                   f"{card['clock_hz'] / 1e6:.0f} MHz; bounds at "
                   f"{HBM_BYTES_PER_S / 1e12} TB/s and {RATE_PER_SM_CLOCK} "
                   f"per SM per clock")
    kernels.build(verbose=True)
    kernels.lib()
    _say("device", f"kernels built in {kernels.build_seconds:.2f} s "
                   f"({kernels.library_path().name})")
    card["ba_geometry"] = ba_geometry()
    _say("device", "ba_refine: a cluster of {cluster} blocks of {threads} "
                   "threads per stream; ptxas: {ptxas}".format(
                       **card["ba_geometry"]))
    card["pnp_geometry"] = pnp_geometry()
    _say("device", "pnp_solve: {cluster} block of {threads} threads per "
                   "stream; ptxas: {ptxas}".format(**card["pnp_geometry"]))
    card["select_geometry"] = select_geometry()
    _say("device", "select_corners: a cluster of {cluster} blocks per cell "
                   "(TUM fr1's cell: {cluster_tum}); its launches: "
                   "{launch_shapes}; ptxas: {ptxas}".format(
                       **card["select_geometry"]))
    card["track_geometry"] = track_geometry()
    for name, geo in card["track_geometry"].items():
        _say("device", "{name}: clusters of {threads}-thread blocks, "
                       "{launch_shapes}; ptxas: {ptxas}".format(name=name,
                                                                **geo))
    for name in ("predict_project", "ba_observe", "step_tail",
                 "copy_leaves"):
        _say("device", f"{name}: ptxas: {_ptxas(name + '_kernel')}")
    return card


def _distinct(shape, b, rows, cols) -> int:
    """Distinct map elements that the (b, rows, cols) index triples touch."""
    hit = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    hit[b, rows, cols] = True
    return int(hit.sum())


def ba_geometry() -> dict:
    """Local BA's kernel as built: blocks per stream (its cluster), threads
    per block, and ptxas's lines on it (stack frame and spills; registers,
    shared memory) from the verbose build's report."""
    from lvt_tpu_torch import kernels

    shape = (ctypes.c_int * 2)()
    kernels.check(kernels.lib().lvt_ba_geometry(shape), "ba_refine (shape)")
    ptxas = kernels.ptxas_report("ba_refine_kernel")
    if not ptxas:
        raise AssertionError("no ptxas report on ba_refine_kernel in the "
                             "verbose build")
    return dict(cluster=shape[0], threads=shape[1], ptxas="; ".join(ptxas))


def _ptxas(kernel: str) -> str:
    from lvt_tpu_torch import kernels

    lines = kernels.ptxas_report(kernel)
    if not lines:
        raise AssertionError(f"no ptxas report on {kernel} in the verbose "
                             f"build")
    return "; ".join(lines)


def pnp_geometry() -> dict:
    """PnP's fused solve as built: blocks per stream (its cluster: one),
    threads per block, and ptxas's lines on it."""
    from lvt_tpu_torch import kernels

    shape = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().lvt_pnp_shape(shape), "pnp_solve (shape)")
    return dict(cluster=shape[0], threads=shape[1],
                ptxas=_ptxas("pnp_solve_kernel"))


def select_geometry() -> dict:
    """The corner selection's kernel as built: blocks per cell (its
    cluster) at path 1's KITTI cells and at TUM fr1's one cell, threads per
    block as the wrapper picks them (``detect.select_threads``) at path 1's
    pair, path 3's 16 images and TUM fr1's cell at 1 and 8 images, with how
    many clusters the card runs at once at that size
    (cudaOccupancyMaxActiveClusters) beside the launch's clusters, and
    ptxas's lines on its instances (8 or 16 blocks, 512 or 256 threads)."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.configs import kitti_config, tum_rgbd_config
    from lvt_tpu_torch.ops import detect

    def shape(config):
        geo = (ctypes.c_int * 7)()
        if kernels.lib().lvt_select_geometry(
                config.img_height, config.img_width,
                config.detection_cell_size, config.max_keypoints_per_cell,
                config.kp_capacity, geo):
            raise AssertionError("select_corners refuses a path's config")
        return geo

    kitti, tum = kitti_config(), tum_rgbd_config(1)
    shapes = {}
    for label, config, b in (("path1", kitti, 2), ("path3", kitti, 16),
                             ("tum1", tum, 1), ("tum8", tum, 8)):
        dims = (b, config.img_height, config.img_width,
                config.detection_cell_size, config.max_keypoints_per_cell,
                config.kp_capacity)
        threads = detect.select_threads(0, *dims)
        n = kernels.lib().lvt_select_max_clusters(*dims, threads)
        shapes[label] = (f"{threads} threads, {n} clusters at once for "
                           f"{b * shape(config)[0]}")
    return dict(cluster=shape(kitti)[1], cluster_tum=shape(tum)[1],
                threads=int(shapes["path1"].split()[0]), launch_shapes=shapes,
                ptxas=_ptxas("select_corners_kernel"))


def track_geometry() -> dict:
    """The cluster kernels of csrc/track.cu (``staged_promote``,
    ``triangulate_insert``) as built: the blocks per stream the wrapper
    picks (``track.cluster_size``) at path 1's shape and at path 3's
    MS_STREAMS streams, with how many clusters the card runs at once
    (cudaOccupancyMaxActiveClusters), threads per block, and ptxas's lines
    on each."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.configs import kitti_config
    from lvt_tpu_torch.core import track

    config = kitti_config()
    k, m, n = (config.kp_capacity, config.max_map_points,
               config.max_staged_points)
    shape = (ctypes.c_int * 2)()
    kernels.check(kernels.lib().lvt_track_shape(shape), "track (shape)")
    out = {}
    for op, name in enumerate(("staged_promote", "triangulate_insert")):
        one = track.cluster_size(name, 0, 1, k, m, n)
        many = track.cluster_size(name, 0, MS_STREAMS, k, m, n)
        fit = kernels.lib().lvt_track_max_clusters(op, many, k, m, n, 0)
        out[name] = dict(
            cluster=one, threads=shape[1],
            launch_shapes=(f"S=1: {one} blocks a stream; S={MS_STREAMS}: "
                           f"{many}, {fit} such clusters at once"),
            ptxas=_ptxas(f"{name}_kernel"))
    return out


def p_inputs(config, imgs) -> tuple:
    """Kernel P's arguments as extraction builds them for ``imgs`` [B, H,
    W] on the card: kernel A's maps, and the corners selected on them,
    padded to kp_capacity."""
    from lvt_tpu_torch.core.extract import _spread_ties
    from lvt_tpu_torch.ops import detect, perception
    from lvt_tpu_torch.ops import patches as pt

    nms, raw, smooth = perception.perception_patch_maps_batched(imgs)
    h, w = imgs.shape[1:]
    det = detect.select_corners(
        nms, config.agast_threshold, cell_size=config.detection_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        corners_low_threshold=config.corners_low_threshold,
        img_hw=(h, w), spread_ties=_spread_ties(imgs))
    pad = config.kp_capacity - det.valid.shape[1]
    xi = torch.nn.functional.pad(det.kp_int[..., 0], (0, pad)).contiguous()
    yi = torch.nn.functional.pad(det.kp_int[..., 1], (0, pad)).contiguous()
    sel = torch.nn.functional.pad(det.valid, (0, pad)).contiguous()
    xc, yc = (c.contiguous() for c in pt.clamp_coords(xi, yi, h, w))
    return smooth, raw, xc, yc, xi, yi, sel, h, w


def _slots(x, m: int, last: bool = False):
    """``m`` rows of a [S, K, ...] feature field: its first m slots (the
    last m with ``last``), cycling through the K slots when m > K."""
    k = x.shape[1]
    start = k - m if last else 0
    return x[:, (torch.arange(m, device=x.device) + start) % k]


def t_site_inputs(config, l0, l1, r0=None) -> dict:
    """Kernel T's arguments at its sites in one frame, each with a leading
    stream axis, from real descriptor sets: FrameFeatures [S, K] of frame 0
    (left ``l0``, right ``r0``) and of frame 1 (left ``l1``). Frame 1's
    features stand for the map points (max_map_points of them) and the
    staged points (max_staged_points); with ``r0`` also the row matches of
    frame 0's left features against its right ones, T computing each
    query's window from its keypoint: ``row`` the triangulation's (the
    unmatched features), ``row_dual`` both sets in one launch (the BA row
    match queries the matched ones: half and half here)."""
    rad = float(config.tracking_radius)
    m, ms = config.max_map_points, config.max_staged_points
    matched = torch.from_numpy(np.random.RandomState(0).rand(
        l0.valid.shape[1]) < 0.5).to(l0.valid.device)
    q_map = [_slots(x, m) for x in (l1.desc, l1.kp, l1.valid)]
    q_staged = [_slots(x, ms, last=True) for x in (l1.desc, l1.kp, l1.valid)]
    sites = {
        "map": ((q_map[0], l0.desc, q_map[1], q_map[2], l0.kp, l0.valid),
                dict(r2a=rad * rad, r2b=4 * rad * rad)),
        "staged": ((q_staged[0], l0.desc, q_staged[1], q_staged[2], l0.kp,
                    l0.valid & ~matched), dict(r2a=rad * rad, r2b=rad * rad)),
    }
    if r0 is not None:
        kw = dict(row_mode=True,
                  row_radius=float(config.row_matching_vertical_search_radius),
                  img_rows=float(config.img_height))
        row = (l0.desc, r0.desc, l0.kp, l0.valid, r0.kp, r0.valid,
               matched.expand_as(l0.valid))
        sites["row"] = (row, kw)
        sites["row_dual"] = ((*row, row[-1]), kw)
    return {k: (tuple(x.contiguous() for x in a), kw)
            for k, (a, kw) in sites.items()}


def _streams(feats, idx):
    """FrameFeatures of the images ``idx`` of a batch."""
    return type(feats)(*(x[idx] for x in feats))


def kernel_inputs(config, il, ir) -> dict:
    """The kernels' inputs at paths 1 and 2's shapes, from two uint8 frames
    per side (``il``, ``ir`` on the card): the first pair (kernel A); P's
    arguments on it; and T's arguments at its sites, single-stream,
    from the real descriptor sets of both frames."""
    from lvt_tpu_torch.core.extract import extract_features_batched

    imgs = torch.stack([il[0], ir[0]])
    f = extract_features_batched(torch.cat([il[:2], ir[:2]]), config)
    sites = t_site_inputs(config, _streams(f, [0]), _streams(f, [1]),
                          _streams(f, [2]))
    return dict(imgs=imgs, p_args=p_inputs(config, imgs),
                sites={k: (tuple(x[0] for x in a), kw)
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
    its (plain) outputs: descriptors, coordinates and flags (row modes:
    the query sets' masks) in; d1, d2, best, n_cand for two predicates
    out; per pair of a querying feature and a valid target the mask test
    (radius: 2 sub, 2 mul, 1 add and 2 compares; window: 2 compares); per
    candidate pair 8 XOR + popcount and 7 adds, and per predicate that
    keeps it 4 to pack and keep the key (the dual radius mode's candidates
    are the wide radius's, which hold the narrow one's). The row modes'
    querying features are those of their sets (``row_work``)."""
    q_n, t_n = args[0].shape[0], args[1].shape[0]
    nbytes = ((q_n + t_n) * (32 + 8 + 1) + q_n * (len(args) - 6)
              + q_n * 2 * (4 + 4 + 8 + 8))
    if kw.get("row_mode", False):
        return nbytes, row_work(args[3], args[5], args[6],
                                args[7] if len(args) > 7 else None,
                                out[0][3], out[1][3])
    n_valid = int(args[3].sum()) * int(args[5].sum())
    n_cand = int(out[1 if kw["r2b"] > kw["r2a"] else 0][3].sum())
    return nbytes, {"fp32": 5 * n_valid, "alu": 2 * n_valid + 19 * n_cand,
                    "popc": 8 * n_cand}


def row_work(q_valid, t_valid, q_excl, q_incl, n_cand_a, n_cand_b) -> dict:
    """Kernel T's operations in a row mode ([..., M] query masks, [..., K]
    targets, the predicates' per-query candidate counts; ``q_incl`` None in
    the single mode): the window test for each query of set a (q_valid &
    ~q_excl) or set b (q_valid & q_incl) against each valid target, once
    where a query is in both sets; the distance (8 XOR + popcount, 7 adds)
    of each candidate pair of those queries once, since a query's
    candidates do not depend on the set that asks; the key's 4 for each
    set that keeps the pair."""
    in_a = q_valid & ~q_excl
    in_b = in_a if q_incl is None else q_valid & q_incl
    asks = in_a | in_b
    n_t = t_valid.sum(-1, keepdim=True)
    n_valid = int((asks.sum(-1, keepdim=True) * n_t).sum())
    n_a = int(torch.where(in_a, n_cand_a, 0).sum())
    n_b = 0 if q_incl is None else int(torch.where(in_b, n_cand_b, 0).sum())
    n_dist = n_a + (0 if q_incl is None
                    else int(torch.where(in_b & ~in_a, n_cand_b, 0).sum()))
    return {"alu": 2 * n_valid + 15 * n_dist + 4 * (n_a + n_b),
            "popc": 8 * n_dist}


def t_batched_inputs(config, il, config4, gray) -> dict:
    """Kernel T's batched launch at two shapes, from real descriptor sets:
    map matching of MS_STREAMS streams at path 3's shape (1024 map points
    x 1536 keypoints per stream; stream i: frame 2i + 1's first 1024
    features against frame 2i's), and one stream at TUM fr1's map-match
    shape (8192 x 1024: path 4's frames 1-8 against frame 0)."""
    from lvt_tpu_torch.core.extract import extract_features_batched

    m, rad = config.max_map_points, float(config.tracking_radius)
    f = extract_features_batched(il[:2 * MS_STREAMS], config)
    q = [x[1::2, :m] for x in (f.desc, f.kp, f.valid)]
    t = [x[0::2] for x in (f.desc, f.kp, f.valid)]
    streams = (q[0], t[0], q[1], q[2], t[1], t[2])
    g = extract_features_batched(gray[:9], config4)
    rad4 = float(config4.tracking_radius)
    tum = tuple(x[None] for x in (
        g.desc[1:].reshape(-1, 8), g.desc[0], g.kp[1:].reshape(-1, 2),
        g.valid[1:].reshape(-1), g.kp[0], g.valid[0]))
    return {
        f"s{MS_STREAMS}": (tuple(x.contiguous() for x in streams),
                           dict(r2a=rad * rad, r2b=4 * rad * rad)),
        "m8192": (tuple(x.contiguous() for x in tum),
                  dict(r2a=rad4 * rad4, r2b=4 * rad4 * rad4)),
    }


def measure_t_batched(card, inputs) -> dict:
    """The batched launch against the per-stream plain loop, bit for bit;
    its device time beside its bound (the sum of each stream's bytes and
    operations) and beside the same streams as single launches back to
    back (``singles_ms``: the S launches together)."""
    from lvt_tpu_torch.ops import top2

    rep = {}
    for name, (args, kw) in inputs.items():
        s = args[0].shape[0]
        want = top2.hamming_top2_plain_batched(*args, **kw)
        err = _require_equal(f"hamming_top2 batched ({name})",
                             top2.hamming_top2_batched(*args, **kw), want)
        nbytes, ops = 0, {}
        for i in range(s):
            b, o = t_work(tuple(x[i] for x in args), kw,
                          tuple(tuple(x[i] for x in p) for p in want))
            nbytes += b
            ops = {k: ops.get(k, 0) + v for k, v in o.items()}
        b_ms, b_by = bound(card, nbytes, ops)

        def singles(args=args, kw=kw, s=s):
            for i in range(s):
                top2.hamming_top2(*(x[i] for x in args), **kw)

        rep[name] = dict(
            s=s, m=args[0].shape[1], k=args[1].shape[1], max_abs_err=err,
            candidates=ops["popc"] // 8,
            ms=device_ms(lambda a=args, kw=kw: top2.hamming_top2_batched(
                *a, **kw), REPS),
            # as many launches queued as for the batched time (REPS)
            singles_ms=device_ms(singles, max(1, REPS // s)),
            plain_ms=device_ms(lambda a=args, kw=kw:
                               top2.hamming_top2_plain_batched(*a, **kw),
                               PLAIN_REPS),
            bound_ms=b_ms, bound_by=b_by)
        r = rep[name]
        _say("kernels", f"hamming_top2 batched {name} ({s} x {r['m']} x "
                        f"{r['k']}, {r['candidates']} candidate pairs): "
                        f"bit-exact vs the per-stream plain loop, one launch "
                        f"{r['ms']:.4f} ms (bound {b_ms:.4f} ms, {b_by}), "
                        f"{s} single launches {r['singles_ms']:.4f} ms, "
                        f"plain {r['plain_ms']:.4f} ms")
    return rep


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

    # ---- T at its sites (the row match alone and the dual row launch)
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
    per_frame = {path: {key: sum(t_sites[s][key] for s in T_SITES[path])
                        for key in ("ms", "plain_ms", "bound_ms")}
                 for path in ("path1", "path2")}
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


def _run_modes(path, make, drive, n_units, unit_frames):
    """A path twice on the same frames: the system ``make()`` returns,
    replaying the graph of its step (the main path), and a second one run
    eagerly under ``disable_graphs()``, unit by unit in turns
    (``drive(system, u)`` tracks unit u, ``unit_frames`` frames, and
    returns their poses and metrics). Unit 0 warms up (the graphs are
    captured there), unit 1 counts host syncs under
    ``torch.cuda.set_sync_debug_mode("warn")``, units 2.. are timed; the
    mode that goes first alternates from unit to unit. Every launch count
    and the collectives' count are set to 0 just before; each mode's are
    what its own wrapper calls added (the graph's: its warm-up and
    captured steps; a replay calls no wrapper). Returns per mode the poses
    and metrics (concatenated over frames), launches, collectives, syncs,
    each timed unit's seconds (to its end on the device) and the system;
    the graph's host seconds per timed unit until the call returned, its
    number of graphs and capture seconds per graph, and the peak device
    memory of the path."""
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.ops.collectives import all_reduce
    from lvt_tpu_torch.parallel.dryrun import count_syncs, zero_kernel_counters
    from lvt_tpu_torch.tree import tree_map

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_kernel_counters()
    all_reduce.calls = 0
    run = {m: dict(system=make(), out=[], times=[], collectives=0,
                   launches=dict.fromkeys(counters, 0)) for m in MODES}
    host = []
    for u in range(n_units):
        for mode in (MODES if u % 2 == 0 else MODES[::-1]):
            r = run[mode]
            before = {k: fn.launches for k, fn in counters.items()}
            calls = all_reduce.calls
            with disable_graphs() if mode == "eager" else nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if u == 1:
                    out, r["syncs"] = count_syncs(
                        lambda: drive(r["system"], u))
                else:
                    out = drive(r["system"], u)
                t_host = time.perf_counter() - t0
                torch.cuda.synchronize()
                t_all = time.perf_counter() - t0
            for k, fn in counters.items():
                r["launches"][k] += fn.launches - before[k]
            r["collectives"] += all_reduce.calls - calls
            r["out"].append(out)
            if u >= 2:
                r["times"].append(t_all)
                if mode == "graph":
                    host.append(t_host)
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    for r in run.values():
        r["poses"], r["metrics"] = (tree_map(cat, *x) for x in zip(*r["out"]))
        del r["out"]
    runners = list(run["graph"]["system"].runners.values())
    modes = sorted({x.mode for x in runners})
    if modes != ["graph"]:
        raise AssertionError(f"{path}: the main path ran {modes}, not the "
                             f"graph")
    return dict(run, unit_frames=unit_frames, units=n_units, host=host,
                graphs=len(runners),
                capture_s=[x.capture_seconds for x in runners],
                memory=torch.cuda.max_memory_allocated())


def _same_modes(path, run) -> None:
    """Graph against eager: poses (t, q) and every metrics leaf bit-equal.
    A gap is printed; a pose gap under 1e-5 m with equal statuses and BA
    runs is tolerated (and named in ROADMAP Queue 3), 1e-5 m or more
    fails."""
    g, e = run["graph"], run["eager"]
    names = ([f"pose.{k}" for k in g["poses"]._fields]
             + [f"metrics.{k}" for k in g["metrics"]._fields])
    differ = [name for name, a, b in zip(names, [*g["poses"], *g["metrics"]],
                                         [*e["poses"], *e["metrics"]])
              if not torch.equal(a, b)]
    n = g["poses"].t.shape[0]
    if not differ:
        _say(path, f"graph = eager bit for bit over {n} frames: poses (t, "
                   f"q), statuses, every metrics leaf, local_ba_ran")
        return
    gap = float((g["poses"].t - e["poses"].t).abs().max())
    _say(path, f"graph vs eager over {n} frames: {differ} differ; largest "
               f"pose gap {gap:.3g} m")
    if not gap < 1e-5 or {"metrics.status", "metrics.local_ba_ran"} & set(
            differ):
        raise AssertionError(f"{path}: the graph differs from the eager "
                             f"step ({differ}, pose gap {gap} m)")


def _spread(xs) -> str:
    return (f"median {np.median(xs):.2f}, min {min(xs):.2f}, max "
            f"{max(xs):.2f} over {len(xs)}")


def _report_modes(path, run, per=1) -> dict:
    """Frames/s of both modes over the timed units (``per`` streams per
    frame), host ms per frame of the replay loop, capture seconds, peak
    memory, syncs; returns the summary."""
    n = run["unit_frames"]
    fps = {m: [per * n / t for t in run[m]["times"]] for m in MODES}
    host_ms = [1e3 * t / n for t in run["host"]]
    for m in MODES:
        _say(path, f"{m}: frames/s {_spread(fps[m])} timed units of {n} "
                   f"frames{f' x {per} streams' if per > 1 else ''} "
                   f"(graph and eager in turns); host syncs in unit 1: "
                   f"{run[m]['syncs']}")
    _say(path, f"graph: host ms per frame of the replay loop (until "
               f"track returned) {_spread(host_ms)}; capture (warm-up + "
               f"capture + instantiation) "
               f"{[round(x, 3) for x in run['capture_s']]} s per graph; "
               f"peak device memory {run['memory'] / 2**20:.1f} MiB")
    for m in MODES:
        if run[m]["syncs"] != 0:
            raise AssertionError(f"{path}: {run[m]['syncs']} host syncs in "
                                 f"one {m} unit")
    return dict(fps=float(np.median(fps["graph"])),
                fps_eager=float(np.median(fps["eager"])),
                fps_spread={m: [min(fps[m]), max(fps[m])] for m in MODES},
                host_ms=float(np.median(host_ms)),
                capture_s=run["capture_s"], memory=run["memory"],
                syncs=run["graph"]["syncs"])


def _check_launches(path, launches, n_frames, ba_frames=None,
                    chunks=0) -> None:
    """Each kernel launched exactly NEED_PER_FRAME times per frame and
    NEED_PER_CHUNK times per chunk (and the path's other kernels never); on
    BA_KERNEL_PATHS local BA's kernel ``ba_frames`` times (None: once per
    frame, as an eager step, a graph's warm-up and its capture compute BA
    on every frame), on SHARDED_PATHS its phases BA_PHASES times as
    often."""
    need = {k: NEED_PER_FRAME[path].get(k, 0) * n_frames
            + NEED_PER_CHUNK.get(k, 0) * chunks for k in KERNELS}
    if path in BA_KERNEL_PATHS:
        need["ba_refine"] = n_frames if ba_frames is None else ba_frames
    if path in SHARDED_PATHS:
        need["ba_phase"] = BA_PHASES * (n_frames if ba_frames is None
                                        else ba_frames)
    bad = {k: (launches.get(k, 0), v) for k, v in need.items()
           if launches.get(k, 0) != v}
    if bad:
        raise AssertionError(f"{path}: kernels launched other than exactly "
                             f"(got, need): {bad}")


def _check_wrapper_counts(path, run, n_frames) -> None:
    """The wrappers' counts in each mode of ``_run_modes``: the eager
    step's launches, NEED_PER_FRAME per frame; the graph's calls, made at
    each graph's warm-up and capture (a replay calls none), NEED_PER_FRAME
    twice per graph; in both modes NEED_PER_CHUNK per chunk (its start)."""
    g, e = run["graph"]["launches"], run["eager"]["launches"]
    chunks = run["units"] * CHUNKS_PER_UNIT.get(path, 1)
    _say(path, f"wrapper counts: eager {e} over {n_frames} frames; graph "
               f"{g}, the calls of the warm-up and the captured step of "
               f"{run['graphs']} graph(s); {chunks} chunks each")
    _check_launches(path, e, n_frames, chunks=chunks)
    _check_launches(path, g, 2 * run["graphs"], chunks=chunks)


def _same_features(name, got, want) -> None:
    """Features on the card (``got``) against the CPU's: ``valid`` equal,
    and kp, desc and depth equal where valid."""
    got = type(got)(*(x.cpu() for x in got))
    if not torch.equal(got.valid, want.valid):
        raise AssertionError(f"{name}: valid differs card vs CPU")
    v = want.valid
    for field in ("kp", "desc", "depth"):
        if not torch.equal(getattr(got, field)[v], getattr(want, field)[v]):
            raise AssertionError(f"{name}: {field} differs card vs CPU")


def check_path_kernels(path, config, imgs, extract, sites) -> dict:
    """Kernels A, P and T against their plain versions on the card, bit for
    bit, at the shapes one frame of ``path`` gives them: A and P on the
    frame's extraction batch ``imgs`` [B, H, W] (P at the corners selected
    on it), T in one launch for all streams at each of ``sites``
    (``t_site_inputs``); then ``extract(device)``, the path's extraction
    of that frame, on the card against the CPU (``_same_features``).
    Returns each kernel's largest error at these shapes."""
    from lvt_tpu_torch.ops import patches as pt
    from lvt_tpu_torch.ops import perception, top2

    args = p_inputs(config, imgs)
    err = {
        "perception": _require_equal(
            f"{path}: perception", perception.perception_patch_maps_batched(
                imgs), perception.perception_plain(imgs)),
        "describe_refine": _require_equal(
            f"{path}: describe_refine", pt.describe_refine_batched(*args),
            pt.describe_refine_plain(*args)),
        "hamming_top2": max(
            _require_equal(f"{path}: hamming_top2 at {site}",
                           top2.hamming_top2_batched(*a, **kw),
                           top2.hamming_top2_plain_batched(*a, **kw))
            for site, (a, kw) in sites.items()),
    }
    feats = extract("cpu")
    _same_features(f"{path} frame 0", extract(DEVICE), feats)
    t_shapes = ", ".join(f"{s} {a[0].shape[0]} x {a[0].shape[1]} x "
                         f"{a[1].shape[1]}" for s, (a, _) in sites.items())
    _say(path, f"kernels at this path's shapes, bit-exact vs plain: A on "
               f"{tuple(imgs.shape)} {str(imgs.dtype)[6:]}, P on "
               f"{tuple(args[6].shape)} slots ({int(args[6].sum())} "
               f"selected), T in one launch per site (streams x queries x "
               f"targets: {t_shapes}); frame 0's features card vs CPU "
               f"bit-equal ({int(feats.valid.sum())} valid)")
    return err


def _chunks_of(a, b, chunk):
    """``drive`` for ``_run_modes``: unit u is ``track_chunk`` of frames
    u * chunk .. (u + 1) * chunk - 1 of ``a`` and ``b``."""
    return lambda vo, u: vo.track_chunk(a[u * chunk:(u + 1) * chunk],
                                        b[u * chunk:(u + 1) * chunk])


def phase_path(path, config, il, ir, gt, profile_dir=None):
    """One path: VOSystem.track_chunk on the card, graph and eager."""
    from lvt_tpu_torch.core.system import TrackingState, VOSystem
    from lvt_tpu_torch.io.synthetic import ate_rmse

    chunk, n_units = RUNS[path]
    n = chunk * n_units
    drive = _chunks_of(il, ir, chunk)
    run = _run_modes(path, lambda: VOSystem(config, device=DEVICE), drive,
                     n_units, chunk)
    vo, g = run["graph"]["system"], run["graph"]
    n_ba = int(g["metrics"].local_ba_ran.sum())
    window, every = config.local_ba_window, config.local_ba_every
    # every frame tracks; BA runs once the window is full, on its schedule
    want_ba = (sum(f >= window and f % every == 0 for f in range(n))
               if window > 0 else 0)

    status = vo.get_state()
    est = g["poses"].t.cpu().numpy()
    err = ate_rmse(est, gt[:n])
    dist = float(np.linalg.norm(gt[n - 1] - gt[0]))
    _say(path, f"{n} frames {il.shape[1]}x{il.shape[2]} uint8 in chunks of "
               f"{chunk}, descriptor mode {config.descriptor_mode or 'patch'}, "
               f"BA window {window}: status {status.name}, map {vo.map_size} "
               f"points")
    report = _report_modes(path, run)
    _same_modes(path, run)
    _say(path, f"ATE RMSE {err:.4f} m over {dist:.2f} m "
               f"({100 * err / dist:.3f}%)")
    _say(path, f"frames that ran local BA: {n_ba} (schedule: {want_ba})")
    if status != TrackingState.TRACKING:
        raise AssertionError(f"{path}: final status {status.name}, not TRACKING")
    if not err < 0.05 * dist:
        raise AssertionError(
            f"{path}: ATE {err:.4f} m is not under 5% of {dist:.2f} m")
    if n_ba != want_ba:
        raise AssertionError(f"{path}: {n_ba} frames ran BA, the schedule "
                             f"says {want_ba}")
    _check_wrapper_counts(path, run, n)

    prof = _profiles(path, run, drive, profile_dir, config=config)
    if path == "path1":
        prof.update(_inside_the_graph(path, vo, drive, n_units - 1, chunk))
    prof["host_launches"] = host_between_replays(
        path, lambda: drive(vo, n_units - 1), 1, chunk)
    if window > 0:
        prof["frame_types"] = _frame_types(
            path, config, lambda: VOSystem(config, device=DEVICE), il, ir,
            eager=True)
    from lvt_tpu_torch.tree import tree_map

    first = tree_map(lambda x: x[:N_CPU_FRAMES[path]], g["poses"])
    captured = capture_pnp_inputs(path, _first_frames(
        lambda: VOSystem(config, device=DEVICE), il, ir))
    pnp_gaps = check_pnp_solve(path, captured)
    return dict(report, first_poses=first, profile=prof,
                launches=prof["launches"], if_node_launches=prof["if_node"],
                kernel_errs={"pnp_solve": pnp_gaps["max_abs_err"]},
                poses=g["poses"], track_inputs=captured["track"])


def _inside_the_graph(path, vo, drive, u, n) -> dict:
    """Where a graphed frame's time goes: unit ``u`` (``n`` frames) tracked
    once more with a CUDA event before and after each graph replay, so the
    device time inside the replays and the unit's time end to end come
    from the same run; the rest of a frame is spent outside the graph
    (copies in and out, the gaps between replays, the host)."""
    (runner,) = vo.runners.values()
    graph, spans = runner._graph, []

    class Timed:
        def replay(self):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            graph.replay()
            ev[1].record()
            spans.append(ev)

    runner._graph = Timed()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive(vo, u)
        torch.cuda.synchronize()
        frame_ms = 1e3 * (time.perf_counter() - t0) / n
    finally:
        runner._graph = graph
    inside = sum(a.elapsed_time(b) for a, b in spans) / n
    _say(path, f"a graphed frame ({n} frames of unit {u} again): "
               f"{frame_ms:.3f} ms end to end, {inside:.3f} ms of it inside "
               f"the graph's replay, {100 * (1 - inside / frame_ms):.1f}% "
               f"outside it")
    return dict(frame_ms=frame_ms, inside_ms=inside)


# the runtime API calls that launch work on the card from the host, by
# their names' starts, as a trace of the host's activity records them: a
# graph's replay, and kernels, copies and fills
GRAPH_LAUNCH = "cudaGraphLaunch"
HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                 "cudaMemset", "cuMemset", "cudaMemPrefetch")


def _host_launches(prof) -> list[str]:
    """Each runtime-API call of a ``dryrun.traced`` trace (host=True) that
    launched work on the card, in order, named by what it ran there (the
    card's record of the same correlation id): ``replay`` (a graph's
    launch), ``start`` (``copy_leaves_kernel``, a chunk's start), ``HtoD``,
    ``DtoH``, ``DtoD`` (copies), ``Memset``, ``port <kernel>`` (another of
    the port's kernels) or ``aten <kernel>``; the trace's TRACE_MARKERS
    opening spin kernels left out."""
    from torch.autograd import DeviceType

    from lvt_tpu_torch.parallel.dryrun import KERNEL_SYMBOLS, TRACE_MARKERS

    events = list(prof.profiler.kineto_results.events())
    ran = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ran.setdefault(e.correlation_id(), e.name())
    calls = sorted((e.start_ns(), e.name(), ran.get(e.correlation_id(), ""))
                   for e in events if e.device_type() == DeviceType.CPU
                   and e.name().startswith((GRAPH_LAUNCH, *HOST_LAUNCHES)))
    out = []
    for _, api, what in calls[TRACE_MARKERS:]:
        if api.startswith(GRAPH_LAUNCH):
            out.append("replay")
        elif "copy_leaves_kernel" in what:
            out.append("start")
        elif what.startswith(("Memcpy", "Memset")):
            out.append(what.split()[1] if what.startswith("Memcpy")
                       else "Memset")
        elif any(sym in what for sym in KERNEL_SYMBOLS.values()):
            out.append(f"port {what}")
        else:
            out.append(f"aten {what or api}")
    return out


def host_between_replays(path, fn, chunks, frames, uploads=0,
                         caller_kernels=0) -> dict:
    """What the host launched while ``fn()`` tracked ``chunks`` chunks of
    ``frames`` frames, graphed, its runner's graph already captured (paths
    1-5: a unit of one chunk; path 6: calls of one frame, a chunk each;
    path 7: StreamingVO's worker thread, a frame a chunk): the runtime-API
    records of a trace of the host's and the card's activity, each named
    by what it ran on the card (``_host_launches``). The reads of results
    (``DtoH``) and ``caller_kernels`` ATen kernels a chunk (path 7's
    shell reading a pose) are the caller's; the rest must be exactly, per
    chunk, ``uploads`` host-to-device copies (the caller's inputs: path
    6's corners, path 7's two images), the chunk's start (one
    ``copy_leaves_kernel``: NEED_PER_CHUNK), then one replay a frame with
    nothing between: no device-to-device copy, fill or other kernel from
    the host."""
    from lvt_tpu_torch.parallel.dryrun import traced

    _, prof = traced(fn, host=True)
    got = _host_launches(prof)
    reads = got.count("DtoH")
    aten = [k for k in got if k.startswith("aten ")]
    rest = [k for k in got if k != "DtoH" and not k.startswith("aten ")]
    want = (["HtoD"] * uploads + ["start"] * sum(NEED_PER_CHUNK.values())
            + ["replay"] * frames) * chunks
    runs, last = [], None
    for k in rest:      # run-length form, for the report
        if k == last:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
        last = k
    _say(path, f"host launches around {chunks} graphed chunk(s) of {frames} "
               f"frame(s) (the trace's runtime-API records, by what they ran "
               f"on the card): "
               + ", ".join(f"{k} x{n}" for k, n in runs)
               + f"; the caller's reads {reads}, ATen kernels {len(aten)} "
               f"{sorted(set(aten))}")
    if rest != want or len(aten) != caller_kernels * chunks:
        raise AssertionError(
            f"{path}: the host launched {runs} and {len(aten)} ATen kernels "
            f"around the replays, not per chunk {uploads} uploads, the "
            f"chunk's start and {frames} replays with nothing between, and "
            f"{caller_kernels} of the caller's kernels")
    return dict(chunks=chunks, frames=frames, uploads=uploads * chunks,
                starts=chunks, between=0, reads=reads,
                caller_kernels=len(aten))


def _relative_gt(rot, pos, start, n):
    """Ground-truth positions of frames start .. start + n - 1 in the
    camera frame of the first (a stream's VO starts there, at identity)."""
    return (pos[start:start + n] - pos[start]) @ rot[start]


def phase_multistream(config, il, ir, rot, pos, profile_dir=None):
    """Path 3: MultiStreamVO.track_chunk with MS_STREAMS streams on the
    card; then kernels A, P and T against their plain versions at the
    shapes of its frame 0 (``check_path_kernels``), and streams 0 and 1
    against the card's single-stream VOSystem over the same frames."""
    from lvt_tpu_torch.core.extract import extract_features_batched
    from lvt_tpu_torch.core.state import TRACKING
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import ate_rmse
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    chunk, n_units = RUNS["path3"]
    s, n = MS_STREAMS, chunk * n_units
    starts = [MS_START_STEP * i for i in range(s)]
    a = torch.stack([il[k:k + n] for k in starts], 1)     # [N, S, H, W]
    b = torch.stack([ir[k:k + n] for k in starts], 1)
    drive = _chunks_of(a, b, chunk)
    run = _run_modes("path3", lambda: MultiStreamVO(config, s, device=DEVICE),
                     drive, n_units, chunk)
    msvo, g = run["graph"]["system"], run["graph"]
    status = msvo.status
    est = g["poses"].t.cpu().numpy()
    errs = []
    for i, k in enumerate(starts):
        gt = _relative_gt(rot, pos, k, n)
        errs.append((ate_rmse(est[:, i], gt), float(np.linalg.norm(gt[-1]))))
    _say("path3", f"{s} streams x {n} frames {il.shape[1]}x{il.shape[2]} "
                  f"uint8 in chunks of {chunk} (stream i from frame "
                  f"{MS_START_STEP} i): statuses {status.tolist()}")
    report = _report_modes("path3", run, per=s)
    _same_modes("path3", run)
    _say("path3", "ATE per stream: " + ", ".join(
        f"{100 * e / d:.3f}%" for e, d in errs))
    if not (status == TRACKING).all():
        raise AssertionError(f"path3: statuses {status.tolist()}, not all "
                             f"TRACKING")
    bad = [i for i, (e, d) in enumerate(errs) if not e < 0.05 * d]
    if bad:
        raise AssertionError(f"path3: ATE of streams {bad} not under 5% "
                             f"of their distance: {errs}")
    _check_wrapper_counts("path3", run, n)

    # frame 0's extraction batch (all 2S images) and T at the path's
    # three sites with every stream's frames 0 and 1
    imgs = torch.cat([a[0], b[0]])
    f0 = extract_features_batched(imgs, config)
    f1 = extract_features_batched(a[1], config)
    sites = t_site_inputs(config, _streams(f0, slice(0, s)), f1,
                          _streams(f0, slice(s, 2 * s)))
    kernel_errs = check_path_kernels(
        "path3", config, imgs,
        lambda dev: extract_features_batched(imgs.to(dev), config),
        {k: sites[k] for k in T_SITES["path3"]})

    gaps, equal = [], []
    for i in (0, 1):
        vo = VOSystem(config, device=DEVICE)
        p, _ = vo.track_chunk(il[starts[i]:starts[i] + n],
                              ir[starts[i]:starts[i] + n])
        gaps.append((p.t - g["poses"].t[:, i]).abs().amax(-1).cummax(0)
                    .values[chunk - 1::chunk].tolist())
        equal.append(torch.equal(p.t, g["poses"].t[:, i])
                     and torch.equal(p.q, g["poses"].q[:, i]))
    _say("path3", f"streams 0 and 1 against the card's single-stream "
                  f"VOSystem over {n} frames: poses "
                  f"{'EQUAL' if all(equal) else 'differ'} ({equal}); "
                  f"largest gap (m) over frames 0-7, 0-15, ... "
                  f"0-{n - 1}: {gaps[0]} and {gaps[1]}")
    gaps = [g[-1] for g in gaps]
    if not max(gaps) < 1e-3:
        raise AssertionError(f"path3: multi-stream vs single-stream gaps "
                             f"{gaps} m, not under 1e-3 m")
    if not max(gaps) < 1e-5:
        raise AssertionError(f"path3: multi-stream vs single-stream gaps "
                             f"{gaps} m, not under 1e-5 m")
    prof = _profiles("path3", run, drive, profile_dir, "multi-stream frame")
    prof["host_launches"] = host_between_replays(
        "path3", lambda: drive(run["graph"]["system"], n_units - 1), 1,
        chunk)
    pnp_inputs = capture_pnp_inputs("path3", _first_frames(
        lambda: MultiStreamVO(config, s, device=DEVICE), a, b, 4))
    return dict(report, fps_per_stream=report["fps"] / s, profile=prof,
                launches=prof["launches"], kernel_errs=kernel_errs,
                gaps=gaps, equal=all(equal),
                pnp_inputs=pnp_inputs,
                first_poses=g["poses"].t[:MS_CPU[1], :MS_CPU[0]],
                poses=tuple(x[:MD_FRAMES].cpu().numpy() for x in g["poses"]),
                inputs=(a[:MS_CPU[1], :MS_CPU[0]], b[:MS_CPU[1], :MS_CPU[0]]))


def _first_frames(make, a, b, n=MS_STREAMS + 1):
    """``frames`` for capture_pnp_inputs: a new system ``make()`` tracking
    the first ``n`` frames of ``a`` and ``b`` (a MultiStreamVO's frames
    [S, H, W]) with ``track``; returns n. Frame 0 initialises the map,
    the others are tracked as the path tracks them."""
    def frames():
        system = make()
        for x, y in zip(a[:n], b[:n]):
            system.track(x, y)
        return n
    return frames


def capture_pnp_inputs(path, frames) -> dict:
    """The inputs that the fused PnP solve (``lvt_tpu_torch::pnp_solve``)
    launched with while ``frames()`` tracked a path's first frames
    eagerly (``disable_graphs``: a replay calls no Python, so nothing
    would be recorded), the last MS_STREAMS streams of them: ``args`` (t,
    q, points, obs, weights) with a leading stream axis and ``cam`` (fx,
    fy, cx, cy, reprojection_th2). A MultiStreamVO's vmapped call reaches
    the op's batching rule, which launches once on the streams' real
    tensors (the last frame's is kept); a VOSystem launches at S = 1, and
    its last MS_STREAMS frames are stacked as streams, so that the kernel
    is also checked at S = 8 at this path's M."""
    from lvt_tpu_torch.core import tail, track
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.ops import detect, matching, top2
    from lvt_tpu_torch.solver import pnp

    # the step's tail launches from tail._launch, through the op or (one
    # stream outside vmap) straight from tail.step_tail
    ops = ([(pnp, "pnp_solve", "pnp_solve_op")]
           + [(track, k, f"{k}_op") for k in (*TRACK_KERNELS, "ba_observe")]
           + [(detect, "select_corners", "select_corners_op"),
              (matching, "map_accept", "map_accept_op"),
              (tail, "step_tail", "_launch"),
              (top2, T_ROW, "hamming_top2_op")])
    seen = {name: [] for _, name, _ in ops}
    real = {name: getattr(mod, attr) for mod, name, attr in ops}

    def recorder(name):
        def record(*args):
            flat = _tail_launch_flat(*args) if name == "step_tail" else args
            if name == T_ROW and args[-1] not in top2.ROW_MODES:
                pass    # kernel T at a radius site
            elif not torch._C._functorch.is_batchedtensor(flat[0]):
                seen[name].append(tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in flat))
            return real[name](*args)
        return record

    for mod, name, attr in ops:
        setattr(mod, attr, recorder(name))
    try:
        with disable_graphs():
            n = frames()
    finally:
        for mod, name, attr in ops:
            setattr(mod, attr, real[name])
    solves = seen.pop("pnp_solve")
    if len(solves) != n:
        raise AssertionError(f"{path}: {len(solves)} launches of pnp_solve "
                             f"in {n} frames, not one per frame")
    args = tuple(torch.cat(x)[-MS_STREAMS:]
                 for x in zip(*(c[:5] for c in solves[-MS_STREAMS:])))
    # the step's ops: one launch per frame each (none on a path without
    # staged points for staged_promote, none of select_corners at external
    # corners, ba_observe on the BA paths, kernel T's row launch where a
    # right camera is), the last MS_STREAMS streams (images for
    # select_corners) held against their plain versions at once
    tracked = {}
    for name, calls in seen.items():
        need = NEED_PER_FRAME.get(path)   # path 8's reference: every op
        on = (path not in RGBD_PATHS if name == T_ROW
              else need is None or need.get(name))
        want = n if on else 0
        if len(calls) != want:
            raise AssertionError(f"{path}: {len(calls)} launches of {name} "
                                 f"in {n} frames, not {want}")
        if calls:
            tracked[name] = _last_streams(calls)
    _track_errs(path, check_track_kernels(path, tracked))
    return dict(args=args, cam=solves[0][5:], track=tracked)


def _solve_outputs(res) -> tuple:
    """A PnPResult as pnp_solve's outputs (t, q, inlier, count, chi2)."""
    return (*res.pose, *res[1:])


def _plain_solves(args, cam) -> tuple:
    """The plain version (``solve_pnp_plain``) stream by stream on the
    card, stacked as pnp_solve's outputs."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import pnp

    fx, fy, cx, cy, th2 = cam
    outs = [_solve_outputs(pnp.solve_pnp_plain(
        Pose(t, q), p, o, w, fx=fx, fy=fy, cx=cx, cy=cy,
        reprojection_th2=th2)) for t, q, p, o, w in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


def _phase_solves(args, cam) -> tuple:
    """The sharded solve's phases on one rank (every all-reduce the
    identity), vmapped over the streams: N_PHASES launches."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import pnp

    kw = dict(zip(("fx", "fy", "cx", "cy", "reprojection_th2"), cam))
    return torch.func.vmap(lambda t, q, *a: _solve_outputs(
        pnp.solve_pnp_phases(Pose(t, q), *a, **kw)))(*args)


def _graphed(fn):
    """``fn`` (called once eagerly first) captured in a CUDA graph: its
    replay, as the main path ran the plain version before the fused
    kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _rotation_gap(q1, q2) -> torch.Tensor:
    """Rotation angle between quaternions [S, 4], in float64."""
    from lvt_tpu_torch.geometry import quaternion as quat

    rel = quat.multiply(quat.normalize(q1.double()),
                        quat.conjugate(quat.normalize(q2.double())))
    return 2 * torch.atan2(rel[:, 1:].norm(dim=-1), rel[:, 0].abs())


# the valid points that stream i keeps in check_pnp_solve's few-inlier
# set: underdetermined to well posed, the LM accept tests near ties
FEW_INLIERS = (3, 4, 5, 6, 8, 16, 32, 70)


def few_inliers(args) -> tuple:
    """``args`` (a path's captured solve inputs) with stream i's weights
    cut to its first FEW_INLIERS[i] valid points."""
    w = args[4]
    k = torch.tensor(FEW_INLIERS[:w.shape[0]], device=w.device)[:, None]
    keep = (w > 0) & (torch.cumsum((w > 0).int(), -1) <= k)
    return (*args[:4], w * keep)


def check_pnp_solve(path, inputs) -> dict:
    """The fused solve against its plain version on the card, on a path's
    captured inputs (``capture_pnp_inputs``) and on the same inputs with
    few valid points (``few_inliers``), all S streams in one launch: every
    output (pose, inlier mask and count, chi2) bit-equal to the plain
    version's, stream by stream (the gaps printed: pose in m, rotation in
    rad, chi2 relative to max(plain chi2, reprojection_th2)); each stream
    bit-equal to its own S = 1 launch; and the sharded solve's phases on
    one rank bit-equal to the fused kernel. Returns the largest gaps."""
    from lvt_tpu_torch.solver import pnp

    cam = inputs["cam"]
    fmt = lambda x: [float(f"{v:.3g}") for v in x.tolist()]  # noqa: E731
    gaps = {}
    for label, args in (("captured", inputs["args"]),
                        ("few inliers", few_inliers(inputs["args"]))):
        s, m = args[2].shape[:2]
        got = pnp.pnp_solve_op(*args, *cam)
        want = _plain_solves(args, cam)
        phases = _phase_solves(args, cam)
        torch.cuda.synchronize()
        dt = (got[0] - want[0]).double().norm(dim=-1)
        da = _rotation_gap(got[1], want[1])
        rel = ((got[4] - want[4]).double().abs()
               / want[4].double().abs().clamp(min=cam[4]))
        counts = (got[3].tolist(), want[3].tolist())
        alone = all(torch.equal(a[0], b[i]) for i in range(s)
                    for a, b in zip(pnp.pnp_solve_op(
                        *(x[i:i + 1] for x in args), *cam), got))
        same = all(torch.equal(a, b) for a, b in zip(phases, got))
        plain = all(torch.equal(a, b) for a, b in zip(got, want))
        _say(path, f"pnp_solve S={s} x M={m} ({label}: valid points "
                   f"{(args[4] > 0).sum(-1).tolist()}) against the plain "
                   f"version on the card, per stream: pose gap {fmt(dt)} m, "
                   f"rotation {fmt(da)} rad, chi2 {fmt(rel)} of max(plain "
                   f"chi2 {fmt(want[4])}, {cam[4]:.4g}); inlier counts "
                   f"{counts[0]} (plain {counts[1]}); "
                   f"{'bit-equal' if plain else 'NOT equal'} to the plain "
                   f"version; every stream "
                   f"{'bit-equal' if alone else 'NOT equal'} to its S=1 "
                   f"launch; the phases on one rank "
                   f"{'bit-equal' if same else 'NOT equal'} to the fused "
                   f"kernel")
        if not plain:
            raise AssertionError(f"{path}: pnp_solve differs from its plain "
                                 f"version ({label}): pose {dt.max()} m, "
                                 f"rotation {da.max()} rad, chi2 "
                                 f"{rel.max()}, counts {counts}")
        if not alone:
            raise AssertionError(f"{path}: a stream of the S={s} pnp_solve "
                                 f"launch ({label}) differs from its S=1 "
                                 f"launch")
        if not same:
            raise AssertionError(f"{path}: the phases differ from the fused "
                                 f"pnp_solve on one rank ({label})")
        for key, v in (("pose_m", dt.max()), ("rotation_rad", da.max()),
                       ("chi2_rel", rel.max()),
                       ("max_abs_err", _max_abs_err(got, want))):
            gaps[key] = max(float(v), gaps.get(key, 0.0))
        gaps.update(s=s, m=m)
    return gaps


def pnp_solve_work(s: int, m: int) -> tuple[int, dict]:
    """Bytes and operations of S fused solves of M points (see
    PNP_FP32_PER_POINT)."""
    return (s * (m * 25 + 28 + 40),
            {"fp32": s * m * PNP_FP32_PER_POINT,
             "fp64_tensor": s * m * PNP_FP64_PER_POINT})


def measure_pnp_solve(card, path, inputs) -> dict:
    """``check_pnp_solve``, then at S = 1 (stream 0) and S = 8: the fused
    kernel's device time beside its bound; the plain version's, captured
    in a CUDA graph and replayed (how the main path ran it before the
    fused kernel);
    and the phases' (N_PHASES launches and their glue, one rank, graphed
    too). No one PyTorch call runs an LM solve: no library time."""
    from lvt_tpu_torch.solver import pnp

    gaps = check_pnp_solve(path, inputs)
    cam, rep = inputs["cam"], {}
    n_streams = inputs["args"][0].shape[0]
    for s in (1, n_streams):
        args = tuple(x[:s].contiguous() for x in inputs["args"])
        m = args[2].shape[1]
        b_ms, b_by = bound(card, *pnp_solve_work(s, m))
        rep[s] = dict(
            s=s, m=m, ms=device_ms(lambda a=args: pnp.pnp_solve_op(*a, *cam),
                                   REPS),
            plain_ms=device_ms(_graphed(lambda a=args: _plain_solves(a, cam)),
                               PLAIN_REPS),
            phases_ms=device_ms(_graphed(lambda a=args: _phase_solves(a, cam)),
                                PLAIN_REPS),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        q = rep[s]
        _say(path, f"pnp_solve S={s} x M={m}: kernel {q['ms']:.4f} ms "
                   f"(bound {b_ms:.3g} ms, {b_by}), the plain version "
                   f"graphed {q['plain_ms']:.4f} ms, the phases on one rank "
                   f"({pnp.N_PHASES} launches) {q['phases_ms']:.4f} ms")
    return dict(rep[1], batched=rep[n_streams], **gaps,
                **card["pnp_geometry"])


# the largest gap of each of the tracking branch's kernels to its plain
# version on each path's inputs ({kernel: {path: gap}}), from
# check_track_kernels at every capture_pnp_inputs
TRACK_ERRS = {k: {} for k in (*STEP_OPS, "copy_leaves")}
# the work per item that each of the tracking branch's functions needs,
# besides its bytes (every output written once, each input read once):
# predict_project per map point, the camera point (9 multiplies, 9 adds),
# the projection (a division, 4 multiplies, 2 adds) and 6 compares, 31
# float32; upkeep_pre per staged point the same 31, per map point 6 ALU
# (the counters and the cull); staged_promote per staged point 12 ALU (the
# acceptance, the key and its atomicMin, the counters) and per map slot 4
# (the free slots' ranks); triangulate_insert per feature, stereo: the
# normal equations' 36 products and 27 sums and the adjugate chain's 9 and
# 6 in float64 (87), the rest in float32 (the normalised coordinates 8,
# the adjugate 27, the determinant and 1 / det 6, the two projections and
# gates 28, the world point 15: 84), and per map or staged slot 4 ALU. The
# pose algebra once per stream is left out (under 200 operations).
TRACK_WORK = {"predict_project": ("map", {"fp32": 31}),
              "upkeep_pre": ("staged", {"fp32": 31}),
              "staged_promote": ("staged", {"alu": 12}),
              "triangulate_insert": ("features", {"fp32": 84, "fp64": 87})}


# the work per item of the selection and the acceptance, besides their
# bytes: select_corners per pixel of the cell grid, its key (the fold of
# -0.0, the order map's compare and xor, the packing with the reversed
# index: 6 ALU) and one comparison with the selection's threshold key (1),
# and with the dither two 8-bit reversals, a multiply-add and a shift (6
# ALU) and the f32 add; map_accept per query, at each radius the
# acceptance (3), the key (2), its atomicMin (1) and the winner's test
# (2), then the selects and the outputs (8): 24 ALU
# step_tail per matched map slot of a stream not lost: the five sums'
# adds (the selects and the counts are data movement and integer work
# under its bytes)
TAIL_FP32_PER_SLOT = 5
# ba_observe per query (a left feature) the acceptance (3), the key (2),
# its atomicMin (1) and the winner's test (2); per map slot its liveness
# from five masks (6), the clamps and the right index's test (6); per slot
# and window row the weights' two products with the liveness (float32)
BA_OBSERVE_ALU_PER_QUERY = 8
BA_OBSERVE_ALU_PER_SLOT = 12
SELECT_KEY_ALU = 7
SELECT_ACCEPT_WORK = {"select_corners": (SELECT_KEY_ALU + 6, 1),
                      "map_accept": 24}


def _library_call(name, args):
    """The one PyTorch call that computes op ``name``'s core on the same
    inputs, for ``library_ms``: select_corners' selection, ``torch.topk``
    of the packed int64 keys [B, cells, cell pixels] (built once, not
    timed); None for the others (no one call computes them)."""
    from lvt_tpu_torch.ops import detect

    if name != "select_corners":
        return None
    nms, _, _, _, cell, k, _, spread, _ = args
    keys = detect.packed_keys(detect.cell_values(nms, *nms.shape[1:], cell,
                                                 spread))
    return lambda: torch.topk(keys, k, dim=-1, largest=True, sorted=True)


def _last_streams(calls) -> dict:
    """One op's captured launches: the first (frame 0, the init frame, as
    launched) and the last MS_STREAMS streams of them stacked as one
    launch's streams (a VOSystem's last frames, a MultiStreamVO's last
    frame), each as the op's arguments."""
    nt = sum(isinstance(x, torch.Tensor) for x in calls[0])
    last = [torch.cat(x)[-MS_STREAMS:]
            for x in zip(*(c[:nt] for c in calls[-MS_STREAMS:]))]
    return dict(first=list(calls[0]), last=last + list(calls[0][nt:]))


def _track_errs(path, errs) -> None:
    for k, v in errs.items():
        TRACK_ERRS[k][path] = max(v, TRACK_ERRS[k].get(path, 0.0))


def _tail_flat(args) -> tuple:
    """The tail's arguments in list form (three lists of tensors with a
    stream axis, ``tail._plain_streams``'s, and the threshold) as one flat
    tuple, as the other ops take theirs."""
    state, new, inputs, min_matches = args
    return (*state, *new, *inputs, min_matches)


def _tail_launch_flat(state, new, inp, min_matches, lead, *_) -> tuple:
    """A launch of ``tail._launch`` (inside a runner's frame or not) as
    :func:`_tail_flat`'s arguments: a stream axis of 1 where the launch
    had none (``lead`` ()), ``ba_ran`` [S, 0] where it was None."""
    ba = inp.feat_valid[..., :0] if inp.ba_ran is None else inp.ba_ran
    lists = (state, new, [*inp[:-1], ba])
    if not lead:
        lists = tuple([x[None] for x in xs] for xs in lists)
    return _tail_flat((*lists, min_matches))


def _tail_lists(flat) -> tuple:
    """:func:`_tail_flat`'s inverse."""
    from lvt_tpu_torch.core import tail

    n, k = len(tail.PATHS), len(tail.TailInputs._fields)
    return (list(flat[:n]), list(flat[n:2 * n]), list(flat[2 * n:2 * n + k]),
            flat[2 * n + k])


def _tail_op(*flat) -> list:
    """One launch of the tail's kernel (``tail._launch``, fresh outputs)
    on :func:`_tail_flat`'s arguments: the new state's leaves, the pose
    and the metrics, [S, ...] each."""
    from lvt_tpu_torch.core import tail

    state, new, inputs, min_matches = _tail_lists(flat)
    ba = inputs[-1]
    inp = tail.TailInputs(*inputs[:-1], None if ba.dim() == 2 else ba)
    return tail._launch(state, new, inp, min_matches, (state[0].shape[0],))


def _step_op(name):
    """The custom op of one of STEP_OPS, on flat arguments."""
    from lvt_tpu_torch.core import tail, track
    from lvt_tpu_torch.ops import detect, matching, top2

    if name == "step_tail":
        return _tail_op
    if name == T_ROW:
        return top2.hamming_top2_op
    mod = {"select_corners": detect, "map_accept": matching}.get(name, track)
    return getattr(mod, f"{name}_op")


def _track_plain(name, args) -> tuple:
    """The op's plain version (core/track.py's ``*_plain``, ops/detect.py's
    ``select_corners_plain``, ops/matching.py's ``map_accept_plain``,
    core/tail.py's ``step_tail_plain``: torch ops) stream by stream on the
    card: the op's CPU kernel, on CUDA tensors."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core import tail, track
    from lvt_tpu_torch.ops import detect, matching, top2

    if name == "step_tail":
        return tail._plain_streams(*_tail_lists(args))
    if name == "select_corners":
        return detect.select_corners_plain(*args)
    if name == T_ROW:
        return top2._hamming_top2_cpu(*args)
    nt = sum(isinstance(x, torch.Tensor) for x in args)
    mod = matching if name == "map_accept" else track
    return kernels.per_stream(getattr(mod, f"_{name}_flat"), nt, args)


# select_corners' corners_low_threshold (its argument 6) in
# check_track_kernels' extra runs: 0 never takes the low-corner fallback,
# the second always does
LOW_BRANCHES = (0, 1 << 30)


def _stream_slice(args, i) -> list:
    return [x[i:i + 1] if isinstance(x, torch.Tensor) else x for x in args]


def check_track_kernels(path, tracked) -> dict:
    """The step's kernels of STEP_OPS (``lvt_tpu_torch::predict_project``,
    ``upkeep_pre``, ``staged_promote``, ``triangulate_insert``,
    ``map_accept``: csrc/track.cu; ``select_corners``: csrc/select.cu)
    against their plain versions on the card, on the inputs a path's first
    frames gave them (``capture_pnp_inputs``): frame 0 as launched and the
    last MS_STREAMS streams (images, for select_corners) in one launch,
    every output bit-equal (NaN where the plain version has one), and each
    stream of the S-stream launch bit-equal to its own S = 1 launch;
    select_corners also with the low-corner fallback never and always
    taken (LOW_BRANCHES). Returns each kernel's largest gap (0.0:
    bit-equal)."""
    errs, said = {}, []
    for name, sets in tracked.items():
        op = _step_op(name)
        runs = [("frame 0", sets["first"]), ("last streams", sets["last"])]
        if name == "select_corners":   # both fallback branches
            runs += [(f"last streams, corners_low_threshold {low}",
                      [*sets["last"][:6], low, *sets["last"][7:]])
                     for low in LOW_BRANCHES]
        for label, args in runs:
            s = args[0].shape[0]
            got = op(*args)
            want = _track_plain(name, args)
            err = _require_equal_nan(f"{path}: {name} ({label}, S={s})", got,
                                     want)
            for i in range(s):
                _require_equal_nan(
                    f"{path}: {name} stream {i} of the S={s} launch against "
                    f"its S=1 launch",
                    [x[0] for x in op(*_stream_slice(args, i))],
                    [x[i] for x in got])
            errs[name] = max(err, errs.get(name, 0.0))
        said.append(f"{name} S={sets['last'][0].shape[0]}")
    if "step_tail" in tracked:
        ends = check_frame_end(path, tracked["step_tail"])
        errs["step_tail"] = max(errs["step_tail"], ends["step_tail"])
        errs["copy_leaves"] = ends["copy_leaves"]
        said.append("step_tail ending a runner's frame (the reset on and "
                    "off, swapped buffers), copy_leaves (a chunk's start, "
                    "a group's frame end, a state)")
    _say(path, f"step kernels bit-equal to their plain versions on the "
               f"card on this path's frame 0 and its last streams, each "
               f"stream equal to its S=1 launch: {', '.join(said)}")
    return errs


def _swapped(new, buffers):
    """The tracked values ``new`` with the map's counter and age taken from
    each other's buffers of ``buffers`` (sources at other addresses than
    their buffers: the kernel reads them before its barrier where it holds
    the whole state, and refuses them elsewhere)."""
    return new._replace(map=new.map._replace(counter=buffers.map.age,
                                             age=buffers.map.counter))


def _frame_end_inputs(s: int, frames: int) -> list:
    """A chunk's two inputs for checks of a frame's end: uint8 [frames, S,
    37, 41] (an odd width: 1-byte units) and float32 [frames, S, 5]."""
    g = torch.Generator(device=DEVICE).manual_seed(s)
    return [torch.randint(0, 256, (frames, s, 37, 41), generator=g,
                          device=DEVICE, dtype=torch.uint8),
            torch.randn((frames, s, 5), generator=g, device=DEVICE)]


def check_frame_end(path, sets) -> dict:
    """The end of a frame on the card, on a path's captured ``step_tail``
    launches (frame 0 as launched and the last streams):

    * ``step_tail`` inside a runner's frame (core/graphs.py::Epilogue):
      the kernel writes the new state into clones of the state's buffers,
      with the runner's reset off and on (a stream's state as the fresh
      one), and with the map's counter and age taken from each other's
      buffers; against the plain tail (torch ops), ``tail.reset_lost``
      and the copies: the buffers, row 0 of a chunk of 2 frames and frame
      1 in the input buffers bit-equal (NaN for NaN), the counter 1 (the
      swapped buffers refused, nothing written, where the state exceeds
      the units the kernel holds over its barrier: path 7 tum's);
    * ``copy_leaves``: the chunk's start (frame 0 in the input buffers),
      the frame's end after the plain tail (``Epilogue.finish``: the
      group paths', one launch) against the same as torch ops
      (``Epilogue.finish_plain``), and a new state copied whole, also
      from two swapped buffers.

    Returns each kernel's largest gap (0.0: bit-equal) or raises."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    for label in ("first", "last"):
        state_l, new_l, inputs, min_matches = _tail_lists(sets[label])
        s = state_l[0].shape[0]
        inp = tail.TailInputs(*inputs[:-1],
                              None if inputs[-1].dim() == 2 else inputs[-1])
        state = from_leaves(tail._TEMPLATE, state_l)
        fresh = from_leaves(tail._TEMPLATE, [x[-1].clone() for x in state_l])
        chunk = _frame_end_inputs(s, 2)
        for reset, swap in ((False, False), (True, False), (False, True)):
            buffers = tree_map(torch.clone, state)
            new = from_leaves(tail._TEMPLATE, list(new_l))
            plain_new = _swapped(new, state) if swap else new
            want, pose, metrics = tail._unpack(state, tail._plain_streams(
                state_l, leaves(plain_new), inputs, min_matches))
            if reset:
                want = tail.reset_lost(want, fresh)
            epilogue = graphs.Epilogue(
                buffers, [torch.empty_like(x[0]) for x in chunk],
                reset=fresh if reset else None)
            rows = epilogue.start(chunk)
            _require_equal_nan(f"{path}: copy_leaves, a chunk's start",
                               list(epilogue.inputs), [x[0] for x in chunk])
            what = (f"{path}: step_tail ending a runner's frame ({label}, "
                    f"S={s}, reset {'on' if reset else 'off'}"
                    f"{', swapped buffers' if swap else ''})")
            units = tail._units(
                ((x.numel() // s * x.element_size(), (x,))
                 for i, x in enumerate(leaves(buffers)) if i in tail.KINDS),
                s)
            if swap and units > tail.tail_shape()[4]:
                # the rest of the state streams after the barrier: a
                # source over another buffer is refused, nothing written
                try:
                    tail._launch(leaves(buffers), leaves(_swapped(
                        new, buffers)), inp, min_matches, (s,), epilogue)
                except ValueError:
                    _require_equal_nan(f"{what}: refused, the state",
                                       leaves(buffers), leaves(state))
                    continue
                raise AssertionError(f"{what}: {units} units a stream, "
                                     f"not refused")
            tail._launch(leaves(buffers), leaves(_swapped(new, buffers)
                                                 if swap else new),
                         inp, min_matches, (s,), epilogue)
            _require_equal_nan(f"{what}: the state", leaves(buffers),
                               leaves(want))
            _require_equal_nan(f"{what}: row 0",
                               [x[0] for x in graphs._rows_of(rows)],
                               [*pose, *metrics])
            _require_equal_nan(f"{what}: the next frame",
                               list(epilogue.inputs), [x[1] for x in chunk])
            if int(epilogue.table[:8].view(torch.int64).cpu()) != 1:
                raise AssertionError(f"{what}: the counter did not advance")
        # a group path's frame end (the reset, then one copy_leaves)
        # against the reset and the copies as torch ops
        want, pose, metrics = tail._unpack(state, tail._plain_streams(
            state_l, new_l, inputs, min_matches))
        ends = []
        for plain in (False, True):
            buffers = tree_map(torch.clone, state)
            epilogue = graphs.Epilogue(
                buffers, [torch.empty_like(x[0]) for x in chunk], reset=fresh)
            rows = epilogue.start(chunk)
            if plain:
                epilogue.counter = torch.zeros((), dtype=torch.int64,
                                               device=DEVICE)
                epilogue.finish_plain(tail.reset_lost(want, fresh), pose,
                                      metrics)
            else:
                epilogue.finish(want, pose, metrics)
            ends.append([*leaves(buffers), *graphs._rows_of(rows),
                         *epilogue.inputs])
        # row 1 of the chunk is not written yet: rows 0 only
        n_rows = len(graphs._rows_of(rows))
        keep = lambda xs: [  # noqa: E731
            x[0] if len(tail.PATHS) <= i < len(tail.PATHS) + n_rows else x
            for i, x in enumerate(xs)]
        _require_equal_nan(f"{path}: copy_leaves ending a group's frame "
                           f"({label}, S={s})", keep(ends[0]), keep(ends[1]))
        dst = tree_map(torch.clone, state)
        graphs.copy_leaves(dst, want)
        _require_equal_nan(f"{path}: copy_leaves ({label})", leaves(dst),
                           leaves(want))
    a, b = dst.map.counter, dst.map.age
    swapped = (b.clone(), a.clone())
    graphs.copy_leaves(Pose(a, b), Pose(b, a))
    _require_equal_nan(f"{path}: copy_leaves of two swapped buffers",
                       [a, b], list(swapped))
    return {"step_tail": 0.0, "copy_leaves": 0.0}


def _require_equal_nan(name: str, got, want) -> float:
    """``_require_equal`` where a NaN of the kernel matches a NaN of the
    plain version at the same place (a point triangulated from a
    degenerate pair); the gap is the largest over the finite elements."""
    got, want = _flat(got), _flat(want)
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, plain {len(want)}")
    gap = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: output {i} is {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        fin = torch.ones_like(g, dtype=torch.bool)
        if g.is_floating_point():
            fin = g.isfinite() & w.isfinite()
            same = (torch.equal(g.isnan(), w.isnan())
                    and torch.equal(torch.where(g.isnan(), 0, g),
                                    torch.where(w.isnan(), 0, w)))
        else:
            same = torch.equal(g, w)
        d = (g.double() - w.double()).abs()[fin]
        err = float(d.max()) if d.numel() else 0.0
        if not same:
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version in {int((g != w).sum())} of "
                                 f"{g.numel()} elements (largest finite gap "
                                 f"{err})")
        gap = max(gap, err)
    return gap


def track_work(name, args, outs) -> tuple[int, dict]:
    """Bytes (each input read once, each output written once) and
    operations (TRACK_WORK, SELECT_ACCEPT_WORK) of one launch of op
    ``name``."""
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    nbytes = sum(x.numel() * x.element_size() for x in [*tensors, *outs])
    s = tensors[0].shape[0]
    if name == "select_corners":
        from lvt_tpu_torch.ops import detect

        _, h, w = args[0].shape
        s_y, s_x, ncy, ncx = detect._cell_geometry(h, w, args[4])
        px = s * ncy * s_y * ncx * s_x
        alu, fp32 = SELECT_ACCEPT_WORK["select_corners"]
        return nbytes, ({"alu": px * alu, "fp32": px * fp32} if args[7]
                        else {"alu": px * SELECT_KEY_ALU})
    if name == T_ROW:
        # per stream, on each predicate's candidate counts
        iout = outs[1]
        dual = args[7].shape[1] > 0
        return nbytes, row_work(args[3], args[5], args[6],
                                args[7] if dual else None, iout[:, 1, 0],
                                iout[:, 1, 1])
    if name == "ba_observe":
        return ba_observe_work(args, outs)
    if name == "map_accept":
        return nbytes, {"alu": s * args[2].shape[1]
                        * SELECT_ACCEPT_WORK["map_accept"]}
    if name == "step_tail":
        return tail_work(args, outs)
    what, per = TRACK_WORK[name]
    if what == "map":
        items = tensors[7].shape[1]
    elif what == "staged":
        items = tensors[9 if name == "upkeep_pre" else 4].shape[1]
    else:
        items = tensors[4].shape[1]
    ops = {p: s * items * v for p, v in per.items()}
    if name in ("upkeep_pre", "staged_promote", "triangulate_insert"):
        slots = tensors[0 if name == "upkeep_pre" else 11].shape[1]
        ops["alu"] = ops.get("alu", 0) + s * slots * (
            6 if name == "upkeep_pre" else 4)
    return nbytes, ops


def ba_observe_work(args, outs) -> tuple[int, dict]:
    """Bytes and operations that one launch of ``ba_observe`` needs: T's
    second set (d1, d2, best, n_cand; the first set is not read), the
    rows of the window that stay (1 to F - 1 of its six leaves; the
    oldest row is dropped), ``n``, match_idx, the map match's observations
    and weights, the right keypoints, PnP's pose, the five masks and the
    frame number read once; the slid window and do_ba written once."""
    nb = lambda x: x.numel() * x.element_size()  # noqa: E731
    fout, iout, *rest = args[:21]
    (match_idx, obs, weights, right_kp, t, q, *window, n, map_valid,
     bookkept_valid, clean_valid, map_taken, promo_taken, frame) = rest
    s, k = fout.shape[0], fout.shape[3]
    f, m = window[0].shape[1], map_valid.shape[1]
    nbytes = (nb(fout) + nb(iout)) // 2
    nbytes += sum(nb(x) // f * (f - 1) for x in window)
    nbytes += sum(nb(x) for x in (
        match_idx, obs, weights, right_kp, t, q, n, map_valid,
        bookkept_valid, clean_valid, map_taken, promo_taken, frame, *outs))
    return nbytes, {"alu": s * (BA_OBSERVE_ALU_PER_QUERY * k
                                + BA_OBSERVE_ALU_PER_SLOT * m),
                    "fp32": s * 2 * f * m}


def tail_work(args, outs) -> tuple[int, dict]:
    """Bytes and operations that one launch of ``step_tail`` needs on this
    launch's data, stream by stream: each output leaf of the state and the
    pose read once from the one source its stream's flags pick and written
    once; the metrics written; the scalars read; the state's map validity
    where the count needs it apart from that source (a tracking frame
    after the first), its staged validity and the features' validity on
    frames that are not lost, ``match_idx`` on those frames, and the
    bookkept age, d1, d2 and the observation (x, y) of each matched slot
    of theirs, whose five adds are the float work."""
    from lvt_tpu_torch.core import tail
    from lvt_tpu_torch.core.state import LOST, NOT_INITIALIZED

    state, _, inputs, min_matches = _tail_lists(args)
    inp = tail.TailInputs(*inputs)
    nb = lambda x: x.numel() * x.element_size()  # noqa: E731
    n_state = len(tail.PATHS) + 2
    status = state[tail.STATUS]
    live, init = status != LOST, status == NOT_INITIALIZED
    tracking = live & ((inp.matches_count >= min_matches) | init)
    nbytes = 2 * sum(nb(x) for x in outs[:n_state])
    nbytes += sum(nb(x) for x in outs[n_state:])
    nbytes += sum(nb(x) for x in (inp.matches_count, inp.map_size,
                                  inp.inlier_count, inp.n_inserted,
                                  inp.used_wide_radius))
    if inp.ba_ran.dim() == 1:
        nbytes += nb(inp.ba_ran)
    per = lambda x, rows: nb(x) // x.shape[0] * int(rows.sum())  # noqa: E731
    nbytes += per(state[tail._IDX[".map.valid"]], tracking & ~init)
    nbytes += per(state[tail._IDX[".staged.valid"]], tracking)
    nbytes += per(inp.feat_valid, live) + per(inp.match_idx, live)
    matched = int(((inp.match_idx >= 0) & live[:, None]).sum())
    nbytes += matched * (inp.bookkept_age.element_size()
                         + inp.d1.element_size() + inp.d2.element_size()
                         + 2 * inp.obs.element_size())
    return nbytes, {"fp32": matched * TAIL_FP32_PER_SLOT}


def measure_track_kernels(card, path, tracked) -> dict:
    """Each of the step's kernels (STEP_OPS) on a path's captured inputs
    (``tracked``: ``capture_pnp_inputs``) at S = 1 (the last stream;
    select_corners: the last frame's 2 images) and S = MS_STREAMS: its
    device time beside its bound, its plain version's (the torch ops the
    step ran before the kernel) captured in a CUDA graph and replayed, and
    where one PyTorch call computes its core (``_library_call``) that
    call's time."""
    rep = {}
    for name, sets in tracked.items():
        op = _step_op(name)
        full = sets["last"]
        s_all = full[0].shape[0]
        sizes = (2 if name == "select_corners" else 1, s_all)
        by_s = {}
        for s in sizes:
            args = ([x[-s:].contiguous() if isinstance(x, torch.Tensor)
                     else x for x in full])
            b_ms, b_by = bound(card, *track_work(name, args, op(*args)))
            library = _library_call(name, args)
            by_s[s] = dict(
                s=s, ms=device_ms(lambda a=args: op(*a), REPS),
                plain_ms=device_ms(_graphed(
                    lambda a=args: _track_plain(name, a)), PLAIN_REPS),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=None if library is None else device_ms(library,
                                                                  REPS))
            q = by_s[s]
            lib = ("" if library is None else
                   f", the library call {q['library_ms']:.4f} ms")
            _say(path, f"{name} S={s}: kernel {q['ms']:.4f} ms (bound "
                       f"{b_ms:.3g} ms, {b_by}), the plain version graphed "
                       f"{q['plain_ms']:.4f} ms{lib}")
        rep[name] = dict(by_s[sizes[0]], batched=by_s[s_all])
        if name == "select_corners":
            rep[name].update(card["select_geometry"])
        rep[name].update(card["track_geometry"].get(name, {}))
    return rep


# frames of the chunks the timing of step_tail and copy_leaves runs in:
# more than device_ms's launches (3 + REPS a round, a few rounds), so that
# every timed launch copies a next frame; the inputs are left unset
TIMING_FRAMES = 1024


def _tiled(flat, r: int) -> tuple:
    """Captured ``step_tail`` arguments with the map r times as large: each
    map leaf and the map's tail inputs (bookkept counter and age,
    match_idx, d1, d2, the observations) repeated r times along the map
    axis."""
    from lvt_tpu_torch.core import tail

    state, new, inputs, min_matches = _tail_lists(flat)
    tile = lambda x: torch.cat([x] * r, 1).contiguous()  # noqa: E731
    maps = [i for i, p in enumerate(tail.PATHS) if p.startswith(".map.")]
    state, new = ([tile(x) if i in maps else x for i, x in enumerate(xs)]
                  for xs in (state, new))
    inputs = [tile(x) if i < 6 else x for i, x in enumerate(inputs)]
    return _tail_flat((state, new, inputs, min_matches))


def measure_step_tail(card, path, tracked) -> dict:
    """``step_tail`` as it ends a graphed frame (inside a runner's frame:
    the state into the runner's buffers, the rows, the next frame's KITTI
    pair, 2 x 1241 x 376 bytes a stream, into the input buffers, the
    counter advanced) on the captured inputs at S = 1 (the last stream)
    and S = MS_STREAMS, and at S = 1 with the map tiled to M = 4096, 8192
    and 16384: its device time beside its bound (``tail_work``, the pair
    read and written), and the plain version's (the plain tail and
    ``Epilogue.finish_plain``: torch ops) graphed. The rest of the entry
    (max_abs_err) is the checks'."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves

    full = tracked["step_tail"]["last"]
    s_all = full[0].shape[0]
    out = {}
    for s, r in ((1, 1), (s_all, 1), (1, 4), (1, 8), (1, 16)):
        flat = _tiled([x[-s:].contiguous() if isinstance(x, torch.Tensor)
                       else x for x in full], r)
        state_l, new_l, inputs, min_matches = _tail_lists(flat)
        inp = tail.TailInputs(*inputs[:-1],
                              None if inputs[-1].dim() == 2 else inputs[-1])
        state = from_leaves(tail._TEMPLATE, state_l)
        pair = [torch.empty((TIMING_FRAMES, s, 376, 1241), dtype=torch.uint8,
                            device=DEVICE) for _ in range(2)]
        times = {}
        for form in ("kernel", "plain"):
            buffers = from_leaves(tail._TEMPLATE,
                                  [x.clone() for x in state_l])
            epilogue = graphs.Epilogue(buffers,
                                       [torch.empty_like(x[0]) for x in pair])
            epilogue.start(pair)
            if form == "kernel":
                def run(b=buffers, e=epilogue):
                    tail._launch(leaves(b), new_l, inp, min_matches, (s,), e)
                times[form] = device_ms(run, REPS)
                done = int(epilogue.table[:8].view(torch.int64).cpu())
            else:
                epilogue.counter = torch.zeros((), dtype=torch.int64,
                                               device=DEVICE)

                def run(b=buffers, e=epilogue):
                    e.finish_plain(*tail._unpack(b, tail._plain_streams(
                        leaves(b), new_l, inputs, min_matches)))
                times[form] = device_ms(_graphed(run), PLAIN_REPS)
                done = int(epilogue.counter.cpu())
            if done >= TIMING_FRAMES:
                raise AssertionError(f"{path}: step_tail's timing ran "
                                     f"{done} frames of a chunk of "
                                     f"{TIMING_FRAMES}")
        outs = [*state_l, *state_l[tail._IDX[".pose.t"]:
                                   tail._IDX[".pose.q"] + 1],
                *[torch.empty((s,), dtype=d, device=DEVICE)
                  for d in tail.METRIC_DTYPES]]
        nbytes, ops = tail_work(flat, outs)
        pair_bytes = 2 * sum(x[0].numel() for x in pair)
        b_ms, b_by = bound(card, nbytes + pair_bytes, ops)
        m = state_l[tail._IDX[".map.valid"]].shape[1]
        out[(s, m)] = dict(s=s, m=m, ms=times["kernel"],
                           plain_ms=times["plain"], bound_ms=b_ms,
                           bound_by=b_by, bound_bytes=nbytes + pair_bytes,
                           library_ms=None)
        _say(path, f"step_tail ending a frame, S={s}, M={m} (the next "
                   f"pair {pair_bytes // 2} bytes, read and written): kernel "
                   f"{times['kernel']:.4f} ms (bound {b_ms:.3g} ms, {b_by}, "
                   f"{nbytes + pair_bytes} bytes), the plain version "
                   f"graphed {times['plain']:.4f} ms")
    m1 = min(m for _, m in out)
    first = out.pop((1, m1))
    first["batched"] = out.pop((s_all, m1))
    first["by_map"] = {m: v for (_, m), v in out.items()}
    return first


def measure_copy_leaves(card, path, tracked) -> dict:
    """The runner's copies that remain (``graphs.copy_leaves``): a chunk's
    start as the main path runs it (the table and frame 0, a KITTI pair,
    into the input buffers; S = 1, and S = MS_STREAMS: path 3's 16
    images), its device time beside its bound (the pair read once and
    written once), the plain copies' (a ``copy_`` per input) graphed, and
    ``torch._foreach_copy_`` of the inputs, one PyTorch call that copies a
    list of tensors; and a group path's frame end (8a: the state, the
    rows, the next pair, the counter) at S = 1."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves

    full = tracked["step_tail"]["last"]
    s_all = full[0].shape[0]
    by_s = {}
    for s in (1, s_all):
        state_l, new_l, inputs, min_matches = _tail_lists(
            [x[-s:].contiguous() if isinstance(x, torch.Tensor) else x
             for x in full])
        pair = [torch.empty((2, s, 376, 1241), dtype=torch.uint8,
                            device=DEVICE) for _ in range(2)]
        buffers = from_leaves(tail._TEMPLATE, [x.clone() for x in state_l])
        epilogue = graphs.Epilogue(buffers,
                                   [torch.empty_like(x[0]) for x in pair])
        nbytes = 2 * sum(x[0].numel() for x in pair)
        b_ms, b_by = bound(card, nbytes, {})
        into, src = list(epilogue.inputs), [x[0] for x in pair]

        def plain():
            for d, x in zip(into, src):
                d.copy_(x)

        by_s[s] = dict(
            s=s, ms=device_ms(lambda: epilogue.start(pair), REPS),
            plain_ms=device_ms(_graphed(plain), PLAIN_REPS),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda: torch._foreach_copy_(into, src),
                                 REPS))
        q = by_s[s]
        _say(path, f"copy_leaves starting a chunk, S={s} ({nbytes // 2} "
                   f"bytes): kernel {q['ms']:.4f} ms (bound {b_ms:.3g} ms, "
                   f"{b_by}), the plain copies graphed {q['plain_ms']:.4f} "
                   f"ms, torch._foreach_copy_ {q['library_ms']:.4f} ms")
        if s == 1:
            state = from_leaves(tail._TEMPLATE, state_l)
            want, pose, metrics = tail._unpack(state, tail._plain_streams(
                state_l, new_l, inputs, min_matches))
            big = [torch.empty((TIMING_FRAMES, 1, 376, 1241),
                               dtype=torch.uint8, device=DEVICE)
                   for _ in range(2)]
            frame_end = graphs.Epilogue(
                buffers, [torch.empty_like(x[0]) for x in big])
            frame_end.start(big)
            frame_ms = device_ms(lambda: frame_end.finish(want, pose,
                                                          metrics), REPS)
            state_bytes = sum(x.numel() * x.element_size()
                              for x in leaves(want))
            f_ms, _ = bound(card, 2 * state_bytes + nbytes, {})
            q.update(frame_end_ms=frame_ms, frame_end_bound_ms=f_ms)
            _say(path, f"copy_leaves ending a group path's frame, S=1 (the "
                       f"state {state_bytes} bytes, the rows, the next "
                       f"pair): kernel {frame_ms:.4f} ms (bound {f_ms:.3g} "
                       f"ms, bytes)")
    return dict(by_s[1], batched=by_s[s_all])


def capture_ba_inputs(path, frames, config) -> dict:
    """The inputs that local BA's kernel (``lvt_tpu_torch::ba_refine``)
    launched with at the BA frames while ``frames()`` tracked a path's
    first frames eagerly (``disable_graphs``: an eager step computes BA on
    every frame, and a replay calls no Python): ``args`` (t, q, pos, obs,
    w, obs_r, w_r) with a leading stream axis and ``cam`` (fx, fy, cx, cy,
    baseline, reprojection_th2, iterations). A VOSystem's BA frames are
    stacked as streams; a MultiStreamVO's vmapped call reaches the op's
    batching rule, which launches once on the streams' real tensors (the
    last BA frame's are kept)."""
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.solver import bundle

    seen, real = [], bundle.ba_refine_op

    def record(*args):
        if not torch._C._functorch.is_batchedtensor(args[0]):
            seen.append(tuple(x.clone() if isinstance(x, torch.Tensor)
                              else x for x in args))
        return real(*args)

    bundle.ba_refine_op = record
    try:
        with disable_graphs():
            n = frames()
    finally:
        bundle.ba_refine_op = real
    if len(seen) != n:
        raise AssertionError(f"{path}: {len(seen)} launches of ba_refine in "
                             f"{n} eager frames, not one per frame")
    ba = [c for c, b in zip(seen, _ba_frames(config, range(n))) if b]
    args = (ba[-1][:7] if ba[-1][0].shape[0] > 1 else
            tuple(torch.cat(x) for x in zip(*(c[:7] for c in ba))))
    return dict(args=args, cam=seen[0][7:])


def few_ba_points(args) -> tuple:
    """``args`` (captured BA windows) with stream i's observations cut to
    its first FEW_BA_POINTS[i] observed points."""
    w, w_r = args[4], args[6]
    seen = ((w > 0) | (w_r > 0)).any(1)                       # [S, M]
    k = torch.tensor(FEW_BA_POINTS[:w.shape[0]], device=w.device)[:, None]
    keep = (seen & (torch.cumsum(seen.int(), -1) <= k))[:, None]
    return (*args[:4], w * keep, args[5], w_r * keep)


def _ba_plain(args, cam) -> tuple:
    """The plain version (torch ops, ``refine_structure_plain``) stream by
    stream on the card, stacked as ba_refine's outputs."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import bundle

    fx, fy, cx, cy, baseline, th2, iters = cam
    outs = [bundle.refine_structure_plain(
        Pose(*a[:2]), *a[2:], fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline,
        iterations=iters, reprojection_th2=th2) for a in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


def _ba_phases(args, cam) -> tuple:
    """The sharded body's phases on one rank (every all-reduce the
    identity), vmapped over the streams: ``bundle.n_phases`` launches of
    ``ba_phase`` for all S streams, as ba_refine's outputs."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import bundle

    kw = dict(zip(("fx", "fy", "cx", "cy", "baseline", "reprojection_th2",
                   "iterations"), cam))
    return torch.func.vmap(lambda t, q, *a: bundle.refine_structure_phases(
        Pose(t, q), *a, **kw).outputs())(*args)


def _first_points(args, m: int) -> tuple:
    """BA windows cut to their first m points (a rank's block)."""
    t, q, pos, obs, w, obs_r, w_r = args
    return (t, q, *(x[:, :m].contiguous() for x in (pos,)),
            *(x[:, :, :m].contiguous() for x in (obs, w, obs_r, w_r)))


def check_ba_phase(path, label, args, cam, got) -> float:
    """The sharded body's phases on one rank against ``ba_refine``'s
    outputs ``got`` on the same windows: all S streams in each phase's one
    launch, and each stream alone (S = 1); then on the windows cut to M /
    2 and M / 4 points (the blocks of 2 and 4 ranks) against ``ba_refine``
    there. Every output bit-equal; returns the largest gap to ``got``."""
    from lvt_tpu_torch.solver import bundle

    s, m = args[2].shape[:2]
    phases = _ba_phases(args, cam)
    same = all(torch.equal(a, b) for a, b in zip(phases, got))
    alone = all(torch.equal(a[0], b[i]) for i in range(s)
                for a, b in zip(_ba_phases(
                    tuple(x[i:i + 1] for x in args), cam), phases))
    cuts = {}
    for k in (2, 4):
        cut = _first_points(args, m // k)
        cuts[m // k] = all(torch.equal(a, b) for a, b in zip(
            _ba_phases(cut, cam), bundle.ba_refine_op(*cut, *cam)))
    torch.cuda.synchronize()
    _say(path, f"ba_phase S={s} x M={m} ({label}), {bundle.n_phases(cam[6])}"
               f" launches each on one rank: "
               f"{'bit-equal' if same else 'NOT equal'} to ba_refine; every "
               f"stream {'bit-equal' if alone else 'NOT equal'} to its S=1 "
               f"phases; cut to M = " + ", ".join(
                   f"{mk} {'bit-equal' if v else 'NOT equal'}"
                   for mk, v in cuts.items()) + " to ba_refine there")
    if not (same and alone and all(cuts.values())):
        raise AssertionError(f"{path}: ba_phase differs from ba_refine "
                             f"({label}): S launch {same}, S=1 {alone}, "
                             f"cuts {cuts}")
    return _max_abs_err(phases, got)


def check_ba_refine(path, inputs) -> dict:
    """Local BA's kernel against its plain version on the card, on a path's
    captured BA windows (``capture_ba_inputs``) and on the same windows cut
    to few points (``few_ba_points``), all S streams in one launch: every
    output (positions, chi2, n_obs, the accept bits) bit-equal to the
    plain version's, stream by stream (the gaps printed), and each stream
    bit-equal to its own S = 1 launch; and the sharded body's phases on
    one rank bit-equal to it (``check_ba_phase``). Returns the largest
    gaps (``phase_max_abs_err``: the phases' to the plain version)."""
    from lvt_tpu_torch.solver import bundle

    cam = inputs["cam"]
    gaps = {}
    for label, args in (("captured", inputs["args"]),
                        ("few points", few_ba_points(inputs["args"]))):
        s, m = args[2].shape[:2]
        got = bundle.ba_refine_op(*args, *cam)
        want = _ba_plain(args, cam)
        torch.cuda.synchronize()
        plain = all(torch.equal(a, b) for a, b in zip(got, want))
        alone = all(torch.equal(a[0], b[i]) for i in range(s)
                    for a, b in zip(bundle.ba_refine_op(
                        *(x[i:i + 1] for x in args), *cam), got))
        dp = (got[0] - want[0]).double().norm(dim=-1).amax(-1)
        rel = ((got[1] - want[1]).double().abs()
               / want[1].double().abs().clamp(min=1e-30))
        moved = (want[0] != args[2]).any(-1).sum(-1).tolist()
        _say(path, f"ba_refine S={s} x F={args[3].shape[1]} x M={m} "
                   f"({label}) against the plain version on the card, per "
                   f"stream: position gap {dp.tolist()} m, chi2 "
                   f"{rel.tolist()} relative, n_obs {got[2].tolist()} "
                   f"(plain {want[2].tolist()}), accepted steps "
                   f"{got[3].sum(-1).tolist()} (plain "
                   f"{want[3].sum(-1).tolist()}), points refined {moved}; "
                   f"{'bit-equal' if plain else 'NOT equal'} to the plain "
                   f"version; every stream "
                   f"{'bit-equal' if alone else 'NOT equal'} to its S=1 "
                   f"launch")
        if not plain:
            raise AssertionError(f"{path}: ba_refine differs from its plain "
                                 f"version ({label}): positions "
                                 f"{dp.max()} m, chi2 {rel.max()}")
        if not alone:
            raise AssertionError(f"{path}: a stream of the S={s} ba_refine "
                                 f"launch ({label}) differs from its S=1 "
                                 f"launch")
        phase_err = check_ba_phase(path, label, args, cam, got)
        for key, v in (("pos_m", dp.max()), ("chi2_rel", rel.max()),
                       ("max_abs_err", _max_abs_err(got, want)),
                       ("phase_max_abs_err",
                        phase_err + _max_abs_err(got, want))):
            gaps[key] = max(float(v), gaps.get(key, 0.0))
        gaps.update(s=s, m=m)
    return gaps


def ba_refine_work(args, cam) -> tuple[int, dict]:
    """Bytes and operations of the BA bodies of ``args`` (see
    BA_FP32_PER_OBS_ITER): the observations and points that take part
    (the plain version's gate and mask), the observations with a
    positive input weight."""
    from lvt_tpu_torch.geometry.se3 import Pose
    from lvt_tpu_torch.solver import bundle

    fx, fy, cx, cy, baseline, th2, iters = cam
    s, f, m = args[3].shape[:3]
    n_obs = n_pts = n_in = 0
    for t, q, pos, obs, w, obs_r, w_r in zip(*args):
        wg, wg_r = bundle.chi2_gate_weights(
            Pose(t, q), pos, obs, w, fx=fx, fy=fy, cx=cx, cy=cy,
            baseline=baseline, obs_right=obs_r, w_right=w_r)
        use = (((wg > 0).sum(0) >= 2) & (((wg > 0) & (wg_r > 0)).sum(0) >= 1))
        n_obs += int(((wg > 0) & use).sum() + ((wg_r > 0) & use).sum())
        n_pts += int(use.sum())
        n_in += int((w > 0).sum() + (w_r > 0).sum())
    free, n = f - 1, 6 * (f - 1)
    schur = 108 * free * (free - 1) // 2 + 63 * free
    fp64_pt = 18 * f + 9 + 54 * free + schur + 18 * free
    fp64 = iters * (BA_FP64_PER_OBS_ITER * n_obs + fp64_pt * n_pts
                    + s * (n ** 3 // 3 + n * n))
    fp32 = (iters * (BA_FP32_PER_OBS_ITER * n_obs
                     + BA_FP32_PER_POINT_ITER * n_pts)
            + BA_FP32_PER_OBS * n_in + BA_FP32_PER_POINT * s * m)
    nbytes = s * (28 * f + 24 * m + 24 * f * m + 4 + 8 + iters)
    return nbytes, {"fp32": fp32, "fp64_tensor": fp64}


def measure_ba_refine(card, path, inputs) -> dict:
    """``check_ba_refine``, then at S = 1 (stream 0) and S = all: the
    kernel's device time beside its bound, and the sharded body's phases
    on one rank (``_ba_phases``: ``bundle.n_phases`` launches, graphed) as
    a whole BA beside the same bound; at S = 1 the plain version's,
    captured in a CUDA graph and replayed (the IF node's body before this
    kernel; it runs stream by stream, so S streams take S times as long).
    No one PyTorch call runs a bundle adjustment: no library time. The
    report carries the kernel's shape as built (``ba_geometry``) and the
    phases' entry (``phases``)."""
    from lvt_tpu_torch.solver import bundle

    gaps = check_ba_refine(path, inputs)
    cam, rep = inputs["cam"], {}
    n_streams = inputs["args"][0].shape[0]
    for s in sorted({1, n_streams}):
        args = tuple(x[:s].contiguous() for x in inputs["args"])
        b_ms, b_by = bound(card, *ba_refine_work(args, cam))
        rep[s] = dict(
            s=s, f=args[3].shape[1], m=args[2].shape[1],
            ms=device_ms(lambda a=args: bundle.ba_refine_op(*a, *cam), REPS),
            phases_ms=device_ms(_graphed(lambda a=args: _ba_phases(a, cam)),
                                PLAIN_REPS),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        q = rep[s]
        if s == 1:
            q["plain_ms"] = device_ms(
                _graphed(lambda a=args: _ba_plain(a, cam)), PLAIN_REPS)
        _say(path, f"ba_refine S={s} x F={q['f']} x M={q['m']}: kernel "
                   f"{q['ms']:.4f} ms (bound {b_ms:.3g} ms, {b_by}; a "
                   f"cluster of {card['ba_geometry']['cluster']} blocks of "
                   f"{card['ba_geometry']['threads']} threads per stream)"
                   + (f", the plain version graphed {q['plain_ms']:.4f} ms"
                      if s == 1 else "")
                   + f"; ba_phase, the whole body as "
                   f"{bundle.n_phases(cam[6])} launches on one rank, graphed "
                   f"{q['phases_ms']:.4f} ms")
    keys = ("s", "f", "m", "bound_ms", "bound_by", "library_ms")

    def phases(q):
        return dict({k: q[k] for k in keys}, ms=q["phases_ms"],
                    launches_per_ba=bundle.n_phases(cam[6]))

    out = dict(rep[1], batched=rep[n_streams], **gaps, **card["ba_geometry"])
    out["phases"] = dict(phases(rep[1]), plain_ms=rep[1]["plain_ms"],
                         max_abs_err=gaps["phase_max_abs_err"],
                         batched=phases(rep[n_streams]),
                         **card["ba_geometry"])
    return out


def _phase_report(rep) -> dict:
    """The phases' entry from ``measure_pnp_solve``'s report: their time
    for one whole solve (N_PHASES launches) as the kernel's, beside the
    same plain version and bound; their outputs are the fused kernel's
    bit for bit, so their error is its error."""
    keys = ("s", "m", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    out = {k: rep[k] for k in keys if k in rep}
    out["ms"] = rep["phases_ms"]
    if "batched" in rep:
        out["batched"] = _phase_report(rep["batched"])
    return out


def old_op_inputs(inputs) -> dict:
    """The inputs that PnP's two reduction ops (``pnp_normal_eqs``,
    ``stream_sum``) launched with in the plain version's solve of each
    stream of ``inputs`` on the card (PNP_PLAIN_OPS launches each per
    stream): each stream's first LM iteration's launch, stacked as
    streams."""
    from lvt_tpu_torch.solver import pnp

    seen = {"pnp_normal_eqs_op": [], "stream_sum_op": []}
    real = {name: getattr(pnp, name) for name in seen}

    def recorder(name):
        def record(*args):
            seen[name].append(tuple(x.clone() for x in args
                                    if isinstance(x, torch.Tensor)))
            return real[name](*args)
        return record

    for name in seen:
        setattr(pnp, name, recorder(name))
    try:
        _plain_solves(inputs["args"], inputs["cam"])
    finally:
        for name, fn in real.items():
            setattr(pnp, name, fn)
    s = inputs["args"][0].shape[0]
    for name, calls in seen.items():
        if len(calls) != PNP_PLAIN_OPS * s:
            raise AssertionError(f"{len(calls)} launches of {name} in {s} "
                                 f"plain solves, not {PNP_PLAIN_OPS} each")
    return {name[:-3]: tuple(torch.cat(x) for x in zip(
        *calls[1::PNP_PLAIN_OPS])) for name, calls in seen.items()}


def measure_pnp(card, path, inputs) -> dict:
    """PnP's two reduction ops (the plain version's, off the main path) on
    the inputs they took in the plain solves of a path's captured streams
    (``old_op_inputs``) at S = 1 (stream 0) and S = 8:
    against their plain versions on the card stream by stream (each output
    within 1e-5 of the sum of its terms' magnitudes: the ops sum in their
    own order by design), each stream of the S = 8 launch
    bit-equal to its own S = 1 launch, then timed beside the bound and one
    PyTorch call. ``pnp_normal_eqs``: 60 bytes in per point, 48 floats out
    per stream; per point 12 float32 products and 54 float64 fused
    multiply-adds at the tensor rate (H's upper triangle and g, as
    PNP_FP64_PER_POINT; the kernel folds all 84 products of [H | g]); the
    call is one torch.einsum making [H | g] from jw and
    [jac | r] formed beforehand. ``stream_sum``: 4 bytes in per point, 4
    out per stream, one float32 add per point; the call is ``x.sum(-1)``."""
    from lvt_tpu_torch.solver import pnp

    def per_stream(fn):
        def run(*args):
            outs = [fn(*x) for x in zip(*args)]
            if isinstance(outs[0], tuple):
                return tuple(torch.stack(o) for o in zip(*outs))
            return torch.stack(outs)
        return run

    kinds = {
        "pnp_normal_eqs": dict(
            op=pnp.pnp_normal_eqs_op,
            plain=per_stream(pnp.normal_equations_plain),
            scale=lambda jac, w, r: (jac.abs(), w, r.abs()),
            work=lambda s, m: (s * m * 15 * 4 + s * 48 * 4,
                               {"fp32": s * m * 12,
                                "fp64_tensor": s * m * 54}),
            library=lambda jac, w, r: (lambda jw=jac * w[..., None, None],
                                       x=torch.cat([jac, r[..., None]], -1):
                                       torch.einsum("smki,smkj->sij", jw, x)),
            call="torch.einsum"),
        "stream_sum": dict(
            op=pnp.stream_sum_op, plain=per_stream(torch.sum),
            scale=lambda x: (x.abs(),),
            work=lambda s, m: (s * m * 4 + s * 4, {"fp32": s * m}),
            library=lambda x: (lambda: x.sum(-1)), call="x.sum(-1)"),
    }
    report = {}
    for name, k in kinds.items():
        rep = {}
        n_streams = inputs[name][0].shape[0]
        for s in (1, n_streams):
            args = tuple(x[:s].contiguous() for x in inputs[name])
            m = args[0].shape[1]
            got, want = _flat(k["op"](*args)), _flat(k["plain"](*args))
            scale = _flat(k["plain"](*k["scale"](*args)))
            torch.cuda.synchronize()
            rel = max(float(((g - x).abs() / (sc + 1e-30)).max())
                      for g, x, sc in zip(got, want, scale))
            err = _max_abs_err(got, want)
            if not rel <= 1e-5:
                raise AssertionError(f"{name} S={s}: relative error {rel} "
                                     f"> 1e-5")
            for i in range(s):
                one = _flat(k["op"](*(x[i:i + 1] for x in args)))
                if not all(torch.equal(a[0], b[i]) for a, b in zip(one, got)):
                    raise AssertionError(f"{name}: stream {i} of S={s} "
                                         f"differs from its S=1 launch")
            b_ms, b_by = bound(card, *k["work"](s, m))
            extra = {}
            if name == "pnp_normal_eqs":
                # why pnp_solve sums all 42 entries of [H | g]: H is not
                # symmetric to the bit (jw_i rounded before its product)
                h = got[0][..., :6]
                extra["h_bit_symmetric_streams"] = int(
                    (h == h.transpose(-1, -2)).all(-1).all(-1).sum())
                _say("pnp", f"pnp_normal_eqs S={s} ({path}'s inputs): H "
                            f"bit-symmetric in "
                            f"{extra['h_bit_symmetric_streams']} of {s} "
                            f"streams")
            rep[s] = dict(
                s=s, m=m, max_abs_err=err, max_rel_err=rel, **extra,
                ms=device_ms(lambda a=args: k["op"](*a), REPS),
                plain_ms=device_ms(lambda a=args: k["plain"](*a), PLAIN_REPS),
                library_ms=device_ms(k["library"](*args), REPS),
                bound_ms=b_ms, bound_by=b_by)
            q = rep[s]
            _say("pnp", f"{name} S={s} x M={m} ({path}'s inputs): within {rel:.3g} of each sum of term "
                        f"magnitudes (max abs err {err:.3g}) of plain, every "
                        f"stream bit-equal to its S=1 launch; kernel "
                        f"{q['ms']:.4f} ms (bound {b_ms:.3g} ms, {b_by}), "
                        f"{k['call']} {q['library_ms']:.4f} ms, plain "
                        f"{q['plain_ms']:.4f} ms")
        report[name] = dict(rep[1], batched=rep[n_streams],
                            max_abs_err=max(r["max_abs_err"]
                                            for r in rep.values()))
    return report


def phase_multistream_cpu(config, first_poses, inputs):
    """Streams 0-1 over frames 0-3 of path 3 again, on the CPU."""
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    msvo = MultiStreamVO(config, MS_CPU[0], device="cpu")
    poses, _ = msvo.track_chunk(*(x.cpu() for x in inputs))
    dt = float((poses.t - first_poses.cpu()).abs().max())
    _say("path3", f"card vs CPU, streams 0-{MS_CPU[0] - 1} over frames "
                  f"0-{MS_CPU[1] - 1}: poses differ by at most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"path3: CPU vs card pose difference {dt} m "
                             f">= 1e-3 m")


def rgbd_setup():
    """Path 4's camera and frames: the oracle's `rgbd` scenario (the
    default 640x480 synthetic world, 0.5 m per frame, the default config
    at the world's intrinsics), uint8 gray and float32 metric depth."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    world = SyntheticWorld()
    config = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                      baseline=world.baseline, img_width=world.width,
                      img_height=world.height)
    frames = list(world.rgbd_sequence(_n_frames("path4"), speed=RGBD_SPEED))
    gray = np.stack([np.clip(g, 0, 255).astype(np.uint8) for g, _, _ in frames])
    depth = np.stack([d.astype(np.float32) for _, d, _ in frames])
    rot = np.array([r for _, _, (r, _) in frames])
    pos = np.array([t for _, _, (_, t) in frames])
    return config, torch.from_numpy(gray), torch.from_numpy(depth), rot, pos


def phase_rgbd(config, gray, depth, rot, pos, profile_dir=None):
    """Path 4: VOSystem(SensorType.RGBD).track_chunk on the card; kernels
    A, P and T against their plain versions at the shapes of its frame 0,
    for one stream and for RGBD_MS[0] (``check_path_kernels``); the card
    against the CPU; MultiStreamVO(rgbd=True); the TUM fr1 camera's
    extraction (with its distortion) card against CPU, and its one-cell
    selection (``select_corners``) against the plain version."""
    from lvt_tpu_torch.configs import tum_rgbd_config
    from lvt_tpu_torch.core.extract import extract_features_rgbd
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.core.state import TRACKING
    from lvt_tpu_torch.core.system import SensorType, TrackingState, VOSystem
    from lvt_tpu_torch.io.synthetic import SyntheticWorld, ate_rmse
    from lvt_tpu_torch.ops import perception
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    n = gray.shape[0]
    gd, dd = gray.to(DEVICE), depth.to(DEVICE)
    chunk, n_units = RUNS["path4"]
    drive = _chunks_of(gd, dd, chunk)
    run = _run_modes("path4", lambda: VOSystem(config, SensorType.RGBD,
                                               device=DEVICE),
                     drive, n_units, chunk)
    vo, g = run["graph"]["system"], run["graph"]
    status = vo.get_state()
    est = g["poses"].t.cpu().numpy()
    err = ate_rmse(est, pos)
    dist = float(np.linalg.norm(pos[-1] - pos[0]))
    _say("path4", f"RGB-D, {n} frames {gray.shape[1]}x{gray.shape[2]} "
                  f"(uint8 gray, float32 depth) in chunks of {chunk}: status "
                  f"{status.name}, map {vo.map_size} points")
    report = _report_modes("path4", run)
    _same_modes("path4", run)
    _say("path4", f"ATE RMSE {err:.4f} m over {dist:.2f} m "
                  f"({100 * err / dist:.3f}%)")
    if status != TrackingState.TRACKING:
        raise AssertionError(f"path4: final status {status.name}")
    if not err < 0.05 * dist:
        raise AssertionError(f"path4: ATE {err:.4f} m not under 5% of "
                             f"{dist:.2f} m")
    _check_wrapper_counts("path4", run, n)

    def feats(idx, dev):
        """extract_features_rgbd of the frames ``idx``, stacked."""
        fs = [extract_features_rgbd(gd[i].to(dev), dd[i].to(dev), config)
              for i in idx]
        return type(fs[0])(*(torch.stack(x) for x in zip(*fs)))

    # frame 0 of the single stream, and of the RGB-D streams below (stream
    # i from frame 2i): A and P on its gray images, T at both sites
    kernel_errs = {}
    for s in (1, RGBD_MS[0]):
        idx = [MS_START_STEP * i for i in range(s)]
        sites = t_site_inputs(config, feats(idx, DEVICE),
                              feats([i + 1 for i in idx], DEVICE))
        errs = check_path_kernels(f"path4 ({s} stream{'s' * (s > 1)})",
                                  config, gd[idx],
                                  lambda dev, idx=idx: feats(idx, dev), sites)
        kernel_errs = {k: max(v, kernel_errs.get(k, 0.0))
                       for k, v in errs.items()}
    prof = _profiles("path4", run, drive, profile_dir)
    prof["host_launches"] = host_between_replays(
        "path4", lambda: drive(vo, n_units - 1), 1, chunk)
    kernel_errs["pnp_solve"] = check_pnp_solve("path4", capture_pnp_inputs(
        "path4", _first_frames(lambda: VOSystem(config, SensorType.RGBD,
                                                device=DEVICE), gd, dd)))[
        "max_abs_err"]

    k = N_CPU_FRAMES["path4"]
    cpu = VOSystem(config, SensorType.RGBD, device="cpu")
    p, _ = cpu.track_chunk(gray[:k], depth[:k])
    dt = float((p.t - g["poses"].t[:k].cpu()).abs().max())
    _say("path4", f"card vs CPU: poses of frames 0-{k - 1} differ by at "
                  f"most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"path4: CPU vs card pose difference {dt} m")

    s, m = RGBD_MS
    a = torch.stack([gd[MS_START_STEP * i:MS_START_STEP * i + m]
                     for i in range(s)], 1)
    b = torch.stack([dd[MS_START_STEP * i:MS_START_STEP * i + m]
                     for i in range(s)], 1)
    msvo = MultiStreamVO(config, s, device=DEVICE, rgbd=True)
    p, mg = msvo.track_chunk(a, b)
    with disable_graphs():
        pe, me = MultiStreamVO(config, s, device=DEVICE,
                               rgbd=True).track_chunk(a, b)
    same = all(torch.equal(x, y) for x, y in zip([*p, *mg], [*pe, *me]))
    _say("path4", f"MultiStreamVO(rgbd=True), {s} streams x {m} frames: "
                  f"statuses {msvo.status.tolist()}; graph "
                  f"{'=' if same else 'DIFFERS FROM'} eager bit for bit "
                  f"(poses, every metrics leaf)")
    if not (msvo.status == TRACKING).all():
        raise AssertionError("path4: a multi-stream RGB-D stream is not "
                             "TRACKING")
    if not same:
        raise AssertionError("path4: the multi-stream RGB-D graph differs "
                             "from the eager step")

    # TUM fr1's camera with its distortion, one frame of points 2-6 m away
    tum = tum_rgbd_config(1)
    (g1, d1, _), = SyntheticWorld(
        fx=tum.fx, fy=tum.fy, cx=tum.cx, cy=tum.cy, extent_x=4.0,
        extent_y=3.0, extent_z=6.0).rgbd_sequence(1)
    g1 = torch.from_numpy(np.clip(g1, 0, 255).astype(np.uint8))
    d1 = torch.from_numpy(d1.astype(np.float32))
    fc = extract_features_rgbd(g1.to(DEVICE), d1.to(DEVICE), tum)
    fh = extract_features_rgbd(g1, d1, tum)
    dkp = float((fc.kp.cpu() - fh.kp).abs().max())
    same = (torch.equal(fc.valid.cpu(), fh.valid)
            and torch.equal(fc.desc.cpu(), fh.desc))
    _say("path4", f"TUM fr1 extraction (k1 {tum.k1}), card vs CPU: "
                  f"{int(fh.valid.sum())} valid of {tum.kp_capacity}, valid "
                  f"and desc {'equal' if same else 'DIFFER'}, kp within "
                  f"{dkp:.3g} px")
    if not same or not dkp < 1e-3 or int(fh.valid.sum()) == 0:
        raise AssertionError("path4: TUM fr1 extraction differs card vs CPU")
    # the TUM fr1 YAML's selection (one cell of 640 x 480 keeping 1000) on
    # kernel A's maps of path 4's first MS_STREAMS gray frames: 1 image as
    # extraction launches it, and all of them in one launch
    nms = perception.perception_patch_maps_batched(gd[:MS_STREAMS])[0]
    args = [nms, nms.new_zeros((0,)), nms.new_zeros((0,), dtype=torch.int32),
            float(tum.agast_threshold),
            tum.detection_cell_size, tum.max_keypoints_per_cell,
            tum.corners_low_threshold, True, tum.kp_capacity]
    _track_errs("path4-tum", check_track_kernels("path4 (TUM fr1 selection)", {
        "select_corners": dict(first=[nms[:1], *args[1:]], last=args)}))
    return dict(report, profile=prof, launches=prof["launches"],
                kernel_errs=kernel_errs)


def euroc_setup():
    """Path 5's config, maps and frames: raw uint8 frames of the EuRoC rig
    seeing EUROC_CLOUD from positions 0, EUROC_SPEED, ... m along the
    rectified optical axis, and those positions (the ground truth)."""
    from lvt_tpu_torch.configs import euroc_config
    from lvt_tpu_torch.io.datasets import euroc_rectify_maps, render_euroc_raw

    c = EUROC_CLOUD
    rs = np.random.RandomState(5)
    points = np.stack([rs.uniform(-c["x"], c["x"], c["n"]),
                       rs.uniform(-c["y"], c["y"], c["n"]),
                       rs.uniform(2.0, c["z"], c["n"])], -1)
    shade = rs.uniform(60.0, 215.0, c["n"])
    n = _n_frames("path5")
    gt = np.array([[0.0, 0.0, EUROC_SPEED * i] for i in range(n)])
    raw = [torch.from_numpy(np.stack([render_euroc_raw(points, shade, t, rt)
                                      for t in gt]))
           for rt in (False, True)]
    return euroc_config(), euroc_rectify_maps(), raw[0], raw[1], gt


def tum_setup():
    """Path 7's TUM frames: path 4's camera and config (the default
    synthetic world's) over TUM_CLOUD; uint8 gray, float32 metric depth
    and the camera positions."""
    from lvt_tpu_torch.config import VOConfig
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    c = TUM_CLOUD
    world = SyntheticWorld(extent_x=c["x"], extent_y=c["y"], extent_z=c["z"])
    config = VOConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                      baseline=world.baseline, img_width=world.width,
                      img_height=world.height)
    frames = list(world.rgbd_sequence(CHUNK * 3, speed=TUM_SPEED))
    gray = np.stack([np.clip(g, 0, 255).astype(np.uint8) for g, _, _ in frames])
    depth = np.stack([d.astype(np.float32) for _, d, _ in frames])
    return config, gray, depth, np.array([t for _, _, (_, t) in frames])


def _every_frame_tracking(path, status) -> None:
    from lvt_tpu_torch.core.state import TRACKING

    bad = [i for i, x in enumerate(status.tolist()) if x != TRACKING]
    if bad:
        raise AssertionError(f"{path}: frames {bad} not TRACKING")


def _check_ate(path, est, gt) -> str:
    from lvt_tpu_torch.io.synthetic import ate_rmse

    err = ate_rmse(est, gt)
    dist = float(np.linalg.norm(gt[-1] - gt[0]))
    if not err < 0.05 * dist:
        raise AssertionError(f"{path}: ATE {err:.4f} m is not under 5% of "
                             f"{dist:.2f} m")
    return f"ATE RMSE {err:.4f} m over {dist:.2f} m ({100 * err / dist:.3f}%)"


def phase_rectified(config, maps, il, ir, gt, profile_dir=None):
    """Path 5: raw EuRoC frames through VOSystem(rectify_maps=...) on the
    card; the kernels at its shapes (A's float32 kernel on the remapped
    pair); the card against the CPU."""
    from lvt_tpu_torch.core import step
    from lvt_tpu_torch.core.extract import extract_features_batched
    from lvt_tpu_torch.core.system import VOSystem

    n = il.shape[0]
    ild, ird = il.to(DEVICE), ir.to(DEVICE)
    chunk, n_units = RUNS["path5"]
    drive = _chunks_of(ild, ird, chunk)
    run = _run_modes("path5", lambda: VOSystem(config, device=DEVICE,
                                               rectify_maps=maps),
                     drive, n_units, chunk)
    vo, g = run["graph"]["system"], run["graph"]
    _say("path5", f"EuRoC rectified, {n} raw frames {il.shape[1]}x"
                  f"{il.shape[2]} uint8 in chunks of {chunk}, remapped in "
                  f"the step ({config.kp_capacity} slots, "
                  f"{config.max_map_points} map points): status "
                  f"{vo.get_state().name}, map {vo.map_size} points")
    report = _report_modes("path5", run)
    _same_modes("path5", run)
    _say("path5", _check_ate("path5", g["poses"].t.cpu().numpy(), gt))
    _every_frame_tracking("path5", g["metrics"].status)
    _check_wrapper_counts("path5", run, n)

    # frames 0 and 1 remapped on the card (frame 0 also on the CPU), then
    # the kernels at the shapes of frame 0
    mc = [torch.from_numpy(m) for m in maps]
    md = [m.to(DEVICE) for m in mc]
    rect, rect1 = (torch.stack(step._rectify_pair(ild[i], ird[i], *md))
                   for i in (0, 1))
    rect_cpu = torch.stack(step._rectify_pair(il[0], ir[0], *mc))
    if rect.dtype != torch.float32 or not torch.equal(rect.cpu(), rect_cpu):
        raise AssertionError("path5: frame 0's remap differs card vs CPU")
    f0 = extract_features_batched(rect, config)
    f1 = extract_features_batched(rect1[:1], config)
    sites = t_site_inputs(config, _streams(f0, [0]), f1, _streams(f0, [1]))
    kernel_errs = check_path_kernels(
        "path5", config, rect,
        lambda dev: extract_features_batched(rect_cpu.to(dev), config),
        {k: sites[k] for k in T_SITES["path5"]})
    _say("path5", "frame 0's remapped pair card vs CPU bit-equal (float32)")
    prof = _profiles("path5", run, drive, profile_dir)
    prof["host_launches"] = host_between_replays(
        "path5", lambda: drive(vo, n_units - 1), 1, chunk)
    k = N_CPU_FRAMES["path5"]
    cpu = VOSystem(config, device="cpu", rectify_maps=maps)
    p, _ = cpu.track_chunk(il[:k], ir[:k])
    dt = float((p.t - g["poses"].t[:k].cpu()).abs().max())
    _say("path5", f"card vs CPU: poses of frames 0-{k - 1} differ by at "
                  f"most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"path5: CPU vs card pose difference {dt} m")
    return dict(report, profile=prof, launches=prof["launches"],
                kernel_errs=kernel_errs,
                pnp_inputs=capture_pnp_inputs("path5", _first_frames(
                    lambda: VOSystem(config, device=DEVICE,
                                     rectify_maps=maps), ild, ird)))


def _external_corners(config, il, ir) -> list:
    """Each frame's corners as a caller would pass them: the valid
    keypoints of the port's own extraction on the card, host [N, 2] for
    the left and the right image."""
    from lvt_tpu_torch.core.extract import extract_features_batched

    out = []
    for i in range(il.shape[0]):
        f = extract_features_batched(torch.stack([il[i], ir[i]]), config)
        out.append(tuple(f.kp[j][f.valid[j]].cpu().numpy() for j in (0, 1)))
    return out


def _padded_corners(corners, cap: int):
    """A frame's (left, right) [N, 2] corners padded to ``cap`` slots on
    the card: corners [2, cap, 2] f32 and validity [2, cap]."""
    packed = np.zeros((2, cap, 2), np.float32)
    valid = np.zeros((2, cap), bool)
    for side, c in enumerate(corners):
        packed[side, :len(c)] = c[:cap]
        valid[side, :len(c)] = True
    return torch.from_numpy(packed).to(DEVICE), torch.from_numpy(valid).to(
        DEVICE)


def phase_external(config, il, ir, gt, profile_dir=None):
    """Path 6: VOSystem.track_with_external_corners frame by frame on the
    card, graph and eager; descriptors and poses card vs CPU."""
    from lvt_tpu_torch.core.extract import describe_external_corners_batched
    from lvt_tpu_torch.core.system import VOSystem

    n = il.shape[0]
    corners = _external_corners(config, il, ir)

    def drive(vo, u):
        out = [(vo.track_with_external_corners(il[i], ir[i], *corners[i]),
                vo.last_metrics)
               for i in range(u * EXT_UNIT, (u + 1) * EXT_UNIT)]
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        return tuple(type(o[0])(*map(stack, *o)) for o in zip(*out))

    run = _run_modes("path6", lambda: VOSystem(config, device=DEVICE), drive,
                     n // EXT_UNIT, EXT_UNIT)
    vo, g = run["graph"]["system"], run["graph"]
    cap = config.kp_capacity
    _say("path6", f"external corners, {n} frames {il.shape[1]}x"
                  f"{il.shape[2]} uint8 (corners per left image "
                  f"{min(len(c[0]) for c in corners)}-"
                  f"{max(len(c[0]) for c in corners)}), one "
                  f"track_with_external_corners call per frame, units of "
                  f"{EXT_UNIT}: status {vo.get_state().name}, map "
                  f"{vo.map_size} points")
    report = _report_modes("path6", run)
    _same_modes("path6", run)
    _say("path6", _check_ate("path6", g["poses"].t.cpu().numpy(), gt[:n]))
    _every_frame_tracking("path6", g["metrics"].status)
    _check_wrapper_counts("path6", run, n)

    args = (torch.stack([il[0], ir[0]]), *_padded_corners(corners[0], cap))
    got = describe_external_corners_batched(*args, config)
    want = describe_external_corners_batched(*(a.cpu() for a in args),
                                             config)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
        raise AssertionError("path6: frame 0's descriptors differ card vs "
                             "CPU")
    prof = _profiles("path6", run, drive, profile_dir)
    last = range((n // EXT_UNIT - 1) * EXT_UNIT, n // EXT_UNIT * EXT_UNIT)
    prof["host_launches"] = host_between_replays(
        "path6", lambda: [vo.track_with_external_corners(il[i], ir[i],
                                                         *corners[i])
                          for i in last], EXT_UNIT, 1, uploads=1)
    k = N_CPU_FRAMES["path6"]
    cpu = VOSystem(config, device="cpu")
    dt = max(float((cpu.track_with_external_corners(
        il[i].cpu(), ir[i].cpu(), *corners[i]).t - g["poses"].t[i].cpu())
        .abs().max()) for i in range(k))
    _say("path6", f"card vs CPU: frame 0's descriptors bit-equal "
                  f"({int(want.valid.sum())} valid of 2 x {cap}); poses of "
                  f"frames 0-{k - 1} differ by at most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"path6: CPU vs card pose difference {dt} m")

    def first_frames():
        one = VOSystem(config, device=DEVICE)
        for i in range(MS_STREAMS + 1):
            one.track_with_external_corners(il[i], ir[i], *corners[i])
        return MS_STREAMS + 1

    pnp_gaps = check_pnp_solve("path6", capture_pnp_inputs("path6",
                                                           first_frames))
    return dict(report, profile=prof, launches=prof["launches"],
                kernel_errs={"pnp_solve": pnp_gaps["max_abs_err"]})


# ---- path 7: the dataset CLIs on the card
def _sync_sites(fn):
    """``fn()``'s result and its host syncs under
    ``torch.cuda.set_sync_debug_mode("warn")``, counted by the function
    whose line made each: {function name or file:line: count}."""
    import inspect

    from lvt_tpu_torch import cli, observability

    sites = {}
    for f in (cli._track_sequence, observability._series_on_host):
        lines, start = inspect.getsourcelines(f)
        sites[f.__name__] = (inspect.getsourcefile(f),
                             range(start, start + len(lines)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = {}
    for w in caught:
        if "called a synchronizing CUDA operation" not in str(w.message):
            continue
        key = next((name for name, (path, lines) in sites.items()
                    if os.path.realpath(w.filename) == os.path.realpath(path)
                    and w.lineno in lines),
                   f"{os.path.basename(w.filename)}:{w.lineno}")
        counts[key] = counts.get(key, 0) + 1
    return out, counts


def _write_trees(root, kitti, euroc, tum) -> dict:
    """The three trees in the datasets' layouts, PNGs by ``write_png``:
    KITTI ``sequences/00/image_{0,1}/%06d.png``; EuRoC
    ``MH_01_easy/mav0/cam{0,1}/data/<ns>.png`` and a stamps file; TUM
    ``rgb/<s>.png``, ``depth/<s>.png`` (uint16, depth x 5000 rounded) and
    an association file, with path 4's config as YAML. Returns each tree's
    CLI arguments and the arrays written."""
    from lvt_tpu_torch.io.datasets import TUM_DEPTH_SCALE

    trees = {}
    il, ir, _ = kitti
    seq = os.path.join(root, "kitti", "sequences", "00")
    written = []
    for side, imgs in (("image_0", il), ("image_1", ir)):
        os.makedirs(os.path.join(seq, side))
        for i, img in enumerate(imgs):
            path = os.path.join(seq, side, f"{i:06d}.png")
            write_png(path, img)
            written.append((path, img))
    trees["kitti"] = dict(args=["kitti", "--sequences-dir", os.path.dirname(
        seq), "--seq", "0"], written=written)

    el, er, _ = euroc
    names = [str(CLI_STAMP0_NS + i * CLI_DT_NS) for i in range(len(el))]
    written = []
    for cam, imgs in (("cam0", el), ("cam1", er)):
        d = os.path.join(root, "euroc", "MH_01_easy", "mav0", cam, "data")
        os.makedirs(d)
        for name, img in zip(names, imgs):
            write_png(os.path.join(d, f"{name}.png"), img)
            written.append((os.path.join(d, f"{name}.png"), img))
    stamps = os.path.join(root, "euroc", "stamps.txt")
    with open(stamps, "w") as f:
        f.write("\n".join(names) + "\n")
    trees["euroc"] = dict(args=["euroc", "--root", os.path.join(
        root, "euroc"), "--dataset", "MH_01_easy", "--stamps", stamps],
        written=written)

    config4, gray, depth, _ = tum
    d = os.path.join(root, "tum", "rgbd_dataset_synthetic")
    os.makedirs(os.path.join(d, "rgb"))
    os.makedirs(os.path.join(d, "depth"))
    written, lines = [], []
    for i, (g, z) in enumerate(zip(gray, depth)):
        ts = f"{1305031102.175304 + i / 30:.6f}"
        z16 = np.rint(z / TUM_DEPTH_SCALE)
        if z16.max() > 65535:
            raise ValueError("path7-tum: depth past the format's 13.1 m")
        z16 = z16.astype(np.uint16)
        for kind, img in (("rgb", g), ("depth", z16)):
            path = os.path.join(d, kind, f"{ts}.png")
            write_png(path, img)
            written.append((path, img))
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    assoc = os.path.join(root, "tum", "associations.txt")
    with open(assoc, "w") as f:
        f.write("# timestamp rgb timestamp depth\n" + "\n".join(lines) + "\n")
    cfg = os.path.join(root, "tum", "rgbd.yaml")
    with open(cfg, "w") as f:
        for k in ("fx", "fy", "cx", "cy", "baseline", "img_width",
                  "img_height"):
            f.write(f"{k}: {getattr(config4, k)!r}\n")
    trees["tum"] = dict(args=["tum", "--dataset-dir", d, "--association",
                              assoc, "--config", cfg], written=written)
    return trees


def _cli_reference(name, tree, config_of):
    """The sequence reader of ``tree`` and the config and VOSystem its CLI
    builds, on the card: the in-process counterpart of one CLI run."""
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import SensorType, VOSystem
    from lvt_tpu_torch.io import datasets

    a = tree["args"]
    if name == "kitti":
        seq = datasets.KittiSequence(a[2], 0)
        config = seq.configure(load_config(config_of("kitti")))
        return seq, config, VOSystem(config, device=DEVICE)
    if name == "euroc":
        seq = datasets.EurocSequence(a[2], a[4], a[6])
        config = seq.configure(load_config(config_of("euroc")))
        return seq, config, VOSystem(config, rectify_maps=(seq.map_l,
                                                           seq.map_r),
                                     device=DEVICE)
    seq = datasets.TumRgbdSequence(a[2], a[4])
    config = load_config(a[6])
    return seq, config, VOSystem(config, SensorType.RGBD, device=DEVICE)


def _dump(name, path, poses, seq) -> None:
    from lvt_tpu_torch.io import datasets, trajectory

    if name == "kitti":
        trajectory.dump_kitti(path, poses)
    elif name == "euroc":
        trajectory.dump_tum(path, [datasets.euroc_body_pose(p)
                                   for p in poses], seq.stamps)
    else:
        trajectory.dump_tum(path, poses, seq.stamps)


def _tree_kernels(name, config, frames, vo):
    """check_path_kernels at the shapes frame 0 of the tree gives the
    kernels (frame 1 for T's second descriptor set)."""
    from lvt_tpu_torch.core import step
    from lvt_tpu_torch.core.extract import (extract_features_batched,
                                            extract_features_rgbd)

    (a0, b0), (a1, b1) = frames[0], frames[1]
    up = lambda x: torch.from_numpy(np.asarray(x)).to(DEVICE)  # noqa: E731
    path = f"path7-{name}"
    sites = T_SITES[path]
    if name == "tum":
        def feats(pairs, dev):
            fs = [extract_features_rgbd(torch.from_numpy(g).to(dev),
                                        torch.from_numpy(d).to(dev), config)
                  for g, d in pairs]
            return type(fs[0])(*(torch.stack(x) for x in zip(*fs)))

        s = t_site_inputs(config, feats([(a0, b0)], DEVICE),
                          feats([(a1, b1)], DEVICE))
        return check_path_kernels(path, config, up(a0)[None],
                                  lambda dev: feats([(a0, b0)], dev),
                                  {k: s[k] for k in sites})
    if name == "euroc":
        maps = [(m, m.cpu()) for m in vo.rectify_maps]
        imgs = torch.stack(step._rectify_pair(up(a0), up(b0),
                                              *(m for m, _ in maps)))
        cpu = torch.stack(step._rectify_pair(
            torch.from_numpy(a0), torch.from_numpy(b0),
            *(m for _, m in maps)))
        if not torch.equal(imgs.cpu(), cpu):
            raise AssertionError("path7-euroc: frame 0's remap differs card "
                                 "vs CPU")
        one = torch.stack(step._rectify_pair(up(a1), up(b1),
                                             *(m for m, _ in maps)))[:1]
        f0 = extract_features_batched(imgs, config)
        f1 = extract_features_batched(one, config)
        s = t_site_inputs(config, _streams(f0, [0]), f1, _streams(f0, [1]))
        return check_path_kernels(
            path, config, imgs,
            lambda dev: extract_features_batched(cpu.to(dev), config),
            {k: s[k] for k in sites})
    imgs = torch.stack([up(a0), up(b0)])
    f = extract_features_batched(torch.stack([up(a0), up(a1), up(b0)]),
                                 config)
    s = t_site_inputs(config, _streams(f, [0]), _streams(f, [1]),
                      _streams(f, [2]))
    return check_path_kernels(
        path, config, imgs,
        lambda dev: extract_features_batched(imgs.to(dev), config),
        {k: s[k] for k in sites})


def phase_cli(kitti, euroc, tum) -> dict:
    """Path 7: ``lvt_tpu_torch.cli.main`` (kitti, euroc, tum) on PNG trees
    written here, each run in-process on the card with ``--chunk 16
    --record``, against an in-process ``VOSystem.track_chunk`` over the
    decoded arrays. ``kitti``, ``euroc``: (left, right, positions);
    ``tum``: (config, gray, depth, positions)."""
    import shutil

    from lvt_tpu_torch import cli
    from lvt_tpu_torch.io import native_loader, trajectory
    from lvt_tpu_torch.observability import REFERENCE_SERIES
    from lvt_tpu_torch.parallel.dryrun import (device_launches,
                                               zero_kernel_counters)

    root = os.path.join(ROOT, "build", "chip_smoke_path7")
    shutil.rmtree(root, ignore_errors=True)
    lib = native_loader.build()
    built = native_loader.build_seconds
    _say("path7", f"PNG decoder {lib.name}: "
                  + (f"built in {built:.2f} s" if built is not None
                     else "built before this run"))
    t0 = time.perf_counter()
    trees = _write_trees(root, kitti, euroc, tum)
    _say("path7", f"trees written in {time.perf_counter() - t0:.2f} s")
    gts = {"kitti": kitti[2], "euroc": euroc[2], "tum": tum[3]}
    config_of = lambda n: os.path.join(cli.CONFIG_DIR, n,  # noqa: E731
                                       "vo_config.yaml")
    launches, kernel_errs, fps, configs = {}, {}, {}, {}
    frame_types, if_launches = None, 0
    for name, tree in trees.items():
        path = f"path7-{name}"
        t_decode = 0.0
        for file, img in tree["written"]:
            t0 = time.perf_counter()
            got = (native_loader.imread_native(file) if img.dtype == np.uint16
                   else native_loader.imread_gray_native(file))
            t_decode += time.perf_counter() - t0
            if got.dtype != img.dtype or not np.array_equal(got, img):
                raise AssertionError(f"{path}: {file} decodes other than "
                                     f"written")
        n = len(gts[name])
        out = os.path.join(root, name, "cli.txt")
        cwd = os.getcwd()
        os.chdir(os.path.join(root, name))   # --record writes here
        try:
            counters = zero_kernel_counters()

            def cli_run():
                t0 = time.perf_counter()
                got = _sync_sites(lambda: cli.main(
                    tree["args"] + ["--output", out, "--chunk", str(CHUNK),
                                    "--record"]))
                return got, time.perf_counter() - t0

            ((rc, syncs), t_cli), run_launches = device_launches(cli_run)
            calls = {k: fn.launches for k, fn in counters.items()}
            rows = open("measurments.txt").read().splitlines()
            titles = open("titles.txt").read().splitlines()
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise AssertionError(f"{path}: the CLI returned {rc}")
        n_chunks = -(-n // CHUNK)
        # by design the loop's one read per chunk (its statuses and poses,
        # cli._track_sequence) and the recorder's one transfer per chunk
        # (observability._series_on_host); nothing else syncs
        want = {"_track_sequence": n_chunks, "_series_on_host": n_chunks}
        _say(path, f"host syncs of the CLI run (set_sync_debug_mode warn) "
                   f"by site: {syncs}")
        if syncs != want:
            raise AssertionError(f"{path}: host syncs {syncs}, by design "
                                 f"{want}")
        if len(rows) != n or titles[:len(REFERENCE_SERIES)] != \
                REFERENCE_SERIES:
            raise AssertionError(f"{path}: measurments.txt has {len(rows)} "
                                 f"rows, titles.txt {titles[:3]}...")

        # in process: the sequence reader's decoded arrays, the same config
        # and chunks, VOSystem.track_chunk on the card
        t0 = time.perf_counter()
        seq, config, vo = _cli_reference(name, tree, config_of)
        t_setup = time.perf_counter() - t0
        configs[name] = config
        # one graph: the card ran its warm-up step (which computes BA) and
        # n replays (BA on its schedule); the wrappers were called at its
        # warm-up and capture
        chunks = -(-n // CHUNK)
        _check_launches(path, run_launches, n + 1,
                        1 + sum(_ba_frames(config, range(n))), chunks)
        _check_launches(path, calls, 2, chunks=chunks)
        frames = list(seq)
        t0 = time.perf_counter()
        poses, status = [], []
        for c in range(0, n, CHUNK):
            a = np.stack([f[0] for f in frames[c:c + CHUNK]])
            b = np.stack([f[1] for f in frames[c:c + CHUNK]])
            p, m = vo.track_chunk(a, b)
            poses += [type(p)(t, q) for t, q in zip(p.t.cpu(), p.q.cpu())]
            status.append(m.status)
        t_in = time.perf_counter() - t0
        ref = os.path.join(root, name, "in_process.txt")
        _dump(name, ref, poses, seq)
        same = open(out, "rb").read() == open(ref, "rb").read()
        _every_frame_tracking(path, torch.cat(status))
        if name == "kitti":
            # one IF-node predicate per replay; the warm-up step selects
            if run_launches["if_node"] != n:
                raise AssertionError(f"{path}: {run_launches['if_node']} "
                                     f"IF-node predicates in {n} replays")
            frame_types = _frame_types(
                path, config,
                lambda: _cli_reference(name, tree, config_of)[2],
                *(np.stack([f[k] for f in frames[:TRACED_FRAMES[1]]])
                  for k in (0, 1)))
        est = (trajectory.load_kitti(out)[:, :, 3] if name == "kitti"
               else trajectory.load_tum(out)[1])
        if est.shape != (n, 3):
            raise AssertionError(f"{path}: {est.shape[0]} rows, not {n}")
        if not same:
            raise AssertionError(f"{path}: the CLI's trajectory differs from "
                                 f"the in-process run's")
        err = trajectory.ate_rmse_aligned(est, gts[name])
        dist = float(np.linalg.norm(gts[name][-1] - gts[name][0]))
        if not err < 0.05 * dist:
            raise AssertionError(f"{path}: ATE {err:.4f} m is not under 5% "
                                 f"of {dist:.2f} m")
        fps[name] = (n / t_cli, n / t_in)
        _say(path, f"{n} frames {config.img_width}x{config.img_height}: "
                   f"trajectory byte-equal to the in-process run, every "
                   f"frame TRACKING, aligned ATE {err:.4f} m over "
                   f"{dist:.2f} m ({100 * err / dist:.3f}%), "
                   f"measurments.txt {len(rows)} rows")
        _say(path, f"{n / t_cli:.2f} frames/s end to end (the CLI, PNG "
                   f"decode included, under the kernel trace), "
                   f"{n / t_in:.2f} frames/s in process (track_chunk on the "
                   f"decoded arrays, upload included)")
        _say(path, f"apart: PNG decode {1e3 * t_decode / n:.2f} ms per frame "
                   f"({len(tree['written']) // n} PNGs), the reader's and "
                   f"VOSystem's set-up {t_setup:.3f} s (EuRoC: the two "
                   f"rectification maps)")
        _say(path, f"launches the card ran during the CLI run (kernel "
                   f"trace; the graph's warm-up step and {n} replays): "
                   f"{run_launches}; wrapper calls (the warm-up and the "
                   f"captured step) {calls}")
        for k in KERNELS:
            launches[k] = launches.get(k, 0) + run_launches[k]
        if_launches += run_launches["if_node"]
        errs = _tree_kernels(name, config, frames, vo)
        errs["pnp_solve"] = check_pnp_solve(path, capture_pnp_inputs(
            path, _first_frames(lambda: _cli_reference(name, tree,
                                                       config_of)[2],
                                [f[0] for f in frames],
                                [f[1] for f in frames])))["max_abs_err"]
        for k, v in errs.items():
            kernel_errs[k] = max(v, kernel_errs.get(k, 0.0))

    # the kitti CLI without --record: one host sync per chunk
    out = os.path.join(root, "kitti", "no_record.txt")
    _, syncs = _sync_sites(lambda: cli.main(
        trees["kitti"]["args"] + ["--output", out, "--chunk", str(CHUNK)]))
    n_chunks = -(-len(gts["kitti"]) // CHUNK)
    _say("path7-kitti", f"without --record: host syncs {syncs}")
    if syncs != {"_track_sequence": n_chunks}:
        raise AssertionError(f"path7-kitti: without --record, host syncs "
                             f"{syncs}")
    if open(out, "rb").read() != open(os.path.join(root, "kitti", "cli.txt"),
                                      "rb").read():
        raise AssertionError("path7-kitti: --record changed the trajectory")
    return dict(launches=launches, kernel_errs=kernel_errs, fps=fps,
                decoder_build_s=built, root=root, configs=configs,
                frame_types=frame_types, if_node_launches=if_launches)


STREAM_FRAMES = 16


# frames StreamingVO's worker tracks inside a trace after STREAM_FRAMES
STREAM_TRACED = 4


def phase_streaming(config, il, ir) -> dict:
    """Path 7's streaming shell: ``io.streaming.StreamingVO`` on the card
    with path 7 kitti's config (the shipped YAML: local BA, so its worker
    thread captures the IF node too) over STREAM_FRAMES frames of path 1
    fed from this thread, tracked in its worker thread (each frame a
    replay of the graph captured there): the VO pose of every frame
    (``vo.last_pose``, read in the odometry callback) bit-equal to
    ``VOSystem.track``'s on the same frames, no frame dropped, BA on its
    schedule in the reference; then STREAM_TRACED more frames in a trace,
    whose worker-thread launches ``host_between_replays`` holds."""
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.streaming import StreamingVO

    frames = [(il[i].cpu().numpy(), ir[i].cpu().numpy())
              for i in range(STREAM_FRAMES + STREAM_TRACED)]
    stream = StreamingVO(config, queue_size=STREAM_FRAMES, device=DEVICE)
    seen, traced_seen, tracing = [], [], [False]

    def on_odometry(odo):
        if tracing[0]:      # the traced frames: no device work here
            traced_seen.append(odo.frame_number)
        else:
            seen.append((odo.frame_number,
                         *(x.cpu() for x in stream.vo.last_pose)))

    def track(lo, hi, done):
        for i in range(lo, hi):
            stream.feed(float(i), *frames[i])
        deadline = time.monotonic() + 120
        while len(done) < hi - lo and time.monotonic() < deadline:
            time.sleep(0.01)

    def traced_frames():
        tracing[0] = True
        track(STREAM_FRAMES, STREAM_FRAMES + STREAM_TRACED, traced_seen)

    stream.on_odometry(on_odometry)
    t0 = time.perf_counter()
    stream.start()
    try:
        track(0, STREAM_FRAMES, seen)
        seconds = time.perf_counter() - t0
        # the worker thread's frames, a chunk of one each: the caller's two
        # uploads, the start, the replay; the shell's reads and pose kernel
        host = host_between_replays("path7-streaming", traced_frames,
                                    STREAM_TRACED, 1, uploads=2,
                                    caller_kernels=1)
    finally:
        stream.stop()
    vo = VOSystem(config, device=DEVICE)
    want, ba = [], []
    for a, b in frames[:STREAM_FRAMES]:
        want.append(vo.track(a, b))
        ba.append(bool(vo.last_metrics.local_ba_ran))
    runners = list(stream.vo.runners.values())
    equal = (len(seen) == STREAM_FRAMES
             and [x[0] for x in seen] == list(range(1, STREAM_FRAMES + 1))
             and all(torch.equal(t, w.t.cpu()) and torch.equal(q, w.q.cpu())
                     for (_, t, q), w in zip(seen, want)))
    _say("path7-streaming", f"StreamingVO on the card, {len(seen)} of "
                            f"{STREAM_FRAMES} frames tracked in its worker "
                            f"thread ({[r.mode for r in runners]}, "
                            f"{sum(r.replays for r in runners)} replays, "
                            f"dropped {stream.dropped_frames}) in "
                            f"{seconds:.2f} s: poses "
                            f"{'bit-equal' if equal else 'NOT equal'} to "
                            f"VOSystem.track's")
    if not equal or [r.mode for r in runners] != ["graph"]:
        raise AssertionError("path7-streaming: StreamingVO's poses differ "
                             "from VOSystem.track's, or it ran eagerly")
    if ba != _ba_frames(config, range(STREAM_FRAMES)) or not all(
            r.if_nodes for r in runners):
        raise AssertionError(f"path7-streaming: BA ran on frames "
                             f"{[i for i, x in enumerate(ba) if x]}, or the "
                             f"worker's graph holds no IF node")
    return dict(frames=len(seen), seconds=seconds, host_launches=host)


C_ABI_FRAMES = 8


def phase_c_abi(root, config, il, ir) -> dict:
    """The C ABI on the card: ``liblvt_c_torch.so`` and the C program
    ``lvt_tpu_torch/native/lvt_c_example.c`` built here (g++ and gcc, the
    embedded interpreter's flags from python3-config), run in a subprocess
    (``LVT_TPU_TORCH_DEVICE=cuda``) over the kitti tree's first
    C_ABI_FRAMES frames with the kitti CLI's config: the status 1 before,
    2 after every frame and 1 after ``lvt_reset``, and every pose equal as
    printed (``%.9g``) to an in-process ``track`` run on the card."""
    import dataclasses

    from lvt_tpu_torch import capi
    from lvt_tpu_torch.config import VOConfig, load_config
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.trajectory import pose_to_rt

    d = os.path.join(root, "c_abi")
    os.makedirs(d)
    cfg = os.path.join(d, "vo_config.yaml")
    default = VOConfig()
    with open(cfg, "w") as f:
        for k, v in dataclasses.asdict(config).items():
            if v != getattr(default, k):
                f.write(f"{k}: {int(v) if isinstance(v, bool) else v!r}\n")
    if load_config(cfg) != config:
        raise AssertionError("c_abi: the config's YAML loads otherwise")
    n, (h, w) = C_ABI_FRAMES, il.shape[1:]
    for i in range(n):
        with open(os.path.join(d, f"left_{i}.raw"), "wb") as f:
            f.write(il[i].tobytes())
        with open(os.path.join(d, f"right_{i}.raw"), "wb") as f:
            f.write(ir[i].tobytes())
    t0 = time.perf_counter()
    exe = capi.build_example(os.path.join(d, "lvt_c_example"))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), cfg, d, str(n), str(h), str(w)],
                          capture_output=True, text=True, timeout=600,
                          env=capi.example_env("cuda"))
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"c_abi: the C program exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    out = proc.stdout.splitlines()
    status = [int(x.split()[1]) for x in out if x.startswith("status")]
    if status != [1] + [2] * n + [1] or out[-1] != "done":
        raise AssertionError(f"c_abi: statuses {status}")
    vo = VOSystem(load_config(cfg), device=DEVICE)
    want = []
    for i in range(n):
        vo.track(il[i], ir[i])
        r, t = pose_to_rt(vo.last_pose)
        want.append("pose " + " ".join(f"{v:.9g}" for v in
                                       np.concatenate([r.reshape(-1), t])))
    got = [x for x in out if x.startswith("pose")]
    if got != want:
        raise AssertionError(f"c_abi: poses differ from the in-process card "
                             f"run:\n{got}\n{want}")
    _say("c_abi", f"liblvt_c_torch.so and the C program built in "
                  f"{build_s:.2f} s; {n} KITTI frames {w}x{h} through "
                  f"lvt_track on the card in a subprocess ({run_s:.2f} s, "
                  f"interpreter start and kernel load included): statuses "
                  f"{status} (1, then 2, 1 after lvt_reset), every pose "
                  f"equal at %.9g to the in-process card run")
    return dict(build_s=build_s, run_s=run_s)


# path 8: the sharded modes on torch.distributed, the ranks (processes)
# sharing the one card. 8a: ShardedStreamVO on one NCCL rank in this
# process; 8b: on SH_RANKS ranks; 8c: StreamPointVO on an SP_MESH mesh, 4
# ranks, stream i from frame SP_START_STEP * i; 8d: MultiStreamVO on a
# MD_RANKS-rank stream mesh with path 3's streams; then 8b at 2 ranks
# again on gloo CPU processes over SH_CPU_FRAMES frames
SH_FRAMES = 24
SH_CHUNK = 12
SH_RANKS = (2, 4)
SP_FRAMES = 16
SP_CHUNK = 8
SP_MESH = (2, 2)
SP_START_STEP = 2
MD_FRAMES = 16
MD_CHUNK = 8
MD_RANKS = 2
SH_CPU_FRAMES = 3
SH_TIMEOUT_S = 600
# sharded against unsharded: lvt_tpu's bound over lvt_tpu's horizon
# (tests/test_sharded_stream.py tracks 7 frames). Past it the runs drift
# apart: the sharded PnP's chi-square is a sum of per-rank float32
# partials, the unsharded one a float32 sum over the whole map in its own
# order, so LM accept tests at the rounding level go their own ways (BA
# amplifies it); and with path 7's config the map is at its 1024-point
# capacity from frame 0, where insertions partition over the ranks
# (sharded_stream.py's capacity caveat). The whole run's gap is printed.
SH_GAP_M = 3e-4
SH_HORIZON = 7


def sharded_config():
    """Path 8's config, the one path 7's kitti run loads: the shipped
    KITTI YAML (patch descriptors, local BA window 4 every 4 frames) with
    sequence 00's calibration at 1241x376."""
    from lvt_tpu_torch import configs
    from lvt_tpu_torch.config import load_config, load_kitti_calib

    calib = load_kitti_calib(os.path.join(configs.KITTI_DIR, "00.yaml"))
    return load_config(os.path.join(configs.KITTI_DIR, "vo_config.yaml"),
                       **calib, img_width=1241, img_height=376)


def collectives_per_frame(config) -> int:
    """All-reduces in one frame of the sharded step (the tests' count,
    tests/test_torch_sharded.py): map match 5, PnP 25, the un-mark OR 1,
    map sizes 3, the staged re-match 2, the metrics 8, the lost frame's
    map size 1; with local BA one per phase but the last, 3 + 2 per
    iteration (the gate's two moments, the first chi-square with the
    observation count, per iteration the sums and the trial chi-square)."""
    n = 45 - (2 if config.staged_threshold == 0 else 0)
    if config.local_ba_window > 0:
        n += 3 + 2 * config.local_ba_iterations
    return n


def _rank_launches(ranks) -> dict:
    """The launches the ranks made, summed: an eager run's wrapper counts
    (every frame), or where the ranks replayed a graph, the kernel trace
    of chunk 0 (its warm-up step and replays)."""
    key = "device_launches" if ranks[0]["modes"] == ["graph"] else "launches"
    return {k: sum(r[key][k] for r in ranks) for k in KERNELS}


def _fps(ranks, frames_per_rank) -> float:
    """Frames/s over the chunks after the first (the warm-up), the slowest
    rank's host time; ``frames_per_rank`` frames of one stream."""
    n_chunks = len(ranks[0]["chunk_seconds"])
    t = max(sum(r["chunk_seconds"][1:]) for r in ranks)
    return frames_per_rank * (n_chunks - 1) / n_chunks / t


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _check_rank_counts(path, ranks, n_frames, need_coll,
                       config=None) -> None:
    """Each rank's counts (``dryrun._chunks``): the wrappers' launches and
    the collectives' calls, per frame of an eager run or at a graph's
    warm-up and capture (twice NEED_PER_FRAME); where a graph ran, the
    kernels the card ran in chunk 0 (a kernel trace: NEED_PER_FRAME per
    frame and the warm-up step; with ``config``, whose local BA is an IF
    node of the graph, BA's phases on the warm-up and the BA frames by its
    schedule)."""
    r = ranks[0]
    _say(path, f"rank 0 ({r['modes'][0]}): the wrappers counted "
               f"{r['launches']}" + (
                   f"; the card ran {r['device_launches']} in chunk 0 "
                   f"({r['first_chunk']} frames; kernel trace)"
                   if r["modes"] == ["graph"] else ""))
    for rank, r in enumerate(ranks):
        graph = r["modes"] == ["graph"]
        steps = 2 if graph else n_frames
        _check_launches(path, r["launches"], steps,
                        chunks=len(r["chunk_seconds"]))
        if graph:
            ba = None if config is None else 1 + sum(
                _ba_frames(config, range(r["first_chunk"])))
            _check_launches(path, r["device_launches"], r["first_chunk"] + 1,
                            ba, chunks=1)
        if r["collectives"] != need_coll * steps:
            raise AssertionError(f"{path}: rank {rank} ran {r['collectives']}"
                                 f" collectives, not {need_coll} x {steps}")


# frames of 8a's eager step whose routed tracking ops are held against
# their plain group versions (check_group_ops): BA runs at frame 4
GROUP_FRAMES = 5


def _clone(x):
    """A copy of every tensor in ``x`` (tuples, named ones included, lists
    and dicts of tensors and other values), the rest as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _group_plain(name, args, kw):
    """The plain group version of a routed tracking op (core/track.py
    GROUP_OPS) on the arguments its wrapper took in the step."""
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.ops import top2

    if name == "predict_project":
        return track.predict_project_plain(*args[:6])
    if name == "upkeep_pre":
        store, staged = args[0], args[6]
        staged_pos, staged_valid = ((store.pos[:0], store.valid[:0])
                                    if staged is None
                                    else (staged.pos, staged.valid))
        return track.upkeep_pre_plain(*args[:6], staged_pos, staged_valid,
                                      *args[7:10])
    row_packed, match_idx, obs = args[:3]
    right_kp = args[4]
    if right_kp is None:
        right_kp = obs[:0]
        row_packed = (obs.new_zeros((2, 2, 0)),
                      match_idx.new_zeros((2, 2, 0)))
    return track.ba_observe_plain(
        top2._unpack(*row_packed)[1], match_idx, obs, args[3], right_kp,
        *args[5:], **{k: v for k, v in kw.items() if k != "group"})


def check_group_ops(path, make, a, b) -> dict:
    """The tracking ops that launch their kernels under a group
    (``track.GROUP_OPS``) against their plain group versions, on the
    arguments the sharded step gave their wrappers over GROUP_FRAMES eager
    frames of ``make()`` (a system on the current group): every output
    bit-equal (NaN for NaN), one call per frame. Returns the largest gap
    per op."""
    from lvt_tpu_torch.core import track
    from lvt_tpu_torch.core.graphs import disable_graphs

    calls = {name: [] for name in track.GROUP_OPS}
    real = {name: getattr(track, name) for name in track.GROUP_OPS}

    def recorder(name):
        def record(*args, **kw):
            calls[name].append((_clone(args), _clone(kw)))
            return real[name](*args, **kw)
        # the op adds its launches to the module's wrapper, this one while
        # it stands in for the real one
        record.launches = real[name].launches
        return record

    for name in calls:
        setattr(track, name, recorder(name))
    try:
        with disable_graphs():
            make().track_chunk(a[:GROUP_FRAMES], b[:GROUP_FRAMES])
    finally:
        for name, fn in real.items():
            fn.launches = getattr(track, name).launches
            setattr(track, name, fn)
    errs = {}
    for name, seen in calls.items():
        if len(seen) != GROUP_FRAMES:
            raise AssertionError(f"{path}: {len(seen)} calls of {name} in "
                                 f"{GROUP_FRAMES} frames")
        errs[name] = 0.0
        for args, kw in seen:
            errs[name] = max(errs[name], _require_equal_nan(
                f"{path} {name}", real[name](*args, **kw),
                _group_plain(name, args, kw)))
    _say(path, f"{', '.join(calls)} on the rank's block over "
               f"{GROUP_FRAMES} eager frames of the sharded step: bit-equal "
               f"(NaN for NaN) to their plain group versions, one call each "
               f"per frame")
    return errs


def _nccl_two_ranks() -> tuple[str, str]:
    """Whether NCCL takes 2 ranks on the one card: (backend for 8b-8d,
    NCCL's answer)."""
    from lvt_tpu_torch.parallel import dryrun

    try:
        dryrun.spawn([dryrun.job(dryrun.collectives_check, device=DEVICE)],
                     2, device=DEVICE, backend="nccl", timeout_s=180)
        return "nccl", "NCCL accepted 2 ranks on one card"
    except (RuntimeError, TimeoutError) as e:
        lines = [x.strip() for x in str(e).splitlines() if x.strip()]
        said = [x for x in lines if "Duplicate GPU" in x] or lines[-1:]
        return "gloo", f"NCCL refused 2 ranks on one card: {said[0][:300]}"


def phase_sharded(card, config, ms_config, il, ir, gt, ms_poses,
                  profile_dir=None) -> dict:
    """Path 8: the sharded modes on the card (see the module docstring)."""
    import tempfile

    import torch.distributed as dist

    from lvt_tpu_torch.core.extract import extract_features_batched
    from lvt_tpu_torch.core.state import TRACKING
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.io.synthetic import ate_rmse
    from lvt_tpu_torch.ops import top2
    from lvt_tpu_torch.parallel import dryrun, mesh as mesh_mod
    from lvt_tpu_torch.parallel.sharded_stream import ShardedStreamVO
    from lvt_tpu_torch.solver import pnp

    n, m = SH_FRAMES, config.max_map_points
    a, b = il[:n], ir[:n]
    need_coll = collectives_per_frame(config)
    marks = [("start", time.perf_counter())]

    # the unsharded reference on the card, in the same chunks
    vo = VOSystem(config, device=DEVICE)
    ref = [vo.track_chunk(a[c:c + CHUNK], b[c:c + CHUNK])
           for c in range(0, n, CHUNK)]
    ref_t = torch.cat([p.t for p, _ in ref]).cpu().numpy()
    ref_q = torch.cat([p.q for p, _ in ref]).cpu().numpy()
    ref_status = torch.cat([x.status for _, x in ref]).cpu().numpy()
    ref_sizes = torch.cat([x.map_points_count for _, x in ref]).cpu().numpy()
    ref_size = vo.map_size
    pnp_inputs = capture_pnp_inputs("path8", _first_frames(
        lambda: VOSystem(config, device=DEVICE), il, ir))

    # ---- 8a: one rank on NCCL, in this process, graph and eager
    runs = {}
    chunk, n_units = RUNS["path8a"]
    drive = _chunks_of(a, b, chunk)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_mod.init("nccl", 1, 0, "file://" + os.path.join(tmp, "rdv"),
                      device=DEVICE)
        try:
            run = _run_modes("path8a",
                             lambda: ShardedStreamVO(config, device=DEVICE),
                             drive, n_units, chunk)
            svo = run["graph"]["system"]
            map_size, backend8a = svo.map_size, dist.get_backend(svo.group)
            report = _report_modes("path8a", run)
            _same_modes("path8a", run)
            prof = _profiles("path8a", run, drive, profile_dir,
                             config=config)
            # local BA's phases and their all-reduces (3 + 2 per
            # iteration) run inside the IF node, on BA frames only
            prof["frame_types"] = _frame_types(
                "path8a", config,
                lambda: ShardedStreamVO(config, device=DEVICE), a, b)
            group_errs = check_group_ops(
                "path8a", lambda: ShardedStreamVO(config, device=DEVICE), a,
                b)
        finally:
            dist.destroy_process_group()
    g = run["graph"]
    equal = (torch.equal(g["poses"].t.cpu(), torch.from_numpy(ref_t))
             and torch.equal(g["poses"].q.cpu(), torch.from_numpy(ref_q))
             and np.array_equal(g["metrics"].status.cpu().numpy(),
                                ref_status)
             and np.array_equal(g["metrics"].map_points_count.cpu().numpy(),
                                ref_sizes)
             and map_size == ref_size)
    _say("path8a", f"ShardedStreamVO on 1 rank ({backend8a}), {n} "
                   f"frames {a.shape[2]}x{a.shape[1]} uint8 in chunks of "
                   f"{chunk}, the shipped KITTI YAML (BA window "
                   f"{config.local_ba_window}), its NCCL all-reduces inside "
                   f"the graph: poses, statuses and map sizes "
                   f"{'bit-equal' if equal else 'NOT equal'} to VOSystem on "
                   f"the card (map {map_size} points)")
    coll = {m: run[m]["collectives"] for m in MODES}
    _say("path8a", f"collective calls: eager {coll['eager']} "
                   f"({coll['eager'] / n:g} per frame); graph "
                   f"{coll['graph']}, at the warm-up and the capture of "
                   f"{run['graphs']} graph(s) ({need_coll} per step, "
                   f"recorded once per replay; not counted per replay); "
                   f"NCCL kernels the card ran in the profiled graphed unit "
                   f"(kernel trace): {prof['nccl']} in {chunk} frames")
    if not equal:
        raise AssertionError(f"path8a: one rank differs from VOSystem (pose "
                             f"gap {_gap(g['poses'].t.cpu(), ref_t)} m)")
    _check_wrapper_counts("path8a", run, n)
    if coll != dict(eager=need_coll * n, graph=need_coll * 2 * run["graphs"]):
        raise AssertionError(f"path8a: collective calls {coll}, not "
                             f"{need_coll} per frame and per captured step")
    runs["path8a"] = dict(report, profile=prof, launches=prof["launches"],
                          if_node_launches=prof["if_node"],
                          collectives_per_frame=need_coll)
    marks.append(("reference and 8a", time.perf_counter()))

    # ---- the kernels at the shard shapes: T at map and staged with M / n
    # rows (row and BA row keep the replicated features' shapes), A and P
    # on the replicated pair; PnP at M / n points: the fused solve and the
    # phases each rank launches, and the plain version's two ops
    f = extract_features_batched(torch.cat([a[:2], b[:1]]), config)
    imgs = torch.stack([a[0], b[0]])
    kernel_errs, shard_t, shard_pnp, shard_solve = {}, {}, {}, {}
    for k in SH_RANKS:
        cfg = config.replace(max_map_points=m // k,
                             max_staged_points=config.max_staged_points // k)
        sites = t_site_inputs(cfg, _streams(f, [0]), _streams(f, [1]),
                              _streams(f, [2]))
        errs = check_path_kernels(
            f"path8-{k}", cfg, imgs,
            lambda dev: extract_features_batched(imgs.to(dev), config),
            {s: sites[s] for s in ("map", "staged")})
        for name, v in errs.items():
            kernel_errs[name] = max(v, kernel_errs.get(name, 0.0))
        args, kw = sites["map"]
        args = tuple(x[0] for x in args)
        nbytes, ops = t_work(args, kw, top2.hamming_top2_plain(*args, **kw))
        shard_t[m // k] = _measure(
            card, f"hamming_top2 map {m // k}",
            lambda args=args, kw=kw: top2.hamming_top2(*args, **kw),
            lambda args=args, kw=kw: top2.hamming_top2_plain(*args, **kw),
            nbytes, ops)
        shard_t[m // k].update(m=m // k, k=args[1].shape[0])
        shard = dict(cam=pnp_inputs["cam"], args=(
            *pnp_inputs["args"][:2],
            *(x[:, :m // k].contiguous() for x in pnp_inputs["args"][2:])))
        shard_solve[m // k] = measure_pnp_solve(card, f"path8-{k}", shard)
        shard_pnp[m // k] = measure_pnp(card, f"path8 M={m // k}",
                                        old_op_inputs(shard))
        t_rep, p_rep = shard_t[m // k], shard_pnp[m // k]["pnp_normal_eqs"]
        _say(f"path8-{k}", f"at M = {m // k}: hamming_top2 map "
                           f"{t_rep['ms']:.4f} ms (bound "
                           f"{t_rep['bound_ms']:.4f}, plain "
                           f"{t_rep['plain_ms']:.4f}); pnp_normal_eqs "
                           f"{p_rep['ms']:.4f} ms; stream_sum "
                           f"{shard_pnp[m // k]['stream_sum']['ms']:.4f} ms")
        for name in ("pnp_solve", "pnp_phase"):
            kernel_errs[name] = max(shard_solve[m // k]["max_abs_err"],
                                    kernel_errs.get(name, 0.0))
        for name in ("pnp_normal_eqs", "stream_sum"):
            kernel_errs[name] = max(shard_pnp[m // k][name]["max_abs_err"],
                                    kernel_errs.get(name, 0.0))

    marks.append(("kernels at the shard shapes", time.perf_counter()))

    # ---- 8b-8d: several ranks sharing the card
    backend, nccl_said = _nccl_two_ranks()
    marks.append(("NCCL's answer", time.perf_counter()))
    _say("path8b", f"{nccl_said}; the collectives of 8b-8d ride {backend}"
                   + (" with CUDA tensors, staged through the host"
                      if backend == "gloo" else ""))
    starts = [MS_START_STEP * i for i in range(MS_STREAMS)]
    md = tuple(torch.stack([x[k:k + MD_FRAMES] for k in starts], 1)
               .cpu().numpy() for x in (il, ir))
    sp = tuple(torch.stack([x[SP_START_STEP * i:SP_START_STEP * i
                              + SP_FRAMES] for i in range(SP_MESH[0])], 1)
               .cpu().numpy() for x in (il, ir))
    host = a.cpu().numpy(), b.cpu().numpy()
    secs = {k: [] for k in ("2 ranks", "4 ranks", "2 CPU ranks")}
    # the ranks read their frames from files (dryrun.SavedArray), not from
    # their pickled jobs
    with tempfile.TemporaryDirectory() as tmp:
        saved = {name: tuple(dryrun.SavedArray.save(x, tmp, f"{name}{i}")
                             for i, x in enumerate(arrays))
                 for name, arrays in (("host", host), ("md", md),
                                      ("sp", sp))}
        sharded_job = dryrun.job(dryrun.sharded_stream, config,
                                 *saved["host"], chunk=SH_CHUNK,
                                 device=DEVICE)
        results = {
            2: dryrun.spawn([sharded_job, dryrun.job(
                dryrun.multistream, ms_config, *saved["md"], chunk=MD_CHUNK,
                device=DEVICE)], 2, device=DEVICE, backend=backend,
                timeout_s=SH_TIMEOUT_S, seconds=secs["2 ranks"]),
        }
        marks.append(("2 ranks (8b, 8d)", time.perf_counter()))
        results[4] = dryrun.spawn([sharded_job, dryrun.job(
            dryrun.stream_point, config, *saved["sp"], n_stream=SP_MESH[0],
            n_point=SP_MESH[1], chunk=SP_CHUNK, device=DEVICE)], 4,
            device=DEVICE, backend=backend, timeout_s=SH_TIMEOUT_S,
            seconds=secs["4 ranks"])
        marks.append(("4 ranks (8b, 8c)", time.perf_counter()))
    card_2 = None
    h = SH_HORIZON
    for k in SH_RANKS:
        path = f"path8b-{k}"
        ranks = [res[0] for res in results[k]]
        t = ranks[0]["poses"][0]
        sizes = ranks[0]["metrics"].map_points_count
        gap, gap_h = _gap(t, ref_t), _gap(t[:h], ref_t[:h])
        size_gaps = {i: int(s - g) for i, (s, g) in
                     enumerate(zip(sizes, ref_sizes)) if s != g}
        err = ate_rmse(t, gt[:n])
        dist = float(np.linalg.norm(gt[n - 1] - gt[0]))
        fps = _fps(ranks, n)
        _say(path, f"ShardedStreamVO on {k} ranks sharing the card "
                   f"({ranks[0]['backend']}), {n} frames: every frame "
                   f"{'TRACKING' if all((x['metrics'].status == TRACKING).all() for x in ranks) else 'NOT all TRACKING'}; "
                   f"largest pose gap to the unsharded run over frames "
                   f"0-{h - 1} {gap_h:.3g} m (bound {SH_GAP_M}), over all "
                   f"{n} {gap:.3g} m; ATE {100 * err / dist:.3f}% of "
                   f"{dist:.2f} m; map {ranks[0]['map_size']} points at the "
                   f"end (unsharded {ref_size}); per-frame map size gaps "
                   f"(sharded - unsharded, at each frame's start) "
                   f"{size_gaps or 'none'}")
        syncs = ("not counted (gloo syncs in its own threads, staging "
                 "each collective through the host)" if backend == "gloo"
                 else [x["syncs"] for x in ranks])
        _say(path, f"runs {ranks[0]['modes']} on {ranks[0]['backend']} (a "
                   f"graph needs NCCL: gloo syncs the host in its own "
                   f"threads)")
        want = ["eager"] if backend == "gloo" else ["graph"]
        if any(x["modes"] != want for x in ranks):
            raise AssertionError(f"{path}: ranks ran {ranks[0]['modes']} "
                                 f"on {backend}, not {want}")
        _say(path, f"valid points per rank {[x['local_valid'] for x in ranks]}"
                   f" (blocks of {ranks[0]['block']}); host syncs in one "
                   f"chunk per rank: {syncs}; collectives "
                   f"{ranks[0]['collectives'] / n:g} per frame; {fps:.2f} "
                   f"frames/s (one stream, {k} ranks)")
        for rank, x in enumerate(ranks):
            if not (x["metrics"].status == TRACKING).all():
                raise AssertionError(f"{path}: rank {rank} lost track")
            if not (np.array_equal(x["poses"][0], t)
                    and np.array_equal(x["poses"][1], ranks[0]["poses"][1])):
                raise AssertionError(f"{path}: rank {rank}'s poses differ "
                                     f"from rank 0's")
            if x["block"] != m // k or not x["local_valid"] <= m // k:
                raise AssertionError(f"{path}: rank {rank} holds "
                                     f"{x['local_valid']} of {x['block']}")
        # the map after frame h - 1 is the size at frame h's start
        if any(i <= h for i in size_gaps):
            raise AssertionError(f"{path}: map sizes differ from the "
                                 f"unsharded run's within frames 0-{h - 1}: "
                                 f"{size_gaps}")
        if not gap_h < SH_GAP_M:
            raise AssertionError(f"{path}: poses {gap_h} m from the unsharded "
                                 f"run within frames 0-{h - 1}, not under "
                                 f"{SH_GAP_M} m")
        if not err < 0.05 * dist:
            raise AssertionError(f"{path}: ATE {err:.4f} m is not under 5% "
                                 f"of {dist:.2f} m")
        _check_rank_counts(path, ranks, n, need_coll, config)
        runs[path] = dict(launches=_rank_launches(ranks), fps=fps, gap=gap_h,
                          gap_all=gap, ate_pct=100 * err / dist,
                          size_gaps=size_gaps, backend=ranks[0]["backend"],
                          mode=ranks[0]["modes"][0])
        if k == 2:
            card_2 = t

    # 8c: StreamPointVO, each stream against VOSystem on its frames
    ranks = [res[1] for res in results[4]]
    refs = [ref_t[:SP_FRAMES]]
    for i in range(1, SP_MESH[0]):
        one = VOSystem(config, device=DEVICE)
        p, _ = one.track_chunk(torch.from_numpy(sp[0][:, i]),
                               torch.from_numpy(sp[1][:, i]))
        refs.append(p.t.cpu().numpy())
    gaps, gaps_all = [], []
    for rank, x in enumerate(ranks):
        (s,) = x["local_streams"]
        gaps.append(_gap(x["poses"][0][:h, 0], refs[s][:h]))
        gaps_all.append(_gap(x["poses"][0][:, 0], refs[s]))
        if not (x["metrics"].status == TRACKING).all():
            raise AssertionError(f"path8c: rank {rank} (stream {s}) lost "
                                 f"track")
        if x["fallback_warnings"]:
            raise AssertionError(f"path8c: vmap fell back: "
                                 f"{x['fallback_warnings'][:2]}")
    fps = _fps(ranks, SP_FRAMES) * SP_MESH[0]
    _say("path8c", f"StreamPointVO {SP_MESH[0]} streams x {SP_MESH[1]} point "
                   f"shards on 4 ranks, {ranks[0]['modes']} on "
                   f"{ranks[0]['backend']}, {SP_FRAMES} frames in chunks of "
                   f"{SP_CHUNK} (stream i from "
                   f"frame {SP_START_STEP} i): every frame TRACKING, no vmap "
                   f"fallback; gaps to each stream's VOSystem on the card by "
                   f"rank over frames 0-{h - 1} {[f'{g:.3g}' for g in gaps]} "
                   f"m (bound {SH_GAP_M}), over all {SP_FRAMES} "
                   f"{[f'{g:.3g}' for g in gaps_all]} m; "
                   f"collectives {ranks[0]['collectives'] / SP_FRAMES:g} per "
                   f"frame; {fps:.2f} frames/s aggregate")
    if not max(gaps) < SH_GAP_M:
        raise AssertionError(f"path8c: streams {gaps} m from VOSystem")
    _check_rank_counts("path8c", ranks, SP_FRAMES, need_coll)
    runs["path8c"] = dict(launches=_rank_launches(ranks), fps=fps,
                          gap=max(gaps), gap_all=max(gaps_all),
                          mode=ranks[0]["modes"][0])

    # 8d: MultiStreamVO over a stream mesh against path 3's one process
    ranks = [res[1] for res in results[2]]
    equal = []
    for x in ranks:
        cols = x["local_streams"]
        equal.append(np.array_equal(x["poses"][0], ms_poses[0][:, cols])
                     and np.array_equal(x["poses"][1], ms_poses[1][:, cols]))
    fps = _fps(ranks, MD_FRAMES) * MS_STREAMS
    _say("path8d", f"MultiStreamVO on a {MD_RANKS}-rank stream mesh, "
                   f"{ranks[0]['modes']} on {backend} (no "
                   f"collective in the step), {MS_STREAMS} streams "
                   f"({[x['local_streams'] for x in ranks]}), {MD_FRAMES} "
                   f"frames in chunks of {MD_CHUNK}: each rank's streams "
                   f"{'bit-equal' if all(equal) else 'NOT equal'} to path "
                   f"3's one-process run (graph, itself bit-equal to its "
                   f"eager run); collectives {ranks[0]['collectives']}; "
                   f"{fps:.2f} frames/s aggregate")
    if not all(equal):
        raise AssertionError(f"path8d: streams differ from path 3's: {equal}")
    if any(x["modes"] != ["graph"] for x in ranks):
        raise AssertionError("path8d: the stream mesh's ranks ran eagerly")
    _check_rank_counts("path8d", ranks, MD_FRAMES, 0)
    runs["path8d"] = dict(launches=_rank_launches(ranks), fps=fps,
                          mode=ranks[0]["modes"][0])

    # card against CPU: 8b at 2 ranks over the first frames, on gloo CPU
    # processes
    k = SH_CPU_FRAMES
    cpu = dryrun.spawn([dryrun.job(dryrun.sharded_stream, config,
                                   host[0][:k], host[1][:k], chunk=k)], 2,
                       timeout_s=SH_TIMEOUT_S, seconds=secs["2 CPU ranks"])
    dt = _gap(cpu[0][0]["poses"][0], card_2[:k])
    _say("path8b-2", f"card vs CPU (2 gloo CPU ranks), frames 0-{k - 1}: "
                     f"poses differ by at most {dt:.3g} m")
    if not dt < 1e-3:
        raise AssertionError(f"path8b-2: CPU vs card {dt} m >= 1e-3 m")
    marks.append(("2 CPU ranks", time.perf_counter()))
    _say("path8", "seconds by part (spawned ranks' start-up included): "
                  + ", ".join(f"{name} {t - marks[i][1]:.1f}" for i, (name, t)
                              in enumerate(marks[1:])))
    # where a spawned run's seconds go, per rank: the start-up (the
    # interpreter, the imports, unpickling the jobs), the process group,
    # the kernels' library with the CUDA context, and each job (the
    # frames, their gloo collectives, a job's own set-up)
    _say("path8", "seconds per rank of each spawned run (start-up, group, "
                  "library, jobs): " + "; ".join(
                      f"{name}: " + ", ".join(
                          f"{r['start']:.1f} / {r['group']:.1f} / "
                          f"{r.get('library', 0.0):.1f} / "
                          + " + ".join(f"{j:.1f}" for j in r["jobs"])
                          for r in rs)
                      for name, rs in secs.items()))
    for r in runs.values():
        r["kernel_errs"] = {}
    runs["path8a"]["kernel_errs"] = dict(kernel_errs, **group_errs)
    return dict(runs=runs, shard_t=shard_t, shard_pnp=shard_pnp,
                shard_solve=shard_solve,
                backend=backend, nccl=nccl_said)


STAGES = ("rectify", "perception", "corner_select", "patch_describe",
          "corner_select_describe", "motion_predict", "map_matching",
          "pnp_solve", "map_bookkeeping", "staged_update", "triangulation",
          "local_ba", "step_tail")


def _device_us(e) -> float:
    dev = getattr(e, "device_time_total", None)
    return e.cuda_time_total if dev is None else dev


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _say_busy(path, prof, frame="frame") -> None:
    """The profiled unit's device busy time per frame and its share of the
    span from its first kernel's start to its last kernel's end, both from
    the same trace."""
    busy, span = prof["busy_ms_per_frame"], prof["span_ms_per_frame"]
    _say(path, f"device busy {busy:.3f} ms per {frame} of a {span:.3f} ms "
               f"span (first kernel start to last kernel end, the same "
               f"trace): {100 * busy / span:.1f}%")


def _profile(run, n, out_dir=None, host=False) -> dict:
    """torch.profiler over ``run()``, one unit of ``n`` frames: each
    hand-written kernel's launches (local BA's kernel's by its own count)
    and mean device time per launch; the
    device kernels per frame (a graph's too: the trace lists the kernels a
    replay launches); the device's busy time, the sum of all kernel and
    copy times, and its span, from the first kernel's start to the last
    one's end; the NCCL kernels; the trace's opening markers that it kept.
    The trace is the device's only (``dryrun.traced``; read from Kineto's
    records, ``dryrun.device_records``), unless ``host``: then also the
    host's, and per stage (the profiler ranges of core/step.py and
    extract.py, which fire in an eager step and not in a replay) the host
    time and the device time of the torch ops' kernels inside it (the
    hand-written kernels, launched through ctypes, are listed on their
    own); tracing the host slows it. With ``out_dir`` and ``host``, the op
    table is written there."""
    from lvt_tpu_torch.parallel.dryrun import (BA_KERNELS, IF_NODE_SYMBOL,
                                               KERNEL_SYMBOLS, TRACE_MARKERS,
                                               ba_launches, device_records,
                                               traced)

    ba0 = ba_launches()
    _, prof = traced(run, host=host)
    n_ba = {k: v - ba0[k] for k, v in ba_launches().items()}
    records = [r for r in device_records(prof) if r[0] not in STAGES]
    n_markers = sum("spin_kernel" in name for name, _, _ in records)
    records = [r for r in records if "spin_kernel" not in r[0]]
    lines, stages = [], {}
    if host:
        events = prof.key_averages()
        kernels_in, busy_in = _stage_kernels(prof, records)
        lines.append(f"{'stage':<22} {'host ms/frame':>14} "
                     f"{'device ms/frame':>16} {'kernels/frame':>14} "
                     f"{'span busy ms/frame':>19}")
        for e in events:
            # a range is listed twice: on the host, and as its span on the
            # device's timeline (idle gaps included), which is left out
            if e.key in STAGES and not _on_device(e):
                stages[e.key] = dict(
                    host_ms=e.cpu_time_total / 1e3 / n,
                    device_ms=_device_us(e) / 1e3 / n,
                    kernels=(kernels_in[e.key] / n if kernels_in else None),
                    span_busy_ms=(busy_in[e.key] / 1e6 / n if kernels_in
                                  else None))
                k_col = ("not measured" if not kernels_in
                         else f"{stages[e.key]['kernels']:.1f}")
                b_col = ("not measured" if not kernels_in
                         else f"{stages[e.key]['span_busy_ms']:.4f}")
                lines.append(f"{e.key:<22} "
                             f"{stages[e.key]['host_ms']:>14.3f} "
                             f"{stages[e.key]['device_ms']:>16.3f} "
                             f"{k_col:>14} {b_col:>19}")
    kernels = {}
    for name, sym in KERNEL_SYMBOLS.items():
        mine = [end - start for key, start, end in records if sym in key]
        if mine:
            kernels[name] = dict(launches=len(mine),
                                 device_ms=sum(mine) / 1e6 / len(mine))
            lines.append(f"kernel {name:<15} {len(mine):>5} launches, "
                         f"{kernels[name]['device_ms']:.4f} ms each "
                         f"(profiler device time)")
    # local BA's kernels run in an IF node's body, whose records a trace
    # can lose: their launches are their own counts (dryrun.ba_launches)
    for k in BA_KERNELS:
        if n_ba[k] or k in kernels:
            kernels.setdefault(k, dict(device_ms=None))["launches"] = n_ba[k]
    busy = sum(end - start for _, start, end in records) / 1e6
    span = (max(end for _, _, end in records)
            - min(start for _, start, _ in records)) / 1e6
    n_kernels = sum(not name.startswith(("Memcpy", "Memset"))
                    for name, _, _ in records)
    n_nccl = sum("nccl" in name.lower() for name, _, _ in records)
    n_if = sum(IF_NODE_SYMBOL in name for name, _, _ in records)
    lines.append(f"device busy {busy:.2f} ms in {n} frames "
                 f"({busy / n:.3f} ms per frame, the sum of kernel and "
                 f"copy times) of a {span:.2f} ms span; {n_kernels / n:.1f} "
                 f"kernels per frame; the trace kept {n_markers} of its "
                 f"{TRACE_MARKERS} opening markers")
    if out_dir and host:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
            f.write("\n".join(lines) + "\n\n")
            f.write(events.table(sort_by="cuda_time_total", row_limit=40))
        _say("profile", f"op table of one unit written to {out_dir}")
    for line in lines:
        _say("profile", line)
    return dict(kernels, busy_ms_per_frame=busy / n,
                span_ms_per_frame=span / n, kernels_per_frame=n_kernels / n,
                nccl=n_nccl, if_node=n_if, markers=n_markers, stages=stages)


def _stage_kernels(prof, records) -> tuple[Counter, Counter]:
    """Device kernels (copies and fills left out) per stage of a traced
    eager step: those that start inside the stage's span on the device's
    timeline (the profiler's GPU user annotation of each range; an eager
    step runs on one stream, so a stage's kernels lie inside its span);
    and the device time (ns) of every record, kernels, copies and fills,
    that starts there. Empty where the trace holds no such spans."""
    import bisect

    from torch.autograd import DeviceType

    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and getattr(e, "is_user_annotation", lambda: False)()
             and e.name() in STAGES]
    starts = sorted(start for key, start, _ in records
                    if not key.startswith(("Memcpy", "Memset")))
    timed = sorted((start, end - start) for _, start, end in records)
    out, busy = Counter(), Counter()
    for name, start, end in spans:
        out[name] += (bisect.bisect_left(starts, end)
                      - bisect.bisect_left(starts, start))
        lo = bisect.bisect_left(timed, (start,))
        hi = bisect.bisect_left(timed, (end,))
        busy[name] += sum(d for _, d in timed[lo:hi])
    return out, busy


def _profiles(path, run, drive, profile_dir=None, frame="frame",
              config=None) -> dict:
    """One more unit of the graph system (its last unit's frames again)
    under the profiler: its device busy share, its kernels per frame and
    the launches of each hand-written kernel that the card ran, which must
    be NEED_PER_FRAME per frame, and on BA_KERNEL_PATHS local BA's kernel
    once per BA frame of the unit by ``config``'s schedule (returned as
    ``launches``). With
    ``profile_dir`` also one unit of the eager system, whose stage table
    the profiler ranges give."""
    from lvt_tpu_torch.core.graphs import disable_graphs

    n, last = run["unit_frames"], len(run["graph"]["times"]) + 1
    ba = None
    if config is not None:
        start = int(run["graph"]["system"].state.frame_number)
        ba = sum(_ba_frames(config, range(start, start + n)))
    _say(path, "profile of one graphed unit:")
    prof = _profile(lambda: drive(run["graph"]["system"], last), n)
    _say_busy(path, prof, frame)
    got = {k: prof.get(k, {}).get("launches", 0) for k in KERNELS}
    _say(path, f"launches the card ran in the profiled graphed unit ({n} "
               f"frames, kernel trace): {got}; "
               f"{prof['kernels_per_frame']:.1f} device kernels per {frame}")
    _check_launches(path, got, n, ba, chunks=CHUNKS_PER_UNIT.get(path, 1))
    # one IF-node predicate per replay of a graph holding the node
    nodes = sum(len(r._branches) for r in run["graph"]["system"]
                .runners.values())
    _say(path, f"IF-node predicates the card ran in the profiled graphed "
               f"unit: {prof['if_node']} ({nodes} node(s) in the graph)")
    if prof["if_node"] != n * nodes:
        raise AssertionError(f"{path}: {prof['if_node']} IF-node predicates "
                             f"in {n} replays of a graph with {nodes} nodes")
    prof["launches"] = got
    if profile_dir:
        _say(path, "profile of one eager unit (stage table):")
        with disable_graphs():
            eager = _profile(lambda: drive(run["eager"]["system"], last), n,
                             os.path.join(profile_dir, path), host=True)
        _say_busy(path, eager, frame)
        prof["eager"] = eager
    return prof


def measure_if_node(card, config, il, ir) -> dict:
    """The IF node (core/graphs.py::cond, csrc/graph_cond.cu) at path 2's
    shapes: local BA's body on the inputs frame 1 of a new eager system
    gave it, in two graphs of one step ``map = cond(pred, BA, map)``, one
    with the IF node (the runner of a single-process step) and one with
    the select it replaces (the same step as a vmapped runner captures
    it: BA computed and selected, the plain version). Each is replayed
    with the predicate set (a BA frame) and not (any other frame): the
    node's result bit-equal to the select's both ways; each graph timed
    as the mean of IF_REPS back-to-back replays, both ways. The bound is
    a frame without BA's: the predicate read, the map copied."""
    from lvt_tpu_torch.core import graphs, step
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.geometry.se3 import Pose

    seen, real = [], step._refine_structure

    def record(*args):
        seen.append(args)
        return real(*args)

    step._refine_structure = record
    try:
        with graphs.disable_graphs():
            VOSystem(config, device=DEVICE).track_chunk(il[:2], ir[:2])
    finally:
        step._refine_structure = real
    args = seen[-1]
    pos = args[1]

    def step_fn(state, pred):
        new = graphs.cond(pred, lambda: real(*args), state.t)
        return state._replace(t=new), new, new

    out, ms, body = {}, {}, None
    for form, batched in (("node", False), ("select", True)):
        state = Pose(pos.clone(), torch.zeros(4, device=DEVICE))
        runner = graphs.StepGraph(
            step_fn, state, [torch.zeros((), dtype=torch.bool,
                                         device=DEVICE)], batched=batched,
            outputs=(pos, pos))
        for pred in (True, False):
            state.t.copy_(pos)
            got, _ = runner.run(torch.tensor([pred], device=DEVICE))
            out[form, pred] = got[0].clone()
            runner.inputs[0].fill_(pred)
            ms[form, pred] = device_ms(runner._graph.replay, IF_REPS)
        if len(runner._branches) != (0 if batched else 1):
            raise AssertionError(f"if_node: the {form} graph holds "
                                 f"{len(runner._branches)} IF nodes")
        if not batched:
            body = _body_kernels(runner)
    err = max(_require_equal(f"if_node ({'BA' if p else 'other'} frame)",
                             out["node", p], out["select", p])
              for p in (True, False))
    nbytes = 1 + 2 * pos.numel() * pos.element_size()
    b_ms, b_by = bound(card, nbytes, {})
    _say("if_node", f"local BA under cond at path 2's shapes (M = "
                    f"{pos.shape[0]}): the IF node's graph bit-equal to the "
                    f"select's, a BA frame and another; replay ms, node / "
                    f"select: other frame {ms['node', False]:.4f} / "
                    f"{ms['select', False]:.4f}, BA frame "
                    f"{ms['node', True]:.4f} / {ms['select', True]:.4f} "
                    f"(bound of the other frame {b_ms:.2e} ms, {b_by}); the "
                    f"node's body holds {body} kernel, copy and fill nodes")
    return dict(max_abs_err=err, ms=ms["node", False],
                plain_ms=ms["select", False], ms_ba_frame=ms["node", True],
                plain_ms_ba_frame=ms["select", True], bound_ms=b_ms,
                bound_by=b_by, library_ms=None, body_nodes=body)


def _ba_frames(config, frames) -> list:
    """Whether local BA runs at each frame number of ``frames`` in a
    system that tracked every frame from 0: once the window is full, every
    ``local_ba_every`` frames (frame 0 initializes and fills no window)."""
    w, every = config.local_ba_window, config.local_ba_every
    return [w > 0 and f >= w and f % every == 0 for f in frames]


def _body_kernels(runner) -> int:
    """The nodes of the body of the IF node in ``runner``'s graph
    (core/graphs.py::cond: the branch captured as a graph of its own) that
    a kernel trace lists as kernels: its kernels, and its copies and
    fills, which a graph's body runs as kernels of CUDA's own
    (``memcpy32_post``)."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core.graphs import _NODE_TYPES

    (branch,) = runner._branches
    counts = (ctypes.c_int * len(_NODE_TYPES))()
    kernels.check(kernels.lib().lvt_graph_node_counts(
        branch.raw_cuda_graph(), counts, len(_NODE_TYPES)), "node counts")
    return sum(counts[_NODE_TYPES.index(t)]
               for t in ("kernel", "memcpy", "memset"))


# a kernel trace can miss the last records of an IF node's body: 1-10 of
# 3233-3276 kernels (the body's closing select and copy) the first time a
# trace saw the node run, with BA's former torch body on 8a; with local
# BA's kernel as the body (its launch and a copy), its records on any BA
# frame of a trace (measured on the H100)
TRACED_FRAMES = (5, 17)     # frames traced one at a time: BA at 8, 12, 16


def _frame_types(path, config, make, a, b, eager=False) -> dict:
    """What the card ran per frame type, on a path whose local BA is a CUDA
    IF node in its graph: a new system ``make()`` tracks frames 0-4 of
    ``a`` and ``b`` (its graph is captured at frame 0, the node's body
    first runs at frame 4), then frames 5-16 one ``track_chunk`` each in
    one kernel trace (``dryrun.frame_launches``). Every frame launches
    NEED_PER_FRAME and NEED_BY_FRAME_TYPE by its type (local BA's own
    kernels, ``ba_refine`` or on 8a ``ba_phase``, by their own counts);
    every other frame runs the same kernels, and a BA frame an other
    frame's and the node's body's (``_body_kernels``; a trace can lose
    records of the body, TRACED_FRAMES, so it lists no more than the body
    holds), so no other frame runs any of BA's. With ``eager``, the same frames of a system
    under ``disable_graphs()`` beside it: no predicate, the same kernels
    on every frame (BA computed and selected)."""
    from lvt_tpu_torch.core.graphs import disable_graphs
    from lvt_tpu_torch.parallel.dryrun import frame_launches

    lo, hi = TRACED_FRAMES
    is_ba = _ba_frames(config, range(lo, hi))
    if is_ba.count(True) != 3:
        raise AssertionError(f"{path}: frames {lo}-{hi - 1} hold "
                             f"{is_ba.count(True)} BA frames, not 3")
    out = {}
    for mode in ("graph", "eager") if eager else ("graph",):
        with disable_graphs() if mode == "eager" else nullcontext():
            vo = make()
            vo.track_chunk(a[:lo], b[:lo])
            (runner,) = vo.runners.values()
            ran = runner.mode
            _, frames = frame_launches(
                lambda i: vo.track_chunk(a[lo + i:lo + i + 1],
                                         b[lo + i:lo + i + 1]), hi - lo)
        if ran != mode or not runner.if_nodes:
            raise AssertionError(f"{path}: the {mode} runner has mode {ran}, "
                                 f"if_nodes {runner.if_nodes}")
        for f, ba in zip(frames, is_ba):
            want = int(ba or mode == "eager")
            _check_launches(path, f, 1, want, chunks=1)
            need = ({"if_node": 0, "nccl": 0}
                    if mode == "eager" else
                    NEED_BY_FRAME_TYPE[path]["ba" if ba else "other"])
            if path in BA_KERNEL_PATHS:
                need = dict(need, ba_refine=want)
            if path in SHARDED_PATHS:
                need = dict(need, ba_phase=BA_PHASES * want)
            got = {k: f[k] for k in need}
            if got != need:
                raise AssertionError(f"{path}: a {'BA' if ba else 'other'} "
                                     f"frame ({mode}) ran {got}, not {need}")
        names = [Counter(n for n in f["names"]
                         if not n.startswith(("Memcpy", "Memset")))
                 for f in frames]
        kinds = {t: [k for k, ba in zip(names, is_ba) if ba == (t == "ba")]
                 for t in ("ba", "other")}
        nccl = {t: sorted({f["nccl"] for f, ba in zip(frames, is_ba)
                           if ba == (t == "ba")}) for t in ("ba", "other")}
        counts = {t: [sum(k.values()) for k in ks] for t, ks in kinds.items()}
        _say(path, f"{mode}, frames {lo}-{hi - 1} one at a time (kernel "
                   f"trace): device kernels per BA frame {counts['ba']}, per "
                   f"other frame {counts['other']}; NCCL kernels per BA "
                   f"frame {nccl['ba']}, per other frame {nccl['other']}; "
                   f"IF-node predicates per frame "
                   f"{1 if mode == 'graph' else 0}; every frame "
                   f"{NEED_PER_FRAME[path]}")
        other = kinds["other"][0]
        for k in kinds["other"][1:]:
            if k != other:
                raise AssertionError(
                    f"{path}: other frames ran other kernels ({mode}): "
                    f"{dict(k - other)} more, {dict(other - k)} fewer")
        if mode == "eager":
            if any(k != other for k in kinds["ba"]):
                raise AssertionError(f"{path}: the eager step runs other "
                                     f"kernels on BA frames")
            continue
        # a BA frame runs another frame's kernels and the node's body
        # (TRACED_FRAMES: a kernel trace can lose records of the body)
        body = _body_kernels(runner)
        extra = [k - other for k in kinds["ba"]]
        seen = [sum(e.values()) for e in extra]
        _say(path, f"graph: BA frames list {seen} kernels more than another "
                   f"frame in the trace "
                   f"({[dict(e) for e in extra] if body < 10 else '...'}); "
                   f"the IF node's body holds {body} kernel, copy and fill "
                   f"nodes")
        missing = [dict(other - k) for k in kinds["ba"]]
        # local BA's kernel and a copy, or on 8a its phases, their
        # all-reduces' copies and a copy: the trace may lose their records
        # on any BA frame, so it lists no more than the body; which frames
        # run the kernels is their own count (NEED_BY_FRAME_TYPE)
        bad = max(seen) > body
        if any(missing) or bad:
            raise AssertionError(
                f"{path}: a BA frame's kernels are not another frame's and "
                f"the node's body's: {missing} missing on BA frames, {seen} "
                f"more, the body {body}")
        out = dict(kernels_ba=sum(other.values()) + body,
                   kernels_other=sum(other.values()), body=body,
                   nccl_ba=nccl["ba"][0], nccl_other=nccl["other"][0],
                   traced_body=seen)
    return out


def phase_sparse(config, il, ir) -> dict:
    """The sparse descriptor mode (path 1's config with
    ``descriptor_mode="sparse"``: kernel A, then the per-cell selection and
    BRIEF at each corner from A's box sums, in torch ops, as lvt_tpu runs
    it in XLA ops), card against CPU: frame 0's features of the pair
    bit-equal in every slot, and the poses of frames 0-3 through
    ``VOSystem`` (graphed on the card) within 1e-3 m."""
    from lvt_tpu_torch.core.extract import extract_features_batched
    from lvt_tpu_torch.core.system import VOSystem

    config = config.replace(descriptor_mode="sparse")
    imgs = torch.stack([il[0], ir[0]])
    got = extract_features_batched(imgs, config)
    want = extract_features_batched(imgs.cpu(), config)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    n = N_CPU_FRAMES["sparse"]
    vo = VOSystem(config, device=DEVICE)
    pg, _ = vo.track_chunk(il[:n], ir[:n])
    pc, _ = VOSystem(config, device="cpu").track_chunk(il[:n].cpu(),
                                                       ir[:n].cpu())
    dt = float((pg.t.cpu() - pc.t).abs().max())
    modes = [r.mode for r in vo.runners.values()]
    _say("sparse", f"descriptor mode sparse, card ({modes}) vs CPU: frame "
                   f"0's features {'bit-equal' if same else 'NOT equal'} "
                   f"in all {want.valid.numel()} slots "
                   f"({int(want.valid.sum())} valid); poses of frames "
                   f"0-{n - 1} differ by at most {dt:.3g} m")
    if not same:
        raise AssertionError("sparse: frame 0's features differ card vs CPU")
    if not dt < 1e-3:
        raise AssertionError(f"sparse: CPU vs card pose difference {dt} m "
                             f">= 1e-3 m")
    return dict(pose_gap_m=dt)


# multi-stream with local BA (ROADMAP Queue 3's check): S streams of path
# 2's config, stream i from frame MS_START_STEP * i, over MSBA_FRAMES
# frames (BA at frames 4 and 8)
MSBA_FRAMES = 9


def phase_multistream_ba(config, il, ir) -> dict:
    """Many streams with local BA on the card: ``MultiStreamVO(config,
    MS_STREAMS)`` with path 2's config (its step vmapped, so BA is computed
    and selected on every frame, in the graph too), MSBA_FRAMES frames in
    one chunk, against the card's ``VOSystem`` (whose BA is an IF node) on
    streams 0 and 1's frames: poses and the map's positions bit-equal, BA
    on the same frames (a pose gap is printed; under 1e-5 m tolerated, as
    path 3's, 1e-5 m fails)."""
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    s, n = MS_STREAMS, MSBA_FRAMES
    starts = [MS_START_STEP * i for i in range(s)]
    a = torch.stack([il[k:k + n] for k in starts], 1)
    b = torch.stack([ir[k:k + n] for k in starts], 1)
    # local BA's kernel's windows, and the step's kernels (ba_observe and
    # kernel T's dual row launch among them) on the streams' inputs in one
    # launch each, every stream against its S = 1 launch
    ba = {}

    def frames():
        ba.update(capture_ba_inputs("multistream-ba", _first_frames(
            lambda: MultiStreamVO(config, s, device=DEVICE), a, b, n),
            config))
        return n

    capture_pnp_inputs("multistream-ba", frames)
    ba_inputs = ba
    msvo = MultiStreamVO(config, s, device=DEVICE)
    poses, metrics = msvo.track_chunk(a, b)
    gaps, equal = [], []
    for i in (0, 1):
        vo = VOSystem(config, device=DEVICE)
        p, m = vo.track_chunk(a[:, i], b[:, i])
        gaps.append(float((p.t - poses.t[:, i]).abs().max()))
        equal.append(torch.equal(p.t, poses.t[:, i])
                     and torch.equal(p.q, poses.q[:, i])
                     and torch.equal(vo.state.map.pos,
                                     msvo.states.map.pos[i])
                     and torch.equal(m.local_ba_ran,
                                     metrics.local_ba_ran[:, i]))
    ran = metrics.local_ba_ran.sum(0).tolist()
    modes = [r.mode for r in msvo.runners.values()]
    _say("multistream-ba", f"{s} streams x {n} frames of path 2's config "
                           f"({modes}; BA ran on {ran} frames per stream): "
                           f"streams 0 and 1 against the card's VOSystem: "
                           f"poses, map positions and BA runs "
                           f"{'EQUAL' if all(equal) else 'differ'} "
                           f"({equal}); largest pose gaps {gaps} m")
    if ran != [sum(_ba_frames(config, range(n)))] * s:
        raise AssertionError(f"multistream-ba: BA ran on {ran} frames, not "
                             f"the schedule's")
    if not max(gaps) < 1e-5:
        raise AssertionError(f"multistream-ba: multi-stream vs single-stream "
                             f"gaps {gaps} m, not under 1e-5 m")
    return dict(equal=all(equal), gaps=gaps, ba_inputs=ba_inputs)


# the benchmark entry point (lvt_tpu_torch/bench.py, ``python -m
# lvt_tpu_torch bench``): its three modes at bench.py's sizes on the frames
# of the sequence every path takes its prefix of (bench.render), then one
# untimed chunk more of the sequence in a kernel trace
BENCH_PATHS = ("bench", "bench-ba", "bench-ms")
# a bench frame sees the world when this many of its 6000 points lie in
# the left image: bench.py's camera, 0.9 m a frame, drives out of them
# (206 in view at frame 128, 13 at frame 160, none from frame 173)
BENCH_IN_VIEW = 100


def _points_in_view(config, rot, pos) -> np.ndarray:
    """Per frame, how many of bench.py's world points lie in the left image
    of a camera at ``rot``, ``pos`` (in front of it and inside the margin
    ``SyntheticWorld.render`` draws in)."""
    from lvt_tpu_torch import bench

    w = bench.world(config)
    cam = np.einsum("fji,fpj->fpi", rot, w.points[None] - pos[:, None])
    z = cam[..., 2]
    front = z > 0.5
    u = w.fx * cam[..., 0] / np.where(front, z, 1.0) + w.cx
    v = w.fy * cam[..., 1] / np.where(front, z, 1.0) + w.cy
    m = 4
    return (front & (u > m) & (u < w.width - m) & (v > m)
            & (v < w.height - m)).sum(-1)


def _bench_checks(path, out, config, est, rot, gt) -> str:
    """What every bench mode must hold: one capture, made in the warm-up
    chunk; 0 host syncs in the timed loop; TRACKING on every frame (of
    every stream) that sees at least BENCH_IN_VIEW of the world's points
    (bench.py's camera drives out of them), and the ATE of ``est`` (one
    stream's positions) under 5% over those frames; BA on its schedule
    until the first frame that is not TRACKING, and never after it.
    Returns what it found."""
    from lvt_tpu_torch.core.state import TRACKING

    if (out["captures_warmup"], out["captures"]) != (1, 1):
        raise AssertionError(f"{path}: graphs captured after the warm-up "
                             f"chunk / in all: {out['captures_warmup']} / "
                             f"{out['captures']}, not 1 / 1")
    if out["syncs"] != 0:
        raise AssertionError(f"{path}: {out['syncs']} host syncs in the "
                             f"timed loop")
    status = out["metrics"].status.cpu()
    status = status if status.ndim == 2 else status[:, None]
    n = status.shape[0]
    seen = _points_in_view(config, rot[:n], gt[:n])
    gone = seen < BENCH_IN_VIEW
    k = int(np.argmax(gone)) if gone.any() else n
    if not gone[k:].all():
        raise AssertionError(f"{path}: the world comes back into view")
    for i in range(status.shape[1]):
        _every_frame_tracking(f"{path} stream {i}", status[:k, i])
    tracking = (status[:, 0] == TRACKING).tolist()
    lost = tracking.index(False) if False in tracking else n
    ran = out["metrics"].local_ba_ran.cpu()
    ran = (ran if ran.ndim == 1 else ran[:, 0]).tolist()
    want = _ba_frames(config, range(lost)) + [False] * (n - lost)
    if ran != want:
        raise AssertionError(f"{path}: BA ran on {sum(ran)} frames, the "
                             f"schedule says {sum(want)}")
    return (f"frames 0-{k - 1} see at least {BENCH_IN_VIEW} of the world's "
            f"points and are TRACKING (frame {k} sees "
            f"{seen[k] if k < n else '-'}, frame {n - 1} {seen[-1]}), the "
            f"first frame not TRACKING {lost if lost < n else '-'}; "
            + _check_ate(path, est[:k], gt[:k])
            + (f" over frames 0-{k - 1}; BA on {sum(want)} frames"
               if config.local_ba_window else f" over frames 0-{k - 1}"))


def _bench_trace(path, system, a, b, n) -> dict:
    """One untimed chunk more (``a``, ``b``: its ``n`` frames) in a kernel
    trace: per frame exactly NEED_PER_FRAME and one IF-node predicate per
    node in the graph; returns the traced launches."""
    from lvt_tpu_torch.parallel.dryrun import device_launches

    ba = 0
    if path in BA_KERNEL_PATHS:   # BA's frames by their frame numbers
        start = system.frame_number
        ba = sum(_ba_frames(system.config, range(start, start + n)))
    _, got = device_launches(lambda: system.track_chunk(a, b))
    launches = {k: got.get(k, 0) for k in KERNELS}
    _check_launches(path, launches, n, ba, chunks=1)
    nodes = sum(len(r._branches) for r in system.runners.values())
    if got["if_node"] != n * nodes:
        raise AssertionError(f"{path}: {got['if_node']} IF-node predicates "
                             f"in {n} replays of a graph with {nodes} nodes")
    _say(path, f"one untimed chunk more ({n} frames, kernel trace): "
               f"{launches}, IF-node predicates {got['if_node']} ({nodes} "
               f"node(s)); {got['kernels'] / n:.1f} device kernels per frame")
    return dict(launches=launches, if_node=got["if_node"])


def phase_bench(il, ir, rot, gt, path1_poses) -> dict:
    """The benchmark entry point's three modes on the card
    (``bench.run_main``, ``--ba``, ``bench.run_multistream``: what ``python
    -m lvt_tpu_torch bench`` runs), at bench.py's sizes, on the prefix of
    the sequence every path takes (``il``, ``ir`` on the card; bench.py's
    frames). Each prints its JSON line and must hold ``_bench_checks``;
    the wrappers' counts (set to 0 just before) are NEED_PER_FRAME twice
    per graph (its warm-up and captured step), and one untimed chunk more
    in a kernel trace is NEED_PER_FRAME per frame (``_bench_trace``; the
    ``kernels`` line's launches). main's poses are path 1's, bit for bit,
    over path 1's frames (the same config, frames and chunks of 16);
    ``--ba``'s frames run BA's body on BA frames only (``_frame_types``)
    and the PnP kernel is held on its inputs; the streams of
    ``--multistream`` (all fed the same frames) are bit-equal to each other
    and within 1e-5 m of main. Kernels A, P and T against their plain
    versions at each mode's shapes (``check_path_kernels``, on its first
    timed frames)."""
    from lvt_tpu_torch import bench
    from lvt_tpu_torch.core.extract import extract_features_batched
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.parallel.dryrun import zero_kernel_counters

    runs, fps = {}, {}
    n = bench.CHUNK * (bench.N_CHUNKS + 1)
    for path, ba in (("bench", False), ("bench-ba", True)):
        counters = zero_kernel_counters()
        out = bench.run_main(ba=ba, chunk=bench.CHUNK,
                             n_chunks=bench.N_CHUNKS, frames=(il, ir),
                             device=DEVICE)
        wrappers = {k: fn.launches for k, fn in counters.items()}
        print(json.dumps(out["line"]), flush=True)
        vo, config = out["system"], out["config"]
        _check_launches(path, wrappers, 2 * len(vo.runners),
                        chunks=bench.N_CHUNKS + 1)
        ate = _bench_checks(path, out, config, out["poses"].t.cpu().numpy(),
                            rot, gt)
        _say(path, f"{out['fps']:.2f} frames/s over {bench.N_CHUNKS} timed "
                   f"chunks of {bench.CHUNK} ({out['seconds']:.4f} s), "
                   f"{n} frames in all: 1 graph captured in the warm-up "
                   f"chunk, 0 host syncs in the timed loop; {ate}; wrapper "
                   f"counts {wrappers}")
        trace = _bench_trace(path, vo, il[n:n + bench.CHUNK],
                             ir[n:n + bench.CHUNK], bench.CHUNK)
        if ba and trace["if_node"] != bench.CHUNK:
            raise AssertionError(f"{path}: the graph holds no IF node")
        # the first timed frames (the untimed chunk's see no world)
        j = bench.CHUNK
        imgs = torch.stack([il[j], ir[j]])
        f = extract_features_batched(torch.stack([il[j], il[j + 1], ir[j]]),
                                     config)
        sites = t_site_inputs(config, _streams(f, [0]), _streams(f, [1]),
                              _streams(f, [2]))
        errs = check_path_kernels(
            path, config, imgs,
            lambda dev: extract_features_batched(imgs.to(dev), config),
            {k: sites[k] for k in T_SITES[path]})
        if ba:
            _frame_types(path, config,
                         lambda: VOSystem(config, device=DEVICE), il, ir)
            errs["pnp_solve"] = check_pnp_solve(
                path, capture_pnp_inputs(path, _first_frames(
                    lambda: VOSystem(config, device=DEVICE), il,
                    ir)))["max_abs_err"]
            gaps = check_ba_refine(path, capture_ba_inputs(
                path, _first_frames(lambda: VOSystem(config, device=DEVICE),
                                    il, ir), config))
            errs.update(ba_refine=gaps["max_abs_err"],
                        ba_phase=gaps["phase_max_abs_err"])
        else:
            k = path1_poses.t.shape[0]
            same = (torch.equal(out["poses"].t[:k], path1_poses.t)
                    and torch.equal(out["poses"].q[:k], path1_poses.q))
            _say(path, f"poses of frames 0-{k - 1} against path 1's (the "
                       f"same frames, config and chunks): "
                       f"{'EQUAL' if same else 'differ'}")
            if not same:
                raise AssertionError(f"{path}: poses differ from path 1's")
            single = out["poses"]
        fps[path] = out["fps"]
        runs[path] = dict(fps=out["fps"], mode="graph", line=out["line"],
                          launches=trace["launches"],
                          if_node_launches=trace["if_node"],
                          kernel_errs=errs)
        del out, vo

    path = "bench-ms"
    s, chunk = bench.MS_STREAMS, bench.MS_CHUNK
    m = chunk * (bench.MS_N_CHUNKS + 1)
    counters = zero_kernel_counters()
    out = bench.run_multistream(streams=s, chunk=chunk,
                                n_chunks=bench.MS_N_CHUNKS, frames=(il, ir),
                                device=DEVICE)
    wrappers = {k: fn.launches for k, fn in counters.items()}
    print(json.dumps(out["line"]), flush=True)
    msvo, config = out["system"], out["config"]
    _check_launches(path, wrappers, 2 * len(msvo.runners),
                    chunks=bench.MS_N_CHUNKS + 1)
    t, q = out["poses"].t, out["poses"].q
    ate = _bench_checks(path, out, config, t[:, 0].cpu().numpy(), rot, gt)
    alike = all(torch.equal(t[:, i], t[:, 0]) and torch.equal(q[:, i],
                                                              q[:, 0])
                for i in range(1, s))
    gap = float((t[:, 0] - single.t[:m]).abs().max())
    _say(path, f"{out['fps']:.2f} frames/s per card ({out['streams']} "
               f"streams, {out['world']} device(s)) over "
               f"{bench.MS_N_CHUNKS} timed chunks of {chunk} "
               f"({out['seconds']:.4f} s): 1 graph captured in the warm-up "
               f"chunk, 0 host syncs in the timed loop; every stream: {ate}; "
               f"the {s} streams "
               f"{'EQUAL' if alike else 'differ'}; stream 0 against main's "
               f"single stream over frames 0-{m - 1}: largest gap {gap:.3g} "
               f"m; wrapper counts {wrappers}")
    if not alike:
        raise AssertionError(f"{path}: streams fed the same frames differ")
    if not gap < 1e-5:
        raise AssertionError(f"{path}: stream 0 is {gap} m from the single "
                             f"stream, not under 1e-5 m")
    a = bench.stream_frames(il[m:m + chunk], s)
    b = bench.stream_frames(ir[m:m + chunk], s)
    trace = _bench_trace(path, msvo, a, b, chunk)
    a, b = (bench.stream_frames(x[chunk:chunk + 2], s) for x in (il, ir))
    imgs = torch.cat([a[0], b[0]])
    f0 = extract_features_batched(imgs, config)
    f1 = extract_features_batched(a[1], config)
    sites = t_site_inputs(config, _streams(f0, slice(0, s)), f1,
                          _streams(f0, slice(s, 2 * s)))
    errs = check_path_kernels(
        path, config, imgs,
        lambda dev: extract_features_batched(imgs.to(dev), config),
        {k: sites[k] for k in T_SITES[path]})
    fps[path] = out["fps"]
    runs[path] = dict(fps=out["fps"], mode="graph", line=out["line"],
                      launches=trace["launches"],
                      if_node_launches=trace["if_node"], kernel_errs=errs)
    _say("bench", "frames/s, main / --ba / --multistream (per card): "
                  + " / ".join(f"{fps[p]:.2f}" for p in BENCH_PATHS))
    return runs


def phase_cpu(path, config, il, ir, first_poses):
    """The first frames of a path again through the port on the CPU."""
    from lvt_tpu_torch.core.extract import extract_features_stereo
    from lvt_tpu_torch.core.system import VOSystem

    cuda_feats = extract_features_stereo(il[0], ir[0], config)
    cpu_feats = extract_features_stereo(il[0].cpu(), ir[0].cpu(), config)
    for side, g, c in zip(("left", "right"), cuda_feats, cpu_feats):
        _same_features(f"{path} frame 0 {side}", g, c)
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

    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name):
        """Adds the seconds since the last lap to phase ``name``'s."""
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - last[0]
        last[0] = now

    card = phase_device()
    lap("device and build")
    from lvt_tpu_torch import bench
    from lvt_tpu_torch.configs import kitti_ba_dense_config, kitti_config
    from lvt_tpu_torch.core.system import VOSystem

    configs = {"path1": kitti_config(), "path2": kitti_ba_dense_config()}
    # bench.py's sequence, whose prefix every path of its camera takes: the
    # benchmark's frames and one chunk more
    n = max(_n_frames("path1"),
            MS_START_STEP * (MS_STREAMS - 1) + _n_frames("path3"),
            bench.CHUNK * (bench.N_CHUNKS + 2))
    t0 = time.perf_counter()
    il, ir, rot, gt = bench.render(configs["path1"], n)
    _say("frames", f"{n} frames of bench.py's sequence rendered in "
                   f"{time.perf_counter() - t0:.1f} s")
    il, ir = torch.from_numpy(il), torch.from_numpy(ir)
    config4, gray, depth, rot4, pos4 = rgbd_setup()

    il, ir = il.to(DEVICE), ir.to(DEVICE)
    lap("frames")
    report = phase_kernels(card, kernel_inputs(configs["path1"], il[:2],
                                               ir[:2]))
    report["hamming_top2"]["batched"] = measure_t_batched(
        card, t_batched_inputs(configs["path1"], il, config4,
                               gray.to(DEVICE)))
    torch.cuda.synchronize()
    lap("kernels")
    runs = {}
    for path, config in configs.items():
        k = _n_frames(path)
        runs[path] = phase_path(path, config, il[:k], ir[:k], gt,
                                args.profile)
        phase_cpu(path, config, il, ir, runs[path]["first_poses"])
        if path == "path1":
            sparse = phase_sparse(config, il, ir)
        lap(path)
    # the tracking branch's kernels timed on path 1's inputs (the main
    # path), at S = 1 and 8
    track1 = runs["path1"].pop("track_inputs")
    report.update(measure_track_kernels(
        card, "path1", {k: v for k, v in track1.items() if k != T_ROW}))
    # kernel T's row modes on the inputs the paths gave them: path 1's
    # single row launch, path 2's dual (both row matches); local BA's
    # observations on path 2's
    track2 = runs["path2"].pop("track_inputs")
    rows = measure_track_kernels(card, "path1", {T_ROW: track1[T_ROW]})
    rep2 = measure_track_kernels(card, "path2", {
        k: track2[k] for k in ("ba_observe", T_ROW)})
    report["ba_observe"] = rep2["ba_observe"]
    report["hamming_top2"]["row_modes"] = dict(single=rows[T_ROW],
                                               dual=rep2[T_ROW])
    # step_tail as it ends a graphed frame; the op's launch (fresh outputs,
    # no chunk) beside it
    report["step_tail"] = dict(measure_step_tail(card, "path1", track1),
                               op=report["step_tail"])
    report["copy_leaves"] = measure_copy_leaves(card, "path1", track1)
    lap("track kernels timing")
    # local BA's kernel, and its phases on one rank, on path 2's BA
    # windows (frames 4 and 8)
    gaps = check_ba_refine("path2", capture_ba_inputs("path2", _first_frames(
        lambda: VOSystem(configs["path2"], device=DEVICE), il, ir),
        configs["path2"]))
    runs["path2"]["kernel_errs"].update(ba_refine=gaps["max_abs_err"],
                                        ba_phase=gaps["phase_max_abs_err"])
    lap("ba_refine checks")
    runs.update(phase_bench(il, ir, rot, gt, runs["path1"].pop("poses")))
    lap("bench")
    ms_ba = phase_multistream_ba(configs["path2"], il, ir)
    lap("multistream-ba")
    # local BA's kernel timed on the 8-stream unit's windows of a BA frame
    # (path 2's config, M = 1024), at S = 1 and 8
    report["ba_refine"] = measure_ba_refine(card, "multistream-ba",
                                            ms_ba.pop("ba_inputs"))
    report["ba_phase"] = report["ba_refine"].pop("phases")
    lap("ba_refine timing")
    report["if_node"] = measure_if_node(card, configs["path2"], il, ir)
    lap("if_node")
    runs["path3"] = phase_multistream(configs["path1"], il, ir, rot, gt,
                                      args.profile)
    phase_multistream_cpu(configs["path1"], runs["path3"]["first_poses"],
                          runs["path3"]["inputs"])
    lap("path3")
    runs["path4"] = phase_rgbd(config4, gray, depth, rot4, pos4, args.profile)
    lap("path4")
    # PnP: the fused solve at path 3's M (paths 1, 2, 4 and 6 have the
    # same) and path 5's 4096, 8 streams in one launch; the phases' time on
    # one rank beside it (the kernel of paths 8a-8c: phase launches are
    # timed as a whole solve); the plain version's two ops on their inputs
    # in the plain solves of the same streams
    solve3 = runs["path3"].pop("pnp_inputs")
    report["pnp_solve"] = measure_pnp_solve(card, "path3", solve3)
    report["pnp_phase"] = _phase_report(report["pnp_solve"])
    runs["path3"]["kernel_errs"]["pnp_solve"] = report["pnp_solve"][
        "max_abs_err"]
    for name, rep in measure_pnp(card, "path3",
                                 old_op_inputs(solve3)).items():
        report[name] = rep
        runs["path3"]["kernel_errs"][name] = rep["max_abs_err"]
    lap("pnp timing")
    euroc = euroc_setup()
    runs["path5"] = phase_rectified(*euroc, args.profile)
    # path 5's M (4096 map points) is the one other than path 3's 1024
    solve5 = runs["path5"].pop("pnp_inputs")
    report["pnp_solve"]["path5"] = measure_pnp_solve(card, "path5", solve5)
    report["pnp_phase"]["path5"] = _phase_report(report["pnp_solve"]["path5"])
    runs["path5"]["kernel_errs"]["pnp_solve"] = report["pnp_solve"]["path5"][
        "max_abs_err"]
    for name, rep in measure_pnp(card, "path5",
                                 old_op_inputs(solve5)).items():
        report[name]["path5"] = rep
        runs["path5"]["kernel_errs"][name] = rep["max_abs_err"]
    lap("path5")
    runs["path6"] = phase_external(configs["path1"], il[:EXT_FRAMES],
                                   ir[:EXT_FRAMES], gt, args.profile)
    lap("path6")
    k = CHUNK * 3
    runs["path7"] = phase_cli(
        (il[:k].cpu().numpy(), ir[:k].cpu().numpy(), gt[:k]),
        (euroc[2][:k].numpy(), euroc[3][:k].numpy(), euroc[4][:k]),
        tum_setup())
    lap("path7")
    config8 = sharded_config()
    gaps = check_ba_refine("path7-kitti", capture_ba_inputs(
        "path7-kitti", _first_frames(lambda: VOSystem(config8, device=DEVICE),
                                     il, ir), config8))
    runs["path7"]["kernel_errs"].update(ba_refine=gaps["max_abs_err"],
                                        ba_phase=gaps["phase_max_abs_err"])
    lap("ba_refine checks")
    runs["path7"]["streaming"] = phase_streaming(config8, il, ir)
    lap("path7")
    if config8 != runs["path7"]["configs"]["kitti"]:
        raise AssertionError("path8: the config is not path 7 kitti's")
    path8 = phase_sharded(card, config8, configs["path1"], il, ir, gt,
                          runs["path3"].pop("poses"), args.profile)
    runs.update(path8["runs"])
    report["hamming_top2"]["path8"] = path8["shard_t"]
    report["pnp_solve"]["path8"] = path8["shard_solve"]
    report["pnp_phase"]["path8"] = {
        m: _phase_report(rep) for m, rep in path8["shard_solve"].items()}
    for name in ("pnp_normal_eqs", "stream_sum"):
        report[name]["path8"] = {m: rep[name]
                                 for m, rep in path8["shard_pnp"].items()}
    lap("path8")

    entries = []
    for k, (route, source, replaces) in KERNELS.items():
        entry = dict(name=k, route=route, source=source, replaces=replaces,
                     tpu_kernel=k in SITE_KERNELS,
                     launches=sum(r["launches"][k] for r in runs.values()),
                     launches_by_path={p: r["launches"][k]
                                       for p, r in runs.items()},
                     reps=REPS, plain_reps=PLAIN_REPS, **report[k])
        # phase 2 checked A, B, P and T at paths 1 and 2's shapes, the
        # other paths their own (the PnP solve on every path's inputs, its
        # phases at path 8's; the plain version's ops at paths 3, 5 and 8)
        by_path = {p: report[k]["max_abs_err"] for p in ("path1", "path2")
                   if NEED_PER_FRAME[p].get(k) and k in SITE_KERNELS}
        by_path.update({p: r["kernel_errs"][k] for p, r in runs.items()
                        if k in r.get("kernel_errs", {})})
        # the tracking kernels at every path's capture (check_track_kernels),
        # kernel T's row launches among them
        by_path.update(TRACK_ERRS.get(k, {}))
        if k == "hamming_top2":
            by_path.update({f"{p} (row launches)": e
                            for p, e in TRACK_ERRS[T_ROW].items()})
        entry.update(max_abs_err=max(by_path.values()),
                     max_abs_err_by_path=by_path)
        # the profiler's device time per launch in each path's graphed
        # unit
        entry["profiler_ms_by_path"] = {
            p: (r.get("profile") or {}).get(k, {}).get("device_ms")
            for p, r in runs.items()}
        entries.append(entry)
    if_launches = {p: r.get("if_node_launches", 0) for p, r in runs.items()}
    entries.append(dict(
        name="if_node", route=IF_NODE[0], source=IF_NODE[1],
        replaces=IF_NODE[2], tpu_kernel=False,
        launches=sum(if_launches.values()), launches_by_path=if_launches,
        reps=IF_REPS, plain_reps=IF_REPS, **report["if_node"]))
    phase_c_abi(runs["path7"].pop("root"),
                runs["path7"].pop("configs")["kitti"],
                il[:C_ABI_FRAMES].cpu().numpy(),
                ir[:C_ABI_FRAMES].cpu().numpy())
    lap("c_abi")
    _say("summary", f"path 3's streams 0 and 1 "
                    f"{'equal' if runs['path3']['equal'] else 'NOT equal'} "
                    f"to the single stream (largest gap "
                    f"{max(runs['path3']['gaps'])} m)")
    _say("summary", "frames/s, median graph / eager: " + ", ".join(
        f"{p} {r['fps']:.2f} / {r['fps_eager']:.2f}" if "fps_eager" in r
        else f"{p} {r['fps']:.2f} ({r['mode']})"
        for p, r in runs.items() if p != "path7")
        + f" (path 3 aggregate of {MS_STREAMS} streams; "
        f"{runs['path3']['fps_per_stream']:.2f} per stream)")
    _say("summary", "device busy share of the span of a profiled graphed "
                    "unit (first kernel start to last kernel end): "
                    + ", ".join(
        f"{p} {100 * r['profile']['busy_ms_per_frame'] / r['profile']['span_ms_per_frame']:.1f}%"
        for p, r in runs.items() if "fps_eager" in r)
        + f"; device kernels per frame on path 1: "
        f"{runs['path1']['profile']['kernels_per_frame']:.1f}")
    _say("summary", f"path 8: {path8['nccl']}; 8b-8d on "
                    f"{path8['backend']}; pose gaps to the unsharded run "
                    f"over frames 0-{SH_HORIZON - 1} / all: " + ", ".join(
                        f"{p} {runs[p]['gap']:.3g} / {runs[p]['gap_all']:.3g}"
                        f" m" for p in ("path8b-2", "path8b-4", "path8c")))
    _say("summary", "path 7 frames/s, end to end with PNG decode / in "
                    "process: " + ", ".join(
                        f"{name} {a:.2f} / {b:.2f}" for name, (a, b)
                        in runs["path7"]["fps"].items()))
    types = {"path2": runs["path2"]["profile"]["frame_types"],
             "path7-kitti": runs["path7"]["frame_types"],
             "path8a": runs["path8a"]["profile"]["frame_types"]}
    _say("summary", "local BA as an IF node, device kernels per BA frame / "
                    "other frame (NCCL kernels): " + ", ".join(
                        f"{p} {t['kernels_ba']} / {t['kernels_other']} "
                        f"({t['nccl_ba']} / {t['nccl_other']})"
                        for p, t in types.items()))
    _say("summary", f"sparse descriptor mode card vs CPU: poses within "
                    f"{sparse['pose_gap_m']:.3g} m; {MS_STREAMS} streams "
                    f"with local BA {'equal' if ms_ba['equal'] else 'NOT '
                    'equal'} to the single stream (largest gap "
                    f"{max(ms_ba['gaps'])} m)")
    _say("summary", "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()))
    _say("summary", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
