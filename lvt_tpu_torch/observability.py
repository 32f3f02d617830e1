"""Observability: per-frame metrics recording, trace logging, profiling.

Port of lvt_tpu/observability.py. ``ValueRecorder`` writes one CSV row per
frame to ``measurments.txt`` and the series names to ``titles.txt`` (the
reference's file names and format, its spelling included); ``TraceLog``
writes lines stamped in ms since its creation to ``vo-<datetime>.txt``.
Per-point series (age, descriptor distances, feature x / y) are per-frame
means, as in lvt_tpu.

``record_chunk`` reads a chunk's metrics to the host in one transfer: the
ten series are stacked on the device (as float64, which holds every int32
count and float32 mean exactly) and copied once.

``profile_trace`` is a ``torch.profiler`` context over the CPU and, where
there is one, the CUDA device. The step's stages carry profiler ranges
named as lvt_tpu's ``jax.named_scope`` markers (core/step.py:
motion_predict, map_matching, pnp_solve, map_bookkeeping, staged_update,
triangulation, local_ba; core/extract.py: perception, corner_select,
patch_describe, corner_select_describe; rectify for raw EuRoC frames).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time

import torch

# reference series names (lvt_system.cpp:339-349)
REFERENCE_SERIES = [
    "map points count",
    "staged points count",
    "image keypoints",
    "tracked map points",
    "age",
    "closest descriptor distance",
    "second descriptor distance",
    "img feature x",
    "img feature y",
    "inlier count",
]

_METRIC_FIELD_FOR_SERIES = {
    "map points count": "map_points_count",
    "staged points count": "staged_points_count",
    "image keypoints": "image_keypoints",
    "tracked map points": "tracked_map_points",
    "age": "mean_age",
    "closest descriptor distance": "mean_closest_descriptor_distance",
    "second descriptor distance": "mean_second_descriptor_distance",
    "img feature x": "mean_feature_x",
    "img feature y": "mean_feature_y",
    "inlier count": "inlier_count",
}


def _series_on_host(metrics) -> torch.Tensor:
    """[10, N] float64 on the CPU: the reference series of ``metrics``
    (leaves [] or [N]), stacked on their device and copied once."""
    cols = [getattr(metrics, f).reshape(-1).to(torch.float64)
            for f in _METRIC_FIELD_FOR_SERIES.values()]
    return torch.stack(cols).cpu()


class ValueRecorder:
    """Per-frame named value series -> CSV (lvt_value_recorder)."""

    def __init__(self, out_dir: str = ".",
                 values_filename: str = "measurments.txt",
                 titles_filename: str = "titles.txt"):
        self.out_dir = out_dir
        self.values_path = os.path.join(out_dir, values_filename)
        self.titles_path = os.path.join(out_dir, titles_filename)
        self.series: list[str] = list(REFERENCE_SERIES)
        self.rows: list[list[float]] = []
        self._current: dict[str, float] = {}

    def register_value(self, name: str) -> None:
        if name not in self.series:
            self.series.append(name)

    def record(self, name: str, value) -> None:
        self._current[name] = float(value)

    def record_step(self, metrics) -> None:
        """Record one frame's StepMetrics (scalar leaves)."""
        self.record_chunk(metrics)

    def record_chunk(self, metrics) -> None:
        """Record a StepMetrics whose leaves have a leading [N] frame axis
        as N frames, in one device-to-host transfer; the rows equal those
        of N ``record_step`` calls. Values given to ``record`` since the
        last frame apply to every frame of the chunk."""
        host = _series_on_host(metrics).tolist()
        extra, self._current = self._current, {}
        for frame in zip(*host):
            row = dict(zip(_METRIC_FIELD_FOR_SERIES, frame))
            row.update(extra)
            self.rows.append([row.get(s, 0.0) for s in self.series])

    def flush_frame(self) -> None:
        self.rows.append([self._current.get(s, 0.0) for s in self.series])
        self._current = {}

    def finish(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.values_path, "w") as f:
            for row in self.rows:
                f.write(",".join(f"{v:g}" for v in row) + "\n")
        with open(self.titles_path, "w") as f:
            f.write("\n".join(self.series) + "\n")

    def reset(self) -> None:
        """On a VO reset: the rows recorded so far are kept (the reference
        keeps one value stream per run), the frame in progress is
        dropped."""
        self._current = {}


class TraceLog:
    """Timestamped trace log (lvt_log)."""

    def __init__(self, out_dir: str = ".", enabled: bool = True):
        self.enabled = enabled
        self._file = None
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
            self._file = open(os.path.join(out_dir, f"vo-{stamp}.txt"), "w")
            self._t0 = time.perf_counter()

    def log(self, message: str) -> None:
        if self._file is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._file.write(f"{ms:.3f} | {message}\n")

    def log_params(self, config) -> None:
        if self._file is not None:
            self.log("Parameters:")
            for f in dataclasses.fields(config):
                self.log(f"  {f.name} = {getattr(config, f.name)}")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(log_dir: str = "lvt_tpu_torch_profile"):
    """``torch.profiler`` over the block (the CPU, and CUDA where it is
    available); writes a Chrome trace and a table of the ops by device
    time to ``log_dir`` and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "cuda_time_total" if len(activities) > 1 else "cpu_time_total"
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
