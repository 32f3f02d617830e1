"""lvt_tpu_torch's observability and visualization against lvt_tpu's, on
the CPU: the metrics recorder's and the trace log's files, the profiler
stages, the HTML map viewer and the matplotlib drawings.

Tolerances: none. The recorder's files for equal metrics are lvt_tpu's
byte for byte; the trace log's lines equal lvt_tpu's past their ms stamp;
the viewer embeds lvt_tpu's page around the same per-frame fields.
"""

import dataclasses
import glob
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig as JxVOConfig
from lvt_tpu.core.state import StepMetrics as JxStepMetrics
from lvt_tpu.observability import TraceLog as JxTraceLog
from lvt_tpu.observability import ValueRecorder as JxValueRecorder
from lvt_tpu import viz_html as jx_viz_html
from lvt_tpu_torch import observability, viz, viz_html
from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core.state import StepMetrics
from lvt_tpu_torch.core.system import TrackingState, VOSystem
from lvt_tpu_torch.observability import (REFERENCE_SERIES, TraceLog,
                                         ValueRecorder)
from tests.test_end_to_end import make_config, make_world
from tests.test_torch_system import share_the_cores  # noqa: F401


def _config():
    world = make_world()
    return world, VOConfig(**dataclasses.asdict(make_config(world)))


def _metrics(n, seed=0):
    """A chunk of n frames of metrics for both packages, the same values."""
    rs = np.random.RandomState(seed)
    vals = {}
    for f, t in zip(StepMetrics._fields, StepMetrics.zero()):
        if t.dtype == torch.int32:
            vals[f] = rs.randint(0, 2000, n).astype(np.int32)
        elif t.dtype == torch.float32:
            vals[f] = (rs.rand(n) * 300).astype(np.float32)
        else:
            vals[f] = rs.rand(n) < 0.5
    ours = StepMetrics(**{k: torch.from_numpy(v) for k, v in vals.items()})
    theirs = JxStepMetrics(**{k: jnp.asarray(vals[k])
                              for k in JxStepMetrics._fields})
    return ours, theirs


def test_value_recorder_files_are_lvt_tpus(tmp_path):
    ours, theirs = _metrics(6)
    rec, jrec = ValueRecorder(str(tmp_path / "a")), \
        JxValueRecorder(str(tmp_path / "b"))
    for r in (rec, jrec):
        r.register_value("extra series")
        r.record("extra series", 7.5)
    rec.record_chunk(ours)
    jrec.record_chunk(theirs)
    for i in range(2):   # then two frames one by one
        rec.record_step(type(ours)(*(x[i] for x in ours)))
        jrec.record_step(type(theirs)(*(x[i] for x in theirs)))
    for r in (rec, jrec):
        r.finish()
    for name in ("measurments.txt", "titles.txt"):
        a = (tmp_path / "a" / name).read_bytes()
        assert a == (tmp_path / "b" / name).read_bytes(), name
    rows = (tmp_path / "a" / "measurments.txt").read_text().splitlines()
    assert len(rows) == 8
    titles = (tmp_path / "a" / "titles.txt").read_text().splitlines()
    assert titles == REFERENCE_SERIES + ["extra series"]
    # a value given to record() applies to every frame of the chunk
    assert all(r.split(",")[-1] == "7.5" for r in rows[:6])
    assert all(r.split(",")[-1] == "0" for r in rows[6:])


def test_record_chunk_reads_the_device_once(monkeypatch, tmp_path):
    calls = []
    real = observability._series_on_host
    monkeypatch.setattr(observability, "_series_on_host",
                        lambda m: calls.append(1) or real(m))
    ours, _ = _metrics(16)
    rec = ValueRecorder(str(tmp_path))
    rec.record_chunk(ours)
    assert len(calls) == 1 and len(rec.rows) == 16
    host = real(ours)
    assert host.dtype == torch.float64 and host.shape == (10, 16)
    np.testing.assert_array_equal(host[2].numpy(),
                                  ours.image_keypoints.numpy())


def test_value_recorder_reset_keeps_prior_rows(tmp_path):
    """As tests/test_observability.py's test of lvt_tpu's recorder."""
    rec = ValueRecorder(out_dir=str(tmp_path))
    for v in (1.0, 2.0):
        rec.record("inlier count", v)
        rec.flush_frame()
    rec.record("inlier count", 99.0)   # in progress, dropped by reset
    rec.reset()
    rec.record("inlier count", 3.0)
    rec.flush_frame()
    rec.finish()
    rows = open(tmp_path / "measurments.txt").read().strip().splitlines()
    col = REFERENCE_SERIES.index("inlier count")
    assert [float(r.split(",")[col]) for r in rows] == [1.0, 2.0, 3.0]


def test_trace_log_is_lvt_tpus(tmp_path):
    logs = {}
    for name, log, cfg in (("port", TraceLog, VOConfig),
                           ("jax", JxTraceLog, JxVOConfig)):
        d = tmp_path / name
        t = log(out_dir=str(d))
        t.log("hello")
        t.log_params(cfg(img_width=10, img_height=10))
        t.close()
        (path,) = glob.glob(str(d / "vo-*.txt"))
        lines = open(path).read().splitlines()
        assert all(float(x.split(" | ")[0]) >= 0 for x in lines)
        logs[name] = [x.split(" | ", 1)[1] for x in lines]
    assert logs["port"] == logs["jax"]
    assert "  img_width = 10" in logs["port"]
    assert TraceLog(str(tmp_path / "off"), enabled=False)._file is None
    assert not (tmp_path / "off").exists()


def test_vosystem_trace_log_and_recorder(tmp_path):
    """As tests/test_observability.py's tests of lvt_tpu's VOSystem:
    enable_logging makes vo-*.txt with the parameters, one line per frame
    and the reset; an attached recorder gets one row per frame."""
    world, cfg = _config()
    rec = ValueRecorder(out_dir=str(tmp_path / "rec"))
    vo = VOSystem(cfg.replace(enable_logging=True), metrics_recorder=rec,
                  log_dir=str(tmp_path), device="cpu")
    for img_l, img_r, _ in world.stereo_sequence(3, speed=0.4):
        vo.track(img_l, img_r)
    vo.reset()
    vo.trace_log.close()
    rec.finish()
    (path,) = glob.glob(str(tmp_path / "vo-*.txt"))
    text = open(path).read()
    assert "Parameters:" in text and "fx = " in text
    assert text.count("Frame #") == 3 and "VO was just reset." in text
    rows = open(tmp_path / "rec" / "measurments.txt").read().splitlines()
    assert len(rows) == 3
    assert all(len(r.split(",")) == len(REFERENCE_SERIES) for r in rows)


def test_profiler_stages_and_profile_trace(tmp_path):
    """The step's profiler ranges carry lvt_tpu's named_scope names, and
    profile_trace writes a trace and an op table that lists them."""
    import inspect

    from lvt_tpu_torch.core import extract, step

    step_src, extract_src = inspect.getsource(step), inspect.getsource(extract)
    for name in ("motion_predict", "map_matching", "pnp_solve",
                 "map_bookkeeping", "staged_update", "triangulation",
                 "local_ba", "rectify"):
        assert f'stage("{name}")' in step_src, name
    for name in ("perception", "corner_select", "patch_describe",
                 "corner_select_describe"):
        assert f'stage("{name}")' in extract_src, name
    world, cfg = _config()
    vo = VOSystem(cfg, device="cpu")
    frames = list(world.stereo_sequence(2, speed=0.4))
    with observability.profile_trace(str(tmp_path)) as prof:
        for l, r, _ in frames:
            vo.track(l, r)
    keys = {e.key for e in prof.key_averages()}
    assert {"perception", "map_matching", "pnp_solve"} <= keys
    assert (tmp_path / "trace.json").stat().st_size > 1000
    assert "pnp_solve" in (tmp_path / "ops.txt").read_text()


# ---- visualization
def test_html_viewer_from_the_cli(tmp_path):
    """--viz writes lvt_tpu's self-contained viewer.html with one embedded
    frame per tracked frame (pose, map points with their age, staged
    points), as tests/test_viz.py checks lvt_tpu's."""
    from lvt_tpu_torch.cli import main

    out = tmp_path / "viz"
    assert main(["synthetic", "--frames", "4", "--viz", str(out),
                 "--device", "cpu"]) == 0
    html = (out / "viewer.html").read_text()
    m = re.search(r"const FRAMES=(\[.*?\]);\n", html, re.S)
    frames = json.loads(m.group(1))
    assert len(frames) == 4
    last = frames[-1]
    assert set(last) == {"t", "R", "map", "age", "staged"}
    assert len(last["map"]) > 50 and len(last["map"]) == len(last["age"])
    assert last["t"][2] > 1.0
    assert html.replace(m.group(1), "__DATA__") == jx_viz_html._HTML
    assert viz_html._HTML == jx_viz_html._HTML


def test_html_viewer_snapshot_is_the_state(tmp_path):
    world, cfg = _config()
    vo = VOSystem(cfg, device="cpu")
    for l, r, _ in world.stereo_sequence(2, speed=0.4):
        vo.track(l, r)
    viewer = viz_html.HtmlMapViewer(str(tmp_path), max_points=10 ** 6)
    viewer.update(vo)
    snap = viewer.frames[0]
    valid = vo.state.map.valid
    assert len(snap["map"]) == int(valid.sum())
    np.testing.assert_allclose(snap["map"], vo.state.map.pos[valid].numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(snap["t"], vo.last_pose.t.numpy(), atol=5e-5)
    assert snap["age"] == vo.state.map.age[valid].tolist()


def test_matplotlib_drawings(tmp_path):
    pytest.importorskip("matplotlib")
    world, cfg = _config()
    rs = np.random.RandomState(3)
    img = rs.uniform(0, 255, (120, 160))
    kp = np.stack([rs.uniform(0, 160, 30), rs.uniform(0, 120, 30)], -1)
    p = viz.draw_features(img, kp, np.ones(30, bool), rs.randint(-1, 15, 30),
                          out_path=str(tmp_path / "f.png"))
    assert os.path.getsize(p) > 1000
    vo = VOSystem(cfg, device="cpu")
    dumper = viz.FrameDumper(str(tmp_path / "frames"))
    traj, last = [], None
    for l, r, _ in world.stereo_sequence(4, speed=0.4):
        traj.append(vo.track(l, r).t.numpy())
        last = l
    assert vo.get_state() == TrackingState.TRACKING
    assert os.path.getsize(viz.draw_map(
        vo.state, np.array(traj), out_path=str(tmp_path / "m.png"))) > 1000
    assert os.path.getsize(viz.plot_trajectories(
        {"est": np.array(traj)}, out_path=str(tmp_path / "t.png"))) > 1000
    # the live frame: extraction and matching against the current map
    disp, kp, valid, age = viz.feature_debug(vo, last)
    assert disp.shape == last.shape and valid.any()
    assert (age[valid] >= 0).sum() > 10 and (age > 0).any()
    dumper.update(vo, last)
    assert (tmp_path / "frames" / "features_000000.png").stat().st_size > 1000
    assert (tmp_path / "frames" / "map_000000.png").exists()
