"""``python -m lvt_tpu_torch kitti|euroc|tum|synthetic`` against
``python -m lvt_tpu ...``, on the CPU, on tiny synthetic trees in the real
directory layouts (tests/test_cli.py's trees: 320x240, 10 KITTI frames,
8 TUM frames), and VOSystem's recorder and trace log (H11).

Tolerances:
  * kitti (chunk 1 and 4) and tum: every position within 1e-3 m of
    lvt_tpu's CLI on the same tree (the bound test_torch_system.py gives
    the jitted JAX chunk; on the KITTI tree the gap is 9.4e-5 m or less
    up to frame 7 and 9.35e-4 m at frame 8). The port's chunk-1 and
    chunk-4 files are byte-equal (a chunk is N ``track`` calls), so
    lvt_tpu's CLI runs once, at chunk 4 (its chunk-1 file gives the same
    gaps);
  * euroc: on float frames lvt_tpu's CPU path box-sums otherwise than its
    Pallas kernel A (about 20% of a rectified frame's descriptors differ,
    tests/test_torch_rectified.py), and the port follows kernel A. So the
    port's file is held byte-equal to ``dump_tum`` of the port's own
    in-process rectified ``track_chunk`` over the same raw frames, and its
    ``measurments.txt`` row for row against lvt_tpu's CLI with kernel A in
    interpret mode: counts equal, means within 1e-4 (``_same_rows``);
  * synthetic: lvt_tpu's printed ATE within 1e-3 m;
  * the recorder: ``record_chunk`` rows equal N ``record_step`` rows, and
    lvt_tpu's rows as ``_same_rows`` holds them; the trace log has
    lvt_tpu's lines.
"""

import dataclasses
import functools
import glob
import os
import re

import numpy as np
import pytest
import torch

from lvt_tpu.cli import main as jx_main
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io.synthetic import SyntheticWorld
from lvt_tpu.observability import ValueRecorder as JxValueRecorder
from lvt_tpu.ops import perception_pallas as jx_pp
from lvt_tpu_torch.cli import main
from lvt_tpu_torch.config import VOConfig, load_config
from lvt_tpu_torch.core.system import SensorType, TrackingState, VOSystem
from lvt_tpu_torch.io import datasets
from lvt_tpu_torch.io.trajectory import (ate_rmse_aligned, dump_tum,
                                         load_kitti, load_tum)
from lvt_tpu_torch.observability import REFERENCE_SERIES, ValueRecorder
from tests.test_cli import kitti_tree  # noqa: F401
from tests.test_end_to_end import make_config, make_world
from tests.test_torch_system import share_the_cores  # noqa: F401

cv2 = pytest.importorskip("cv2")

N_INT_SERIES = (0, 1, 2, 3, 9)   # counts among REFERENCE_SERIES


def _kitti_args(root, out, chunk):
    return ["kitti", "--sequences-dir", str(root / "sequences"), "--seq", "3",
            "--calib", str(root / "calib_03.yaml"),
            "--config", str(root / "vo.yaml"), "--output", str(out),
            "--chunk", str(chunk)]


@pytest.fixture(scope="module")
def kitti_runs(kitti_tree, tmp_path_factory):  # noqa: F811
    """The port's kitti CLI at chunk 1 and 4 and lvt_tpu's at chunk 4, each
    run once for the module: {name: path}."""
    root, gt = kitti_tree
    d = tmp_path_factory.mktemp("kitti_out")
    out = {}
    for chunk in (1, 4):
        out[chunk] = d / f"port_{chunk}.txt"
        assert main(_kitti_args(root, out[chunk], chunk)
                    + ["--device", "cpu"]) == 0
    out["jax"] = d / "jax.txt"
    assert jx_main(_kitti_args(root, out["jax"], 4)) == 0
    return out, gt


@pytest.mark.parametrize("chunk", [1, 4])
def test_kitti_cli_matches_lvt_tpu(kitti_runs, chunk):
    out, gt = kitti_runs
    ours, theirs = load_kitti(str(out[chunk])), load_kitti(str(out["jax"]))
    assert ours.shape == theirs.shape == (10, 3, 4)
    np.testing.assert_allclose(ours[:, :, 3], theirs[:, :, 3], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(ours[:, :, :3], theirs[:, :, :3], atol=1e-3,
                               rtol=0)
    assert ate_rmse_aligned(ours[:, :, 3], gt) < 0.3
    assert out[chunk].read_bytes() == out[1].read_bytes()


def test_kitti_cli_chunk_truncates_at_lost(kitti_tree, tmp_path):  # noqa: F811
    """As tests/test_cli.py's test: the camera is blinded from frame 5 on,
    and chunk mode cuts the file at the first LOST frame."""
    root, _ = kitti_tree
    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    seq = tmp_path / "sequences" / "04"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    blank = np.full((240, 320), 40, np.uint8)
    for i, (l, r, _) in enumerate(world.stereo_sequence(10, speed=0.5)):
        if i >= 5:
            l = r = blank
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), l.astype(np.uint8))
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), r.astype(np.uint8))
    out = tmp_path / "04.txt"
    args = _kitti_args(root, out, 4)
    args[args.index("--sequences-dir") + 1] = str(tmp_path / "sequences")
    args[args.index("--seq") + 1] = "4"
    assert main(args + ["--device", "cpu"]) == 0
    # frames 0-4 tracked, frame 5 is the first LOST: exactly 6 poses
    assert load_kitti(str(out)).shape == (6, 3, 4)


def test_cli_without_cuda_exits_nonzero(kitti_tree, tmp_path,  # noqa: F811
                                        monkeypatch):
    """No --device and no CUDA: the run fails with resolve_device's error
    before it reads a frame, and writes nothing."""
    root, _ = kitti_tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.txt"
    with pytest.raises(RuntimeError, match="cuda"):
        main(_kitti_args(root, out, 4))
    assert not out.exists()


def _tum_tree(root):
    """tests/test_cli.py's TUM tree and YAML."""
    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, n_points=1200,
                           extent_x=40.0, extent_y=18.0, extent_z=20.0)
    data = root / "rgbd_dataset_synthetic"
    (data / "rgb").mkdir(parents=True)
    (data / "depth").mkdir(parents=True)
    lines, gt = [], []
    for i, (g, d, (_, t)) in enumerate(world.rgbd_sequence(8, speed=0.2)):
        ts = 1000.0 + i * 0.1
        cv2.imwrite(str(data / "rgb" / f"{ts:.6f}.png"), g.astype(np.uint8))
        d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(str(data / "depth" / f"{ts:.6f}.png"), d16)
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
        gt.append(t)
    assoc = root / "assoc.txt"
    assoc.write_text("\n".join(lines) + "\n")
    cfg = root / "tum.yaml"
    cfg.write_text(
        "fx: 260.0\nfy: 260.0\ncx: 160.0\ncy: 120.0\n"
        "img_width: 320\nimg_height: 240\n"
        "near_plane_distance: 0.1\nfar_plane_distance: 40.0\n"
        "agast_threshold: 15\ndetection_cell_size: 2000\n"
        "max_keypoints_per_cell: 400\nstaged_threshold: 0\n"
        "triangulation_policy: 2\nmax_map_points: 4096\n"
        "max_staged_points: 512\n")
    return data, assoc, cfg, np.array(gt)


def test_tum_cli_matches_lvt_tpu(tmp_path):
    data, assoc, cfg, gt = _tum_tree(tmp_path)
    args = ["tum", "--dataset-dir", str(data), "--association", str(assoc),
            "--config", str(cfg)]
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert main(args + ["--output", str(a), "--device", "cpu"]) == 0
    assert jx_main(args + ["--output", str(b)]) == 0
    (ts, ours), (jts, theirs) = load_tum(str(a)), load_tum(str(b))
    assert len(ts) == 8
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(ours, theirs, atol=1e-3, rtol=0)
    assert ate_rmse_aligned(ours, gt) < 0.3


def _euroc_tree(root, n):
    """test_torch_rectified.py's scene (points 2-30 m away), raw frames
    0.2 m apart written in the EuRoC layout, and test_cli.py's EuRoC YAML
    in patch mode (lvt_tpu would pick the dense mode off the TPU, the port
    the patch mode: their features are the same, the YAML only makes the
    two runs take one code path)."""
    rs = np.random.RandomState(5)
    n_pts = 2500
    points = np.stack([rs.uniform(-15, 15, n_pts), rs.uniform(-8, 8, n_pts),
                       rs.uniform(2.0, 30.0, n_pts)], -1)
    shade = rs.uniform(60.0, 215.0, n_pts)
    names = [f"{1403636579763555584 + i * 50000000}" for i in range(n)]
    raw = {}
    for cam, right in (("cam0", False), ("cam1", True)):
        d = root / "V9_99" / "mav0" / cam / "data"
        d.mkdir(parents=True)
        raw[cam] = np.stack([datasets.render_euroc_raw(
            points, shade, np.array([0.0, 0.0, 0.2 * i]), right)
            for i in range(n)])
        for name, img in zip(names, raw[cam]):
            cv2.imwrite(str(d / f"{name}.png"), img)
    stamps = root / "stamps.txt"
    stamps.write_text("\n".join(names) + "\n")
    cfg = root / "euroc.yaml"
    cfg.write_text(
        "near_plane_distance: 0.5\nfar_plane_distance: 100.0\n"
        "agast_threshold: 15\ndetection_cell_size: 160\n"
        "max_keypoints_per_cell: 60\nmax_map_points: 1024\n"
        "max_staged_points: 1024\ndescriptor_mode: patch\n")
    return stamps, cfg, raw["cam0"], raw["cam1"]


def _same_rows(ours, theirs, printed=False):
    """Counts equal; means within 1e-4, or 1e-6 of their size: they are
    float32 sums taken in another order, and the second-distance mean
    takes in the no-candidate distance and reaches 4e6 (one float32 step
    there is 0.5). Read from a file (``printed``), within one unit of the
    sixth significant digit, the resolution of the ``%g`` the file is
    written with (a mean of 159.0035 prints as 159.003 or 159.004)."""
    ints = list(N_INT_SERIES)
    np.testing.assert_array_equal(ours[:, ints], theirs[:, ints])
    np.testing.assert_allclose(ours, theirs, atol=1e-4,
                               rtol=1e-5 if printed else 1e-6)


def _rows(path):
    return np.array([[float(v) for v in line.split(",")]
                     for line in open(path).read().strip().splitlines()])


def test_euroc_cli_is_the_in_process_chunk(tmp_path, monkeypatch):
    n, chunk = 4, 2
    stamps, cfg, left, right = _euroc_tree(tmp_path, n)
    args = ["euroc", "--root", str(tmp_path), "--dataset", "V9_99",
            "--stamps", str(stamps), "--config", str(cfg), "--chunk",
            str(chunk), "--record"]
    monkeypatch.chdir(tmp_path / "V9_99")
    out = tmp_path / "port.txt"
    assert main(args + ["--output", str(out), "--device", "cpu"]) == 0
    ours = _rows("measurments.txt")
    assert open("titles.txt").read().splitlines() == REFERENCE_SERIES

    seq = datasets.EurocSequence(str(tmp_path), "V9_99", str(stamps))
    config = seq.configure(load_config(str(cfg)))
    vo = VOSystem(config, rectify_maps=(seq.map_l, seq.map_r), device="cpu")
    poses = []
    for c in range(0, n, chunk):
        p, m = vo.track_chunk(left[c:c + chunk], right[c:c + chunk])
        assert (m.status == TrackingState.TRACKING).all()
        poses += [datasets.euroc_body_pose(type(p)(t, q))
                  for t, q in zip(p.t, p.q)]
    want = tmp_path / "in_process.txt"
    dump_tum(str(want), poses, seq.stamps)
    assert out.read_bytes() == want.read_bytes()

    # lvt_tpu's CLI with its Pallas kernel A (interpret mode) on the tree
    monkeypatch.setattr(jx_pp, "perception_patch_maps_batched",
                        functools.partial(jx_pp.perception_patch_maps_batched,
                                          interpret=True))
    cfg.write_text(cfg.read_text() + "use_pallas_perception: 1\n")
    monkeypatch.chdir(tmp_path)
    assert jx_main(args + ["--output", str(tmp_path / "jax.txt")]) == 0
    theirs = _rows("measurments.txt")
    assert ours.shape == theirs.shape == (n, len(REFERENCE_SERIES))
    _same_rows(ours, theirs, printed=True)


def test_synthetic_cli_matches_lvt_tpu(capsys):
    assert main(["synthetic", "--frames", "4", "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jx_main(["synthetic", "--frames", "4"]) == 0
    theirs = capsys.readouterr().out
    pattern = r"ATE RMSE: ([0-9.]+) m over ([0-9.]+) m"
    (a, da), (b, db) = (map(float, re.search(pattern, s).groups())
                        for s in (ours, theirs))
    assert abs(a - b) <= 1e-3 and da == db
    assert "status: TRACKING" in ours


# ---- VOSystem's lvt_tpu surface: positional arguments, recorder, trace log
def _world_and_configs():
    world = make_world()
    jx_cfg = make_config(world)
    return world, jx_cfg, VOConfig(**dataclasses.asdict(jx_cfg))


def test_vosystem_takes_lvt_tpus_positional_arguments(tmp_path):
    """As lvt_tpu's cli.py (:46, :136, :171) and capi.py call it."""
    _, _, cfg = _world_and_configs()
    rec = ValueRecorder(str(tmp_path))
    vo = VOSystem(cfg, SensorType.STEREO, rec, None, str(tmp_path), None,
                  device="cpu")
    assert (vo.metrics_recorder, vo.trace_log, vo.rectify_maps) == (
        rec, None, None)
    maps = datasets.euroc_rectify_maps()
    w, h = datasets.EUROC_SIZE
    ecfg = cfg.replace(img_width=w, img_height=h)
    vo = VOSystem(ecfg, metrics_recorder=rec, rectify_maps=maps,
                  device="cpu")
    assert vo.rectify_maps[0].shape == (h, w, 2)
    assert VOSystem(ecfg, SensorType.STEREO, None, None, ".", maps,
                    device="cpu").rectify_maps is not None
    assert VOSystem.create(cfg, SensorType.RGBD, device="cpu").sensor_type \
        == SensorType.RGBD


def test_record_chunk_rows_equal_per_frame_rows_and_lvt_tpus(tmp_path):
    world, jx_cfg, cfg = _world_and_configs()
    frames = list(world.stereo_sequence(5, speed=0.4))
    il = np.stack([f[0] for f in frames]).astype(np.uint8)
    ir = np.stack([f[1] for f in frames]).astype(np.uint8)
    rec_chunk = ValueRecorder(str(tmp_path / "chunk"))
    VOSystem(cfg, metrics_recorder=rec_chunk, device="cpu").track_chunk(
        il, ir)
    rec_chunk.finish()
    rec_frame = ValueRecorder(str(tmp_path / "frame"))
    vo = VOSystem(cfg, metrics_recorder=rec_frame, device="cpu")
    for a, b in zip(il, ir):
        vo.track(a, b)
    rec_frame.finish()
    jx_rec = JxValueRecorder(str(tmp_path / "jax"))
    JxVOSystem(jx_cfg, metrics_recorder=jx_rec).track_chunk(il, ir)
    jx_rec.finish()
    chunk, frame = (open(tmp_path / d / "measurments.txt").read()
                    for d in ("chunk", "frame"))
    assert len(chunk.splitlines()) == 5 and chunk == frame
    _same_rows(np.array(rec_chunk.rows), np.array(jx_rec.rows))
    for d in ("chunk", "jax"):
        assert open(tmp_path / d / "titles.txt").read().splitlines() == \
            REFERENCE_SERIES


def test_trace_log_lines_match_lvt_tpus(tmp_path):
    """enable_logging makes a TraceLog in log_dir: the parameters, one line
    per tracked frame and the reset, as lvt_tpu writes them (the stamps
    aside)."""
    world, jx_cfg, cfg = _world_and_configs()
    frames = [f[:2] for f in world.stereo_sequence(3, speed=0.4)]
    logs = {}
    for name, make in (
            ("port", lambda d: VOSystem(cfg.replace(enable_logging=True),
                                        log_dir=d, device="cpu")),
            ("jax", lambda d: JxVOSystem(
                jx_cfg.replace(enable_logging=True), log_dir=d))):
        d = str(tmp_path / name)
        vo = make(d)
        for l, r in frames:
            vo.track(l, r)
        vo.reset()
        vo.trace_log.close()
        (path,) = glob.glob(os.path.join(d, "vo-*.txt"))
        lines = open(path).read().splitlines()
        for line in lines:
            float(line.split("|")[0])   # stamped in ms
        logs[name] = [line.split(" | ", 1)[1] for line in lines]
    assert logs["port"] == logs["jax"]
    assert sum(x.startswith("Frame #") for x in logs["port"]) == 3
    assert logs["port"][-1] == "VO was just reset."
    assert "Frame #3: status=TRACKING" in logs["port"][-2]
