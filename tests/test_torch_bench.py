"""lvt_tpu_torch.bench (``python -m lvt_tpu_torch bench``) against lvt_tpu's
bench.py: its frames, its config, its JSON line, and a small run of each
mode against lvt_tpu's ``VOSystem.track_chunk``.

bench.py's recipe is written out here with its own literals (its
functions import JAX and run at full size); its module-level constants
are read from the root ``bench`` module, whose top level imports no JAX.
The small runs use tests/test_torch_system.py's 320x240 world and config,
one warm-up chunk and one timed chunk of 3 frames (local BA, window 4,
runs at frame 4), at that file's tolerances: every pose within 1e-3 m of
lvt_tpu's chunks over the same frames, 2e-3 m with BA; the statuses
equal, and BA's window weights (lvt_tpu reports no ``local_ba_ran``).
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import __graft_entry__
import bench as jx_bench
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io.synthetic import SyntheticWorld as JxWorld
from lvt_tpu_torch import bench, cli
from lvt_tpu_torch.core.system import TrackingState
from lvt_tpu_torch.parallel import dryrun
from tests.test_torch_system import _config, _world
from tests.test_torch_system import share_the_cores  # noqa: F401

CHUNK, N_CHUNKS = 3, 1


def _jx_frames(n_frames: int):
    """bench.py's frames (``main`` and ``main_multistream``), its recipe
    through lvt_tpu's SyntheticWorld."""
    config = __graft_entry__._kitti_config()
    world = JxWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    return list(world.stereo_sequence(n_frames, speed=0.9))


def test_constants_are_bench_pys():
    assert (bench.BASELINE_FPS, bench.CHUNK, bench.N_CHUNKS) == (
        jx_bench.BASELINE_FPS, jx_bench.CHUNK, jx_bench.N_CHUNKS)
    src = inspect.getsource(jx_bench.main_multistream)
    assert "chunk, n_chunks = 8, 12" in src and "s = 8 * n_dev" in src
    assert (bench.MS_CHUNK, bench.MS_N_CHUNKS, bench.MS_STREAMS) == (8, 12, 8)
    assert "config.replace(local_ba_window=4)" in inspect.getsource(
        jx_bench.main)
    assert bench.BA_WINDOW == 4


def test_frames_are_bench_pys():
    """main's [N, H, W] uint8 pairs bit-equal to bench.py's, and
    multistream's broadcast [N, S, H, W] as bench.py stacks it."""
    n, s = 3, 3
    frames = _jx_frames(n)
    left, right, rot, pos = bench.render(bench.bench_config(), n)
    np.testing.assert_array_equal(
        left, np.stack([f[0].astype(np.uint8) for f in frames]))
    np.testing.assert_array_equal(
        right, np.stack([f[1].astype(np.uint8) for f in frames]))
    np.testing.assert_array_equal(rot, np.array([f[2][0] for f in frames]))
    np.testing.assert_array_equal(pos, np.array([f[2][1] for f in frames]))
    for side, got in enumerate((left, right)):
        want = np.stack([np.broadcast_to(f[side].astype(np.uint8),
                                         (s,) + f[side].shape)
                         for f in frames])
        batch = bench.stream_frames(torch.from_numpy(got), s)
        assert batch.is_contiguous()
        np.testing.assert_array_equal(batch.numpy(), want)


@pytest.mark.parametrize("ba", [False, True])
def test_config_is_bench_pys(ba):
    want = __graft_entry__._kitti_config()
    if ba:
        want = want.replace(local_ba_window=4)
    got = bench.bench_config(ba)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def small():
    world = _world()
    cfg = _config(world)
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(CHUNK * (N_CHUNKS + 1),
                                                   speed=0.5)]
    return cfg, (np.stack([f[0] for f in frames]),
                 np.stack([f[1] for f in frames]))


@pytest.fixture(scope="module")
def main_runs(small):
    cfg, frames = small
    return {ba: bench.run_main(cfg, ba=ba, chunk=CHUNK, n_chunks=N_CHUNKS,
                               device="cpu", frames=frames)
            for ba in (False, True)}


@pytest.mark.parametrize("ba", [False, True])
def test_small_run_matches_lvt_tpu(small, main_runs, ba):
    """main and --ba: a warm-up chunk and a timed chunk through the port's
    bench, against lvt_tpu's VOSystem.track_chunk on the same chunks."""
    cfg, (il, ir) = small
    run = main_runs[ba]
    jvo = JxVOSystem(cfg.replace(local_ba_window=4) if ba else cfg)
    jt, jstatus = [], []
    for c in range(N_CHUNKS + 1):
        p, m = jvo.track_chunk(il[c * CHUNK:(c + 1) * CHUNK],
                               ir[c * CHUNK:(c + 1) * CHUNK])
        jt.append(np.asarray(p.t))
        jstatus.append(np.asarray(m.status))
    np.testing.assert_allclose(run["poses"].t.numpy(), np.concatenate(jt),
                               atol=2e-3 if ba else 1e-3)
    status = run["metrics"].status.numpy()
    np.testing.assert_array_equal(status, np.concatenate(jstatus))
    assert (status == TrackingState.TRACKING).all()
    # lvt_tpu reports no local_ba_ran: BA on its schedule (frame 4), and
    # the BA window's weights as lvt_tpu's
    np.testing.assert_array_equal(
        run["metrics"].local_ba_ran.numpy(),
        ba & (np.arange(CHUNK * (N_CHUNKS + 1)) == 4))
    if ba:
        np.testing.assert_array_equal(
            run["system"].state.ba.w.numpy() > 0,
            np.asarray(jvo.state.ba.w) > 0)
    assert run["config"].local_ba_window == (4 if ba else 0)
    # on the CPU: no graph, no sync count
    assert run["captures"] == 0 and run["syncs"] is None
    assert run["fps"] == pytest.approx(CHUNK * N_CHUNKS / run["seconds"])


def test_multistream_streams_equal_each_other_and_a_single_stream(
        small, main_runs):
    cfg, frames = small
    run = bench.run_multistream(cfg, streams=2, chunk=CHUNK,
                                n_chunks=N_CHUNKS, device="cpu",
                                frames=frames)
    assert (run["streams"], run["world"]) == (2, 1)
    t, q = run["poses"].t, run["poses"].q
    assert t.shape == (CHUNK * (N_CHUNKS + 1), 2, 3)
    single = main_runs[False]["poses"]
    for i in range(2):
        assert torch.equal(t[:, i], single.t)
        assert torch.equal(q[:, i], single.q)
    assert (run["metrics"].status.numpy() == TrackingState.TRACKING).all()
    assert run["fps"] == pytest.approx(
        CHUNK * N_CHUNKS * 2 / run["seconds"])


# bench.py's metric strings, word for word (bench.py:89-91 and :157-158)
METRICS = {
    (): "frames/sec/chip (KITTI-geometry stereo VO, synthetic world)",
    ("--ba",): "frames/sec/chip (KITTI-geometry stereo VO, synthetic "
               "world, local BA window=4)",
    ("--multistream", "--streams", "2"):
        "frames/sec/chip (multistream S=2, 1 devices, KITTI-geometry "
        "stereo VO)",
}


def test_metric_strings_are_bench_pys():
    main_src = inspect.getsource(jx_bench.main)
    assert '"frames/sec/chip (KITTI-geometry stereo VO, "' in main_src
    assert 'f"synthetic world{suffix})"' in main_src
    assert 'suffix = ", local BA window=4" if ba else ""' in main_src
    ms_src = inspect.getsource(jx_bench.main_multistream)
    assert ('"metric": f"frames/sec/chip (multistream S={s}, {n_dev} '
            'devices, "') in ms_src
    assert '"KITTI-geometry stereo VO)"' in ms_src


@pytest.fixture
def small_sizes(monkeypatch, small):
    """bench's sizes cut to the small world: its config, frames of it,
    one warm-up and one timed chunk of 2."""
    cfg, _ = small
    monkeypatch.setattr(bench, "bench_config", lambda ba=False: cfg)
    monkeypatch.setattr(bench, "CHUNK", 2)
    monkeypatch.setattr(bench, "N_CHUNKS", 1)
    monkeypatch.setattr(bench, "MS_CHUNK", 2)
    monkeypatch.setattr(bench, "MS_N_CHUNKS", 1)


@pytest.mark.parametrize("entry", ["cli", "module"])
@pytest.mark.parametrize("flags", list(METRICS))
def test_json_line(capsys, small_sizes, flags, entry):
    """``python -m lvt_tpu_torch bench`` and ``python -m
    lvt_tpu_torch.bench``, each mode: one JSON line with bench.py's four
    keys and metric string, and the device."""
    if entry == "cli":
        assert cli.main(["bench", "--device", "cpu", *flags]) == 0
    else:
        assert bench.main(["--device", "cpu", *flags]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    got = json.loads(line)
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "device"]
    assert got["metric"] == METRICS[flags]
    assert got["unit"] == "frames/s" and got["device"] == "cpu"
    assert got["value"] > 0
    assert abs(got["vs_baseline"] - got["value"] / 70.0) < 1e-3


@pytest.mark.parametrize("flags", [(), ("--multistream",)])
def test_cuda_without_cuda_raises(monkeypatch, small_sizes, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["bench", *flags])             # default --device cuda


def test_multistream_over_ranks_counts_streams_per_rank():
    """Two gloo ranks: S = 8 x 2 streams, 8 per rank in blocks, the slowest
    rank's seconds on both, and the figure divided by the world size."""
    config, *_ = dryrun._tiny()
    ranks = dryrun.spawn([dryrun.job(bench.multistream_rank, config=config,
                                     chunk=1, n_chunks=1, device="cpu")], 2)
    (r0,), (r1,) = ranks
    assert (r0["streams"], r0["world"]) == (16, 2) == (r1["streams"],
                                                       r1["world"])
    assert r0["local_streams"] == list(range(8))
    assert r1["local_streams"] == list(range(8, 16))
    assert r0["seconds"] == r1["seconds"]
    assert r0["fps"] == pytest.approx(16 / r0["seconds"] / 2)
    assert r0["line"]["metric"] == ("frames/sec/chip (multistream S=16, 2 "
                                    "devices, KITTI-geometry stereo VO)")
    assert r0["line"]["value"] == round(r0["fps"], 2)
