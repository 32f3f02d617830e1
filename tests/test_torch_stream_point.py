"""lvt_tpu_torch's 2-D ``stream x points`` mode (parallel/stream_point.py)
and the stream-parallel ``MultiStreamVO(mesh=...)`` / ``MultiHostStreamVO``
(parallel/multistream.py, parallel/multihost.py) over gloo processes on
the CPU.

The worlds are tests/test_stream_point.py's: stream s sees its own world
(seed 100 + 7 s) at its own speed (0.3 + 0.1 s m per frame), 256x192,
uint8 frames. The port's ranks run in processes spawned from the test
(``parallel.dryrun.spawn``). Tolerances:
  * ``StreamPointVO`` 2 streams x 2 point shards over 4 ranks, 3 frames,
    against lvt_tpu's ``StreamPointVO`` on ``stream_point_mesh(2, 2)``:
    every stream's poses within 2e-3 m, lvt_tpu's own bound for its 2-D
    step against single streams (tests/test_stream_point.py: its 2-D step
    extracts all 2S images as one batch, which XLA fuses otherwise than a
    pair, so corner scores move at float level), statuses equal; against
    the port's own ``VOSystem`` per stream: within 3e-4 m and map sizes
    equal (the sharded bound of test_torch_sharded.py); both ranks of a
    points group hold the same poses; no op falls back to vmap's
    per-sample loop (the collectives run under vmap through their batching
    rule);
  * ``MultiStreamVO(mesh=)`` at 2 ranks x 2 streams: each rank's streams
    bit-equal to the same streams of the one-process 4-stream run (streams
    are independent, and a stream's sums do not depend on S: ROADMAP H8);
    ``MultiHostStreamVO`` fed only each rank's streams: the same, and
    ``all_poses`` gathers every stream's last pose in stream order;
  * ``convert.shard_state`` on lvt_tpu's ``batched_state_specs`` layout:
    every device's block of a random state placed on the 2 x 2 mesh equal
    to the port's cut of the whole state, leaf by leaf, and
    ``gather_state`` of the blocks equal to the whole: exact (a copy).
"""

import dataclasses

import jax
import numpy as np
import pytest

from lvt_tpu.config import VOConfig as JxVOConfig
from lvt_tpu.io.synthetic import SyntheticWorld
from jax.sharding import NamedSharding

from lvt_tpu.parallel import mesh as jx_mesh
from lvt_tpu.parallel.multistream import batched_initial_state
from lvt_tpu.parallel.stream_point import StreamPointVO as JxStreamPointVO
from lvt_tpu.parallel.stream_point import batched_state_specs as jx_specs
from lvt_tpu_torch import config as port_config
from lvt_tpu_torch import convert
from lvt_tpu_torch.core.state import TRACKING
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.parallel import dryrun
from lvt_tpu_torch.parallel.multistream import MultiStreamVO
from lvt_tpu_torch.parallel.stream_point import (POINT_AXIS, STREAM_AXIS,
                                                 batched_state_specs)
from lvt_tpu_torch.tree import flatten_with_path
from tests.test_torch_system import share_the_cores  # noqa: F401

N_FRAMES = 3


def world(seed):
    return SyntheticWorld(width=256, height=192, fx=210.0, fy=210.0,
                          cx=128.0, cy=96.0, baseline=0.25, n_points=1200,
                          extent_x=30.0, extent_y=14.0, extent_z=60.0,
                          seed=seed)


def jx_config() -> JxVOConfig:
    w = world(100)
    return JxVOConfig(
        fx=w.fx, fy=w.fy, cx=w.cx, cy=w.cy, baseline=w.baseline,
        img_width=w.width, img_height=w.height, detection_cell_size=96,
        max_keypoints_per_cell=48, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=90.0,
        max_map_points=1024, max_staged_points=1024)


def ours() -> port_config.VOConfig:
    return port_config.VOConfig(**dataclasses.asdict(jx_config()))


def divergent(n_frames, n_streams):
    """[N, S, H, W] uint8 left and right, stream s in its own world."""
    seqs = [list(world(100 + 7 * s).stereo_sequence(n_frames,
                                                    speed=0.3 + 0.1 * s))
            for s in range(n_streams)]
    u8 = lambda x: x.astype(np.uint8)  # noqa: E731
    return tuple(np.stack([np.stack([u8(seqs[s][f][side])
                                     for s in range(n_streams)])
                           for f in range(n_frames)]) for side in (0, 1))


@pytest.fixture(scope="module")
def frames2():
    return divergent(N_FRAMES, 2)


@pytest.fixture(scope="module")
def frames4():
    return divergent(N_FRAMES, 4)


@pytest.fixture(scope="module")
def port_2d(frames2):
    return dryrun.spawn([dryrun.job(dryrun.stream_point, ours(), *frames2,
                                    n_stream=2, n_point=2, chunk=N_FRAMES)],
                        4)


@pytest.fixture(scope="module")
def port_streams(frames4):
    return dryrun.spawn([
        dryrun.job(dryrun.multistream, ours(), *frames4, chunk=N_FRAMES),
        dryrun.job(dryrun.multistream, ours(), *frames4, chunk=N_FRAMES,
                   multihost=True),
    ], 2)


def test_stream_point_matches_lvt_tpus_2d_mesh(port_2d, frames2,
                                               share_the_cores):  # noqa: F811
    mesh = jx_mesh.stream_point_mesh(2, 2, jax.devices()[:4])
    jx = JxStreamPointVO(jx_config(), 2, mesh=mesh)
    want = np.stack([np.asarray(jx.track(a, b)[0].t) for a, b in
                     zip(*frames2)])                      # [N, S, 3]
    refs = []
    for s in range(2):
        vo = VOSystem(ours(), device="cpu")
        poses, _ = vo.track_chunk(frames2[0][:, s], frames2[1][:, s])
        refs.append((poses.t.numpy(), vo.map_size))
    for rank, r in enumerate(port_2d[0:4]):
        r = r[0]
        (s,) = r["local_streams"]
        assert s == rank // 2
        np.testing.assert_array_equal(r["poses"][0],
                                      port_2d[2 * s][0]["poses"][0])
        np.testing.assert_allclose(r["poses"][0][:, 0], want[:, s],
                                   atol=2e-3)
        np.testing.assert_allclose(r["poses"][0][:, 0], refs[s][0],
                                   atol=3e-4)
        assert r["map_sizes"].tolist() == [refs[s][1]]
        assert r["status"].tolist() == [TRACKING]
        assert int(jx.status[s]) == TRACKING
        assert r["fallback_warnings"] == []


def test_multistream_over_ranks_equals_one_process(port_streams, frames4,
                                                   share_the_cores):  # noqa: F811
    one = MultiStreamVO(ours(), 4, device="cpu")
    poses, _ = one.track_chunk(*frames4)
    for rank, (mesh_run, host_run) in enumerate(port_streams):
        streams = [2 * rank, 2 * rank + 1]
        for r in (mesh_run, host_run):
            assert r["local_streams"] == streams
            np.testing.assert_array_equal(r["poses"][0],
                                          poses.t[:, streams].numpy())
            np.testing.assert_array_equal(r["poses"][1],
                                          poses.q[:, streams].numpy())
            assert r["collectives"] == 0
        t, q = host_run["all_poses"]
        np.testing.assert_array_equal(t, poses.t[-1].numpy())
        np.testing.assert_array_equal(q, poses.q[-1].numpy())


def test_shard_state_cuts_as_lvt_tpus_batched_specs():
    cfg = jx_config().replace(max_map_points=8, max_staged_points=4,
                              local_ba_window=2)
    rng = np.random.RandomState(3)
    whole = jax.tree.map(
        lambda x: (rng.rand(*x.shape) * 100).astype(x.dtype),
        batched_initial_state(cfg, 4))
    mesh = jx_mesh.stream_point_mesh(2, 2, jax.devices()[:4])
    placed = jax.tree.map(lambda x, spec: jax.device_put(
        x, NamedSharding(mesh, spec)), whole, jx_specs())
    specs = batched_state_specs()
    by_stream = convert.axes_of(specs, STREAM_AXIS)
    by_point = convert.axes_of(specs, POINT_AXIS)
    blocks = {}
    for (i, j), dev in np.ndenumerate(np.asarray(mesh.devices)):
        rows = convert.shard_state(whole, i, 2, axis_of=by_stream,
                                   device="cpu")
        blocks[i, j] = convert.shard_state(rows, j, 2, axis_of=by_point,
                                           device="cpu")
        ours = flatten_with_path(convert.to_numpy(blocks[i, j]))
        theirs = jax.tree.leaves(placed)
        for (key, a), arr in zip(ours, theirs):
            (shard,) = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(a, np.asarray(shard.data),
                                          err_msg=f"device ({i}, {j}) {key}")
    rows = [convert.to_port(convert.gather_state(
        [blocks[i, j] for j in (0, 1)], axis_of=by_point), "cpu")
        for i in (0, 1)]
    back = convert.gather_state(rows, axis_of=by_stream)
    for (key, a), b in zip(flatten_with_path(back), jax.tree.leaves(whole)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
