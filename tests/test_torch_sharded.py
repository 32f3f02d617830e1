"""lvt_tpu_torch's sharded-map stream (parallel/sharded_stream.py) over gloo
processes on the CPU, against lvt_tpu's ``ShardedStreamVO`` on a
2-device ``points`` mesh of the conftest's virtual CPU devices, and
against the port's own unsharded ``VOSystem``.

The geometry is tests/test_sharded_stream.py's ``make_setup`` (256x192,
1024 map and staged points), 5 uint8 frames, local BA off and on (window
4, every 4 frames: BA runs at frame 4). The port's ranks run in processes
spawned from the test (``parallel.dryrun.spawn``), all jobs of a rank
count in one spawn. Tolerances:
  * against lvt_tpu's sharded step at 2 ranks over the 5 frames: every
    pose within 1e-3 m (test_torch_system.py's bound for the jitted JAX
    step, whose fused multiply-adds move poses by ~1e-4 m) and the
    statuses equal. The map sizes are not compared: lvt_tpu's sharded
    program triangulates 2 more far points at frame 0 than its unsharded
    one (214 against 212; its eager run and the triangulation jitted
    alone, in or out of ``shard_map``, also give 214), since XLA fuses the
    unsharded step's ill-conditioned 3x3 contractions into other FMA
    chains; the port emulates the unsharded step's (ops/triangulate.py)
    and inserts 212, sharded or not (ROADMAP H12);
  * one step (frame 4, the BA frame) from lvt_tpu's sharded state after
    frames 0-3, cut into the ranks' blocks by ``convert.shard_state``:
    the match count equal, the pose within 1e-3 m, and each rank's
    ``valid``, ``counter`` and ``age`` bit-equal to lvt_tpu's shard on
    every slot that held a point before the step (the sharded match,
    its pmin-resolved claims, bookkeeping and culling: integer
    decisions); on the slots that take new points, the validity equal
    except at most 0.5% of the slots, where a triangulation gate sits on
    its float boundary (test_torch_system.py's one-step bound);
  * against the port's unsharded step: every pose within 3e-4 m and the
    map sizes equal (lvt_tpu's bound for the same comparison,
    tests/test_sharded_stream.py: the sums over the points run in another
    order);
  * one rank: poses, statuses and the whole state bit-equal to the
    unsharded step (the collectives of one rank return their input, and
    the sums round as unsharded), with the collectives per frame exactly
    the step's count;
  * chunk = per frame, the custom axis name: bit-equal;
  * the capacity caveat at 2 ranks: tests/test_sharded_stream.py's
    assertions with 2 shards for 8.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lvt_tpu.config import VOConfig as JxVOConfig
from lvt_tpu.io.synthetic import SyntheticWorld
from lvt_tpu.parallel.sharded_stream import ShardedStreamVO as JxShardedStreamVO
from lvt_tpu_torch import config as port_config
from lvt_tpu_torch import convert
from lvt_tpu_torch.core.state import TRACKING
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.parallel import dryrun
from lvt_tpu_torch.parallel.sharded_stream import POINT_AXIS, state_specs
from lvt_tpu_torch.tree import flatten_with_path
from tests.test_torch_system import share_the_cores  # noqa: F401

N_FRAMES = 5
WORLD = dict(width=256, height=192, fx=210.0, fy=210.0, cx=128.0, cy=96.0,
             baseline=0.25, n_points=1200, extent_x=30.0, extent_y=14.0,
             extent_z=60.0)
BA = {"plain": 0, "local_ba": 4}


def jx_config(**kw) -> JxVOConfig:
    w = SyntheticWorld(**WORLD)
    return JxVOConfig(
        fx=w.fx, fy=w.fy, cx=w.cx, cy=w.cy, baseline=w.baseline,
        img_width=w.width, img_height=w.height, detection_cell_size=96,
        max_keypoints_per_cell=48, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=90.0,
        **{"max_map_points": 1024, "max_staged_points": 1024, **kw})


def ours(cfg: JxVOConfig) -> port_config.VOConfig:
    """The same configuration as the port's own class: a spawned rank
    imports nothing of lvt_tpu."""
    return port_config.VOConfig(**dataclasses.asdict(cfg))


def frames(n):
    seq = SyntheticWorld(**WORLD).stereo_sequence(n, speed=0.35)
    pairs = [(a.astype(np.uint8), b.astype(np.uint8)) for a, b, _ in seq]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


# capacity: 256 map points (128 per rank) and always-triangulate fill it
CAPACITY = dict(max_map_points=256, max_staged_points=256,
                triangulation_policy=2, map_soft_cap=250)


def per_frame_collectives(cfg) -> int:
    """All-reduces in one frame of the sharded step: map match 5 (two
    pmin, two psum, one OR), PnP 25 (per pass the diagonal, the first
    chi-square and 5 x (normal equations, chi-square); the inlier count),
    the un-mark OR 1, map sizes 3, the staged re-match 2 (pmin, OR), the
    metrics 8 (5 means, map, staged and new points) and the lost frame's
    map size 1; with local BA's phases 3 + 2 per iteration (the gate's
    two moments, the first chi-square with the observation count, per
    iteration the normal equations with the Schur terms and the trial
    chi-square)."""
    n = 45 - (2 if cfg.staged_threshold == 0 else 0)
    if cfg.local_ba_window > 0:
        n += 3 + 2 * cfg.local_ba_iterations
    return n


@pytest.fixture(scope="module")
def seq():
    return frames(N_FRAMES)


@pytest.fixture(scope="module")
def runs(seq):
    """The port's sharded runs: {(ranks, name): [rank 0's result, ...]}."""
    left, right = seq
    cap_l, cap_r = frames(11)
    jobs = {
        "plain": dryrun.job(dryrun.sharded_stream, ours(jx_config()), left,
                            right, chunk=N_FRAMES, keep_state=True),
        "local_ba": dryrun.job(dryrun.sharded_stream,
                               ours(jx_config(local_ba_window=4)), left,
                               right, chunk=N_FRAMES, keep_state=True),
    }
    out = {(1, k): [r[i]] for i, k in enumerate(jobs)
           for r in dryrun.spawn(list(jobs.values()), 1)}
    jobs.update(
        per_frame=dryrun.job(dryrun.sharded_stream, ours(jx_config()), left,
                             right, chunk=1),
        blocks=dryrun.job(dryrun.sharded_stream, ours(jx_config()), left,
                          right, chunk=N_FRAMES, axis="blocks"),
        capacity=dryrun.job(dryrun.sharded_stream,
                            ours(jx_config(**CAPACITY)), cap_l, cap_r,
                            chunk=8))
    res = dryrun.spawn(list(jobs.values()), 2)
    out.update({(2, k): [r[i] for r in res] for i, k in enumerate(jobs)})
    return out


@pytest.fixture(scope="module")
def unsharded(seq, share_the_cores):  # noqa: F811
    """The port's VOSystem over the same frames: {name: (poses, metrics,
    state)}."""
    out = {}
    for name, ba in BA.items():
        vo = VOSystem(ours(jx_config(local_ba_window=ba)), device="cpu")
        poses, metrics = vo.track_chunk(*seq)
        out[name] = (poses, metrics, vo.state)
    return out


@pytest.fixture(scope="module")
def lvt_tpu_sharded(seq):
    """lvt_tpu's ShardedStreamVO on 2 virtual devices, frame by frame:
    {name: (poses t [N, 3], statuses [N], state before the last frame (the
    port's tree, numpy leaves), state after it)}."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("points",))
    out = {}
    for name, ba in BA.items():
        svo = JxShardedStreamVO(jx_config(local_ba_window=ba), mesh=mesh)
        poses, statuses = [], []
        for i, (a, b) in enumerate(zip(*seq)):
            if i == N_FRAMES - 1:
                before = convert.to_numpy(convert.to_port(svo.state, "cpu"))
            poses.append(np.asarray(svo.track(a, b).t))
            statuses.append(svo.status)
        after = convert.to_numpy(convert.to_port(svo.state, "cpu"))
        out[name] = (np.stack(poses), np.array(statuses), before, after)
    return out


@pytest.fixture(scope="module")
def one_step(seq, lvt_tpu_sharded):
    """The port's 2 ranks from lvt_tpu's sharded state before the last
    frame, over that frame: {name: [rank 0's result, rank 1's]}."""
    left, right = seq
    jobs = {name: dryrun.job(
        dryrun.sharded_stream, ours(jx_config(local_ba_window=ba)),
        left[-1:], right[-1:], chunk=1, keep_state=True,
        initial=lvt_tpu_sharded[name][2]) for name, ba in BA.items()}
    res = dryrun.spawn(list(jobs.values()), 2)
    return {name: [r[i] for r in res] for i, name in enumerate(jobs)}


@pytest.mark.parametrize("name", list(BA))
def test_sharded_tracks_as_lvt_tpus_shard_map(runs, lvt_tpu_sharded, name):
    t, statuses = lvt_tpu_sharded[name][:2]
    ranks = runs[(2, name)]
    for r in ranks:
        np.testing.assert_array_equal(r["poses"][0], ranks[0]["poses"][0])
        np.testing.assert_allclose(r["poses"][0], t, atol=1e-3)
        np.testing.assert_array_equal(r["metrics"].status, statuses)
        assert r["status"] == TRACKING


@pytest.mark.parametrize("name", list(BA))
def test_one_step_from_lvt_tpus_sharded_state(one_step, lvt_tpu_sharded,
                                              name):
    t, _, before, after = lvt_tpu_sharded[name]
    axes = convert.axes_of(state_specs(), POINT_AXIS)
    cut = lambda tree, rank: convert.to_numpy(convert.shard_state(  # noqa: E731
        tree, rank, 2, axis_of=axes, device="cpu"))
    ranks = one_step[name]
    assert ranks[0]["metrics"].tracked_map_points[0] > 0
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["poses"][0][0], t[-1], atol=1e-3)
        old, want, got = cut(before, rank), cut(after, rank), r["state"]
        assert r["metrics"].tracked_map_points[0] == \
            ranks[0]["metrics"].tracked_map_points[0]
        for store in ("map", "staged"):
            held = getattr(old, store).valid
            for leaf in ("valid", "counter", "age"):
                np.testing.assert_array_equal(
                    getattr(getattr(got, store), leaf)[held],
                    getattr(getattr(want, store), leaf)[held],
                    err_msg=f"rank {rank} {store}.{leaf}")
            new = ~held
            differ = (getattr(got, store).valid[new]
                      != getattr(want, store).valid[new]).sum()
            assert differ <= 0.005 * len(held), (store, differ)
    if BA[name]:
        assert ranks[0]["metrics"].local_ba_ran[0]


@pytest.mark.parametrize("name", list(BA))
def test_sharded_matches_unsharded(runs, unsharded, name):
    poses, metrics, state = unsharded[name]
    for r in runs[(2, name)]:
        np.testing.assert_allclose(r["poses"][0], poses.t.numpy(), atol=3e-4)
        np.testing.assert_array_equal(r["metrics"].status,
                                      metrics.status.numpy())
        assert r["map_size"] == int(state.map.size())
    if BA[name]:
        # BA ran at frame 4 on every rank and unsharded
        ran = runs[(2, name)][0]["metrics"].local_ba_ran
        np.testing.assert_array_equal(ran, metrics.local_ba_ran.numpy())
        assert ran[-1]


@pytest.mark.parametrize("name", list(BA))
def test_one_rank_is_bit_equal_to_unsharded(runs, unsharded, name):
    poses, metrics, state = unsharded[name]
    (r,) = runs[(1, name)]
    np.testing.assert_array_equal(r["poses"][0], poses.t.numpy())
    np.testing.assert_array_equal(r["poses"][1], poses.q.numpy())
    for field in metrics._fields:
        np.testing.assert_array_equal(getattr(r["metrics"], field),
                                      getattr(metrics, field).numpy(),
                                      err_msg=field)
    for (key, a), (_, b) in zip(flatten_with_path(r["state"]),
                                flatten_with_path(convert.to_numpy(state))):
        np.testing.assert_array_equal(a, b, err_msg=key)
    cfg = jx_config(local_ba_window=BA[name])
    assert r["collectives"] == N_FRAMES * per_frame_collectives(cfg)


def test_chunk_equals_per_frame(runs):
    for chunked, per_frame in zip(runs[(2, "plain")], runs[(2, "per_frame")]):
        for a, b in zip(chunked["poses"], per_frame["poses"]):
            np.testing.assert_array_equal(a, b)
        assert chunked["map_size"] == per_frame["map_size"]
        assert chunked["collectives"] == per_frame["collectives"]


def test_custom_axis_name_tracks(runs):
    """The axis name threads through to the mesh and its group."""
    for blocks, plain in zip(runs[(2, "blocks")], runs[(2, "plain")]):
        assert blocks["mesh_dim_names"] == ["blocks"]
        assert plain["mesh_dim_names"] == ["points"]
        assert blocks["status"] == TRACKING
        np.testing.assert_array_equal(blocks["poses"][0], plain["poses"][0])


def test_sharded_map_at_capacity_degrades_gracefully(runs, share_the_cores):  # noqa: F811
    """The capacity caveat (sharded_stream.py's docstring): once one
    rank's block fills, its share of the new points drops even if the
    other rank has free slots. Bounded (never over capacity, at least half
    of it), consistent (each block at most its capacity, the sum the map
    size) and recoverable (tracking continues)."""
    cfg = ours(jx_config(**CAPACITY))
    cap_l, cap_r = frames(11)
    vo = VOSystem(cfg, device="cpu")
    ref, _ = vo.track_chunk(cap_l[:8], cap_r[:8])
    assert vo.map_size == cfg.max_map_points
    ranks = runs[(2, "capacity")]
    after8 = [r["after_chunks"][0] for r in ranks]
    size = after8[0]["map_size"]
    assert all(a["map_size"] == size for a in after8)
    assert all(a["status"] == TRACKING for a in after8)
    assert cfg.max_map_points // 2 <= size <= cfg.max_map_points
    assert sum(a["local_valid"] for a in after8) == size
    assert max(a["local_valid"] for a in after8) <= cfg.max_map_points // 2
    assert all(r["block"] == cfg.max_map_points // 2 for r in ranks)
    assert np.linalg.norm(ranks[0]["poses"][0][7] - ref.t[-1].numpy()) < 0.05
    # recoverable: 3 more frames at capacity
    assert all(r["after_chunks"][1]["status"] == TRACKING for r in ranks)
