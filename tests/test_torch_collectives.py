"""lvt_tpu_torch's collectives (ops/collectives.py), the sharded one-to-one
resolution and the sharded PnP (parallel/ba.py) over gloo processes on
the CPU, against lvt_tpu under ``shard_map`` on the conftest's virtual CPU
devices.

The port's side runs in 2 and 4 processes spawned from the test
(``parallel.dryrun.spawn``: the ``spawn`` start method, a file rendezvous
under a fresh temporary directory, one thread each), every job of a
process count in one spawn. Tolerances:
  * psum_if, pmin_if, por_if, axis_index, axis_size: exact (integer and
    small-integer float sums);
  * the vmap rule: a batched collective bit-equal to a loop of unbatched
    ones, one collective per batched call, no vmap fallback; the loop's
    sum is not any rank's own values, so the comparison catches a
    collective that silently reduces nothing;
  * resolve_one_to_one(group=) at 2 ranks: bit-equal to lvt_tpu's under
    ``shard_map`` (integer keys);
  * solve_pnp_sharded at 2 and 4 ranks against lvt_tpu's: pose within
    1e-4 m and |q . q'| > 1 - 1e-6, inlier mask and count equal
    (tests/test_parallel.py's checks: the sums run in other orders);
  * the port's sharded PnP against its unsharded solve_pnp on the same
    points: the same bound (the 2 and 4 partial sums are added in float64
    and rounded once, which is not the unsharded float32 order);
  * local_stream_indices: contiguous blocks in rank order;
  * local BA's sharded body at 2 ranks, each rank a block of a window's
    points: the phases (``refine_structure_phases``, the body of the
    sharded step) bit-equal to the plain group version
    (``refine_structure_plain(group=)``) on every rank, also where one
    rank's point step turns non-finite (its accept test is its own); 3 +
    2 per iteration all-reduces against the plain version's 4 + 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.ops import hamming as jx_hamming
from lvt_tpu.parallel import ba as jx_ba
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.parallel import dryrun
from lvt_tpu_torch.solver.pnp import solve_pnp
from tests.test_pnp import FX, FY, CX, CY, make_world, observe, small_pose
from tests.test_torch_ba_refine import CAM as BA_WINDOW_CAM
from tests.test_torch_ba_refine import ITERS as BA_ITERS
from tests.test_torch_ba_refine import _window

CAM = dict(fx=FX, fy=FY, cx=CX, cy=CY)
N_STREAMS = 8
BA_CAM = dict(BA_WINDOW_CAM, iterations=BA_ITERS, reprojection_th2=5.991)
# rank 1's third point step (LM iteration 2) turns non-finite
BA_POISON = (1, 2)


def pnp_problem():
    """tests/test_parallel.py's scene: 256 points, 0.2 px noise, a guess
    0.37 m off."""
    rng = np.random.RandomState(42)
    pts = make_world(rng, 256)
    pose = small_pose(rng)
    uv, _ = observe(pts, pose)
    uv = uv + rng.randn(*uv.shape).astype(np.float32) * 0.2
    guess = (np.asarray(pose.t) + np.array([0.2, -0.1, 0.3], np.float32),
             np.array(pose.q))
    return pts, uv.astype(np.float32), np.ones(len(pts), np.float32), guess


def resolve_problem():
    """Tentative matches of 64 queries onto 16 targets with many conflicts
    and distance ties."""
    rng = np.random.RandomState(7)
    match_idx = rng.randint(-1, 16, 64).astype(np.int32)
    d1 = rng.randint(0, 6, 64).astype(np.float32)
    return match_idx, d1


@pytest.fixture(scope="module")
def ranks():
    """Every job's results at 2 and 4 ranks: {n: [rank 0's, rank 1's,
    ...]}, each a dict by job name."""
    pts, uv, w, guess = pnp_problem()
    match_idx, d1 = resolve_problem()
    out = {}
    for n in (2, 4):
        jobs = {
            "collectives": dryrun.job(dryrun.collectives_check),
            "pnp": dryrun.job(dryrun.pnp_sharded, guess, pts, uv, w,
                              cam=CAM),
            "streams": dryrun.job(dryrun.stream_indices, N_STREAMS),
        }
        if n == 2:
            jobs["resolve"] = dryrun.job(dryrun.resolve_check, match_idx,
                                         d1, 16)
            window = _window("outliers", seed=3)
            for key, poison in (("ba", None), ("ba_poison", BA_POISON)):
                jobs[key] = dryrun.job(dryrun.ba_phases_check, window,
                                       cam=BA_CAM, poison=poison)
        res = dryrun.spawn(list(jobs.values()), n)
        out[n] = [dict(zip(jobs, r)) for r in res]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_reduce_over_the_group(ranks, n):
    x = sum(np.arange(12, dtype=np.float32).reshape(3, 4) * (r + 1)
            for r in range(n))
    ints = np.min([np.arange(6, dtype=np.int32).reshape(3, 2) - r
                   for r in range(n)], axis=0)
    mask = np.ones((2, 4), bool)      # each rank sets every n-th bit
    for rank, res in enumerate(ranks[n]):
        c = res["collectives"]
        assert (c["axis_index"], c["axis_size"]) == (rank, n)
        np.testing.assert_array_equal(c["psum"], x)
        np.testing.assert_array_equal(c["pmin"], ints)
        assert c["pmin"].dtype == np.int32
        np.testing.assert_array_equal(c["por"], mask)
        assert c["unbatched_calls"] == 3


@pytest.mark.parametrize("n", [2, 4])
def test_batched_collective_equals_unbatched_ones(ranks, n):
    for res in ranks[n]:
        c = res["collectives"]
        assert c["batched_equal"] == {"psum": True, "pmin": True,
                                      "por": True}
        # one collective per batched call, whatever the batch size
        assert c["batched_calls"] == 3
        assert c["fallback_warnings"] == []
        # the comparison has teeth: a collective that reduced nothing (as
        # a plain functional collective under vmap may, without an error)
        # would return this rank's own values, which the loop's are not
        assert c["unreduced_equal"] is False


def test_resolve_one_to_one_matches_lvt_tpus_shard_map(ranks):
    match_idx, d1 = resolve_problem()
    mesh = Mesh(np.array(jax.devices()[:2]), ("points",))
    want = jax.shard_map(
        lambda m, d: jx_hamming.resolve_one_to_one(m, d, 16,
                                                   axis_name="points"),
        mesh=mesh, in_specs=(P("points"), P("points")), out_specs=P("points"),
        check_vma=False)(jnp.asarray(match_idx), jnp.asarray(d1))
    got = np.concatenate([r["resolve"] for r in ranks[2]])
    np.testing.assert_array_equal(got, np.asarray(want))
    # one target keeps at most one query, across the ranks
    won = got[got >= 0]
    assert len(won) == len(set(won.tolist())) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_solve_pnp_sharded_matches_lvt_tpus(ranks, n):
    pts, uv, w, guess = pnp_problem()
    mesh = Mesh(np.array(jax.devices()[:n]), ("points",))
    want = jx_ba.solve_pnp_sharded(
        JxPose(jnp.asarray(guess[0]), jnp.asarray(guess[1])),
        jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(w), mesh, **CAM)
    ours = solve_pnp(Pose(torch.from_numpy(guess[0]),
                          torch.from_numpy(guess[1])),
                     torch.from_numpy(pts), torch.from_numpy(uv),
                     torch.from_numpy(w), **CAM)
    mask = np.concatenate([r["pnp"]["inlier_mask"] for r in ranks[n]])
    for res in ranks[n]:
        got = res["pnp"]
        assert np.array_equal(got["t"], ranks[n][0]["pnp"]["t"])
        for t, q, count in ((np.asarray(want.pose.t), np.asarray(want.pose.q),
                             int(want.inlier_count)),
                            (ours.pose.t.numpy(), ours.pose.q.numpy(),
                             int(ours.inlier_count))):
            np.testing.assert_allclose(got["t"], t, atol=1e-4)
            assert abs(float(np.dot(got["q"], q))) > 1 - 1e-6
            assert got["inlier_count"] == count
    np.testing.assert_array_equal(mask, np.asarray(want.inlier_mask))
    np.testing.assert_array_equal(mask, ours.inlier_mask.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_local_stream_indices_are_contiguous_blocks(ranks, n):
    per = N_STREAMS // n
    for rank, res in enumerate(ranks[n]):
        assert res["streams"] == list(range(rank * per, (rank + 1) * per))


def test_dryrun_command_line_runs_the_modes(capsys):
    """``python -m lvt_tpu_torch.parallel.dryrun --processes 2 --device
    cpu``: every mode at the tiny size, one JSON line, the sharded PnP's
    pose the same on both ranks."""
    import json

    assert dryrun.main(["--processes", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["processes"] == 2 and len(out["workers"]) == 2
    for w in out["workers"]:
        assert set(w) == {"rank", "multistream", "pnp_sharded",
                          "sharded_stream"}
        assert w["pnp_sharded"]["inlier_count"] == 64
        assert w["multistream"]["collectives"] == 0
        assert w["sharded_stream"]["collectives"] > 0


@pytest.mark.parametrize("key", ["ba", "ba_poison"])
def test_ba_phases_are_the_plain_group_body(ranks, key):
    """Each rank's phases against its plain group body, bit for bit: the
    block's positions, chi2, n_obs and accept bits; the phases' 3 + 2 per
    iteration all-reduces (the gate's two moments, the first chi-square
    with the observation count, per iteration the sums and the trial
    chi-square) against the plain version's 4 + 2 (the count apart)."""
    for res in ranks[2]:
        got = res[key]
        for a, b in zip(got["phases"], got["plain"]):
            np.testing.assert_array_equal(a, b)
        assert got["phases_collectives"] == 3 + 2 * BA_ITERS
        assert got["plain_collectives"] == 4 + 2 * BA_ITERS
    # both ranks hold the same sums, so the same state
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ranks[2][0][key]["phases"][i],
                                      ranks[2][1][key]["phases"][i])
    # each trial's non-finite flag is its own rank's: only the poisoned
    # rank's trial is flagged (a count all-reduced with the chi-square
    # would flag it on both ranks)
    for rank, res in enumerate(ranks[2]):
        want = [0.0] * BA_ITERS
        if key == "ba_poison" and rank == BA_POISON[0]:
            want[BA_POISON[1]] = 1.0
        assert res[key]["trial_bad"] == want
    if key == "ba_poison":
        # the poisoned step was taken without the fault and is refused with
        # it, on both ranks: the non-finite point makes the trial
        # chi-square non-finite wherever it is summed (a weight of 0 times
        # a non-finite term is NaN), so the accept bits stay equal
        it = BA_POISON[1]
        for res in ranks[2]:
            assert res["ba"]["phases"][3][it]
            assert not res["ba_poison"]["phases"][3][it]
