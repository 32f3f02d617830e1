"""lvt_tpu_torch's streaming driver and ROS 2 bridge, on the CPU, checked
as tests/test_streaming.py and tests/test_ros2_bridge.py check lvt_tpu's
(with ``device="cpu"``): lazy init, odometry out, the stale-stamp guard,
auto-reset on LOST, the async worker, concurrent producers; the bridge's
parameters, camera-info init, stereo time sync, odometry publishing and
reset service on a mock node. Then the port's odometry against lvt_tpu's
StreamingVO on the same frames: positions within 1e-3 m (the bound of
the jitted JAX step, test_torch_system.py), velocities within 1e-2 m/s
(a finite difference over 0.1 s), orientations within 1e-5.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

from lvt_tpu.io.streaming import StreamingVO as JxStreamingVO
from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core.system import TrackingState
from lvt_tpu_torch.io.ros2_bridge import (ROS_PARAMS, Ros2Bridge, StereoSync,
                                          decode_image)
from lvt_tpu_torch.io.streaming import ROT_OPTICAL_TO_ROBOT, StreamingVO
from tests.test_end_to_end import make_config, make_world
from tests.test_torch_system import share_the_cores  # noqa: F401


def _config(world):
    return VOConfig(**dataclasses.asdict(make_config(world)))


def make_stream(**kw):
    world = make_world()
    s = StreamingVO(_config(world), apply_axis_fix=kw.pop("apply_axis_fix",
                                                           False),
                    device="cpu", **kw)
    return world, s

def test_sync_stream_tracks():
    world, s = make_stream()
    outs = []
    s.on_odometry(outs.append)
    for i, (l, r, (rot, t)) in enumerate(world.stereo_sequence(8, speed=0.4)):
        s.feed(0.1 * i, l, r)
    assert len(outs) == 8
    assert outs[-1].tracking_state == TrackingState.TRACKING
    # odometry should track ground truth (no axis fix, identity extrinsic)
    gt_final = t
    np.testing.assert_allclose(outs[-1].position, gt_final, atol=0.3)
    # twist: forward motion of 0.4m / 0.1s = 4 m/s along z (optical)
    v = outs[-1].linear_velocity
    assert abs(np.linalg.norm(v) - 4.0) < 1.0


def test_stale_frames_dropped():
    world, s = make_stream()
    frames = list(world.stereo_sequence(3))
    assert s.feed(1.0, frames[0][0], frames[0][1])
    assert not s.feed(0.5, frames[1][0], frames[1][1])  # stale
    assert s.dropped_frames == 1
    assert s.feed(1.5, frames[1][0], frames[1][1])


def test_auto_reset_on_lost_continues():
    world, s = make_stream()
    outs = []
    s.on_odometry(outs.append)
    frames = list(world.stereo_sequence(6, speed=0.3))
    blank = np.full(frames[0][0].shape, 60.0, np.float32)
    for i, (l, r, _) in enumerate(frames[:3]):
        s.feed(0.1 * i, l, r)
    pos_before = outs[-1].position.copy()
    s.feed(0.35, blank, blank)  # lose tracking
    assert outs[-1].tracking_state == TrackingState.LOST
    # vo auto-reset: next frames re-initialize and odometry continues
    for i, (l, r, _) in enumerate(frames[3:]):
        s.feed(0.4 + 0.1 * i, l, r)
    assert outs[-1].tracking_state == TrackingState.TRACKING
    # odometry did not jump back to origin
    assert np.linalg.norm(outs[-1].position) >= np.linalg.norm(pos_before) - 0.2


def test_axis_fix_transform():
    world, s = make_stream(apply_axis_fix=True)
    outs = []
    s.on_odometry(outs.append)
    for i, (l, r, (rot, t)) in enumerate(world.stereo_sequence(5, speed=0.4)):
        s.feed(0.1 * i, l, r)
    # camera moves +z (optical); robot frame: +x forward
    p = outs[-1].position
    assert p[0] > 1.0, p
    assert abs(p[1]) < 0.5 and abs(p[2]) < 0.5


def test_async_worker():
    world, s = make_stream()
    outs = []
    s.on_odometry(outs.append)
    s.start()
    frames = list(world.stereo_sequence(5, speed=0.4))
    for i, (l, r, _) in enumerate(frames):
        s.feed(0.1 * i, l, r)
        time.sleep(0.01)
    deadline = time.time() + 60
    while len(outs) + s.dropped_frames < 5 and time.time() < deadline:
        time.sleep(0.1)
    s.stop()
    assert len(outs) >= 3
    assert outs[-1].tracking_state == TrackingState.TRACKING


def test_concurrent_producers_feed_safely():
    """Multiple producer threads may feed concurrently: the stale-stamp
    check/update and the evict-then-put on a full queue are atomic (feed
    lock), so no producer ever sees queue.Full escape and the stamp guard
    stays monotonic."""
    world, s = make_stream(queue_size=2)
    outs = []
    s.on_odometry(outs.append)
    s.start()
    frames = list(world.stereo_sequence(2, speed=0.4))
    l0, r0 = frames[0][0], frames[0][1]
    errors = []
    accepted = [0] * 4

    def producer(tid):
        try:
            for i in range(25):
                if s.feed(tid + 4 * i, l0, r0):
                    accepted[tid] += 1
        except Exception as e:  # noqa: BLE001 — fail the test with it
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline = time.time() + 60
    while not s._queue.empty() and time.time() < deadline:
        time.sleep(0.05)
    s.stop()
    assert not errors, errors
    # every one of the 100 attempts was rejected as stale (dropped), evicted
    # from the queue (dropped), or tracked (outs) — exactly once
    assert len(outs) + s.dropped_frames == 100


def test_lazy_camera_info():
    world, _ = make_stream()
    s = StreamingVO(apply_axis_fix=False, device="cpu")
    s.set_camera_info(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, width=world.width, height=world.height,
        detection_cell_size=80, max_keypoints_per_cell=60,
        agast_threshold=15, near_plane_distance=0.5,
        far_plane_distance=150.0, max_map_points=1024,
        max_staged_points=1024,
    )
    outs = []
    s.on_odometry(outs.append)
    for i, (l, r, _) in enumerate(world.stereo_sequence(3, speed=0.4)):
        s.feed(0.1 * i, l, r)
    assert len(outs) == 3


# --- tiny stand-ins for ROS2 message/infra types -------------------------

def _ns(**kw):
    return types.SimpleNamespace(**kw)


def make_stamp(t):
    sec = int(t)
    return _ns(sec=sec, nanosec=int(round((t - sec) * 1e9)))


def make_image(t, arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    return _ns(
        header=_ns(stamp=make_stamp(t), frame_id="camera"),
        height=arr.shape[0], width=arr.shape[1], encoding="mono8",
        is_bigendian=0, step=arr.shape[1], data=arr.tobytes(),
    )


def make_camera_info(t, fx, cx, cy, baseline, w, h):
    p = np.zeros(12)
    p[0] = fx
    p[5] = fx
    p[2] = cx
    p[6] = cy
    p[10] = 1.0
    p[3] = -fx * baseline  # right camera: P[3] = -fx*B
    return _ns(header=_ns(stamp=make_stamp(t), frame_id="camera"),
               width=w, height=h, p=p)


class FakeOdometryMsg:
    def __init__(self):
        self.header = _ns(stamp=make_stamp(0.0), frame_id="")
        self.child_frame_id = ""
        vec = lambda: _ns(x=0.0, y=0.0, z=0.0)  # noqa: E731
        self.pose = _ns(pose=_ns(position=vec(),
                                 orientation=_ns(w=1.0, x=0.0, y=0.0, z=0.0)))
        self.twist = _ns(twist=_ns(linear=vec(), angular=vec()))


class FakeEmpty:
    Request = object
    Response = object


class FakeNode:
    """Just enough of rclpy.node.Node for Ros2Bridge."""

    def __init__(self, param_overrides=None):
        self.param_overrides = param_overrides or {}
        self.declared = {}
        self.subscriptions = {}
        self.publishers = {}
        self.services = {}

    def declare_parameter(self, name, default):
        value = self.param_overrides.get(name, default)
        self.declared[name] = value
        return _ns(value=value)

    def create_subscription(self, msg_type, topic, cb, qos):
        self.subscriptions[topic] = cb

    def create_publisher(self, msg_type, topic, qos):
        pub = _ns(published=[], publish=None)
        pub.publish = pub.published.append
        self.publishers[topic] = pub
        return pub

    def create_service(self, srv_type, name, cb):
        self.services[name] = cb

    def get_logger(self):
        return _ns(info=lambda *a: None, warning=lambda *a: None)


MSG_TYPES = {"Image": None, "CameraInfo": None,
             "Odometry": FakeOdometryMsg, "Empty": FakeEmpty}


def make_bridge(**param_overrides):
    world = make_world()
    cfg = _config(world)
    # route the tuned synthetic-world VO settings through the ROS parameter
    # system, the way a launch file would
    overrides = dict(
        detection_cell_size=cfg.detection_cell_size,
        max_keypoints_per_cell=cfg.max_keypoints_per_cell,
        agast_threshold=cfg.agast_threshold,
        near_plane_distance=cfg.near_plane_distance,
        far_plane_distance=cfg.far_plane_distance,
        enable_logging=False,
    )
    overrides.update(param_overrides)
    node = FakeNode(overrides)
    bridge = Ros2Bridge(node, msg_types=MSG_TYPES, device="cpu")
    return world, cfg, node, bridge


# --- StereoSync ----------------------------------------------------------

def test_sync_exact_pairs_only_equal_stamps():
    s = StereoSync(queue_size=4, slop=0.0)
    assert s.add(0, 1.0, "L1") is None
    assert s.add(1, 1.5, "R?") is None        # different stamp: no pair
    assert s.add(1, 1.0, "R1") == (1.0, "L1", "R1")


def test_sync_approximate_picks_closest():
    s = StereoSync(queue_size=4, slop=0.02)
    s.add(0, 1.000, "L1")
    s.add(0, 1.050, "L2")
    got = s.add(1, 1.045, "R")
    assert got[1] == "L2"


def test_sync_bounded_queue():
    s = StereoSync(queue_size=2, slop=0.0)
    for i in range(5):
        s.add(0, float(i), f"L{i}")
    assert s.add(1, 0.0, "R") is None          # L0 evicted
    assert s.add(1, 4.0, "R") is not None      # newest kept


# --- image decoding ------------------------------------------------------

def test_decode_mono8_roundtrip(rng):
    img = rng.randint(0, 255, (7, 9)).astype(np.uint8)
    np.testing.assert_array_equal(decode_image(make_image(0.0, img)), img)


def test_decode_rejects_unknown_encoding():
    msg = make_image(0.0, np.zeros((2, 2), np.uint8))
    msg.encoding = "rgb8"
    with pytest.raises(ValueError):
        decode_image(msg)


# --- bridge --------------------------------------------------------------

def test_declares_all_reference_params():
    _, _, node, _ = make_bridge()
    assert set(node.declared) == set(ROS_PARAMS)


def test_images_before_camera_info_ignored():
    world, _, node, bridge = make_bridge()
    l, r, _ = next(iter(world.stereo_sequence(1)))
    node.subscriptions[Ros2Bridge.IMG_LEFT_TOPIC](make_image(0.0, l))
    node.subscriptions[Ros2Bridge.IMG_RIGHT_TOPIC](make_image(0.0, r))
    assert node.publishers["~/odometry"].published == []
    assert not bridge._camera_ready


def test_camera_info_builds_config_from_projection():
    world, cfg, node, bridge = make_bridge()
    info = make_camera_info(0.0, world.fx, world.cx, world.cy,
                            world.baseline, world.width, world.height)
    node.subscriptions[Ros2Bridge.INFO_LEFT_TOPIC](info)
    node.subscriptions[Ros2Bridge.INFO_RIGHT_TOPIC](info)
    assert bridge._camera_ready
    got = bridge.streaming._config
    assert got.fx == pytest.approx(world.fx)
    assert got.baseline == pytest.approx(world.baseline)
    assert got.img_width == world.width
    assert got.detection_cell_size == cfg.detection_cell_size


def test_end_to_end_odometry_publishing():
    world, _, node, bridge = make_bridge()
    info = make_camera_info(0.0, world.fx, world.cx, world.cy,
                            world.baseline, world.width, world.height)
    node.subscriptions[Ros2Bridge.INFO_LEFT_TOPIC](info)
    node.subscriptions[Ros2Bridge.INFO_RIGHT_TOPIC](info)

    for i, (l, r, (rot, t)) in enumerate(world.stereo_sequence(6, speed=0.4)):
        stamp = 0.1 * (i + 1)
        node.subscriptions[Ros2Bridge.IMG_LEFT_TOPIC](make_image(stamp, l))
        node.subscriptions[Ros2Bridge.IMG_RIGHT_TOPIC](make_image(stamp, r))

    out = node.publishers["~/odometry"].published
    assert len(out) == 6
    last = out[-1]
    assert last.header.frame_id == "odom"
    assert last.child_frame_id == "base_link"
    # axis fix: camera +z forward -> robot +x forward
    assert last.pose.pose.position.x > 1.0
    assert abs(last.pose.pose.position.y) < 0.5
    # twist is populated (0.4m / 0.1s = 4 m/s)
    assert abs(last.twist.twist.linear.x - 4.0) < 1.5
    # stamps round-trip through sec/nanosec
    assert last.header.stamp.sec == 0
    assert last.header.stamp.nanosec == pytest.approx(6e8, abs=2)


def test_reset_service_zeroes_odometry():
    world, _, node, bridge = make_bridge()
    info = make_camera_info(0.0, world.fx, world.cx, world.cy,
                            world.baseline, world.width, world.height)
    node.subscriptions[Ros2Bridge.INFO_LEFT_TOPIC](info)
    node.subscriptions[Ros2Bridge.INFO_RIGHT_TOPIC](info)
    for i, (l, r, _) in enumerate(world.stereo_sequence(4, speed=0.4)):
        stamp = 0.1 * (i + 1)
        node.subscriptions[Ros2Bridge.IMG_LEFT_TOPIC](make_image(stamp, l))
        node.subscriptions[Ros2Bridge.IMG_RIGHT_TOPIC](make_image(stamp, r))
    assert np.hypot(node.publishers["~/odometry"].published[-1]
                    .pose.pose.position.x, 0.0) > 0.5

    node.services["~/reset_vo"](None, FakeEmpty.Response)
    # next pair re-initializes; odometry restarts near the origin
    for i, (l, r, _) in enumerate(world.stereo_sequence(2, speed=0.4)):
        stamp = 1.0 + 0.1 * i
        node.subscriptions[Ros2Bridge.IMG_LEFT_TOPIC](make_image(stamp, l))
        node.subscriptions[Ros2Bridge.IMG_RIGHT_TOPIC](make_image(stamp, r))
    last = node.publishers["~/odometry"].published[-1]
    assert abs(last.pose.pose.position.x) < 0.6
    assert bridge.streaming.vo.get_state() in (
        TrackingState.TRACKING, TrackingState.NOT_INITIALIZED)


# --- against lvt_tpu's StreamingVO ------------------------------------------

def test_odometry_matches_lvt_tpus():
    world = make_world()
    outs = {"port": [], "jax": []}
    ours = StreamingVO(_config(world), device="cpu")
    theirs = JxStreamingVO(make_config(world))
    ours.on_odometry(outs["port"].append)
    theirs.on_odometry(outs["jax"].append)
    for i, (l, r, _) in enumerate(world.stereo_sequence(5, speed=0.4)):
        ours.feed(0.1 * i, l, r)
        theirs.feed(0.1 * i, l, r)
    for a, b in zip(outs["port"], outs["jax"], strict=True):
        assert (a.stamp, a.frame_number, int(a.tracking_state)) == (
            b.stamp, b.frame_number, int(b.tracking_state))
        np.testing.assert_allclose(a.position, b.position, atol=1e-3)
        np.testing.assert_allclose(a.orientation, b.orientation, atol=1e-5)
        np.testing.assert_allclose(a.linear_velocity, b.linear_velocity,
                                   atol=1e-2)
        np.testing.assert_allclose(a.angular_velocity, b.angular_velocity,
                                   atol=1e-2)
    assert outs["port"][-1].position[0] > 1.0   # axis fix: +x forward
    assert ours.vo.device.type == "cpu"
