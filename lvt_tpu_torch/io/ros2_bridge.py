"""ROS 2 bridge: ``StreamingVO`` as an rclpy node.

Port of lvt_tpu/io/ros2_bridge.py on the port's ``StreamingVO`` (its VO
on ``device``, default ``cuda``). The reference node's topics
(``/left/image_rect_gray``, ``/right/image_rect_gray`` and their
camera_info, lvt_ros.cpp:98-101), parameters (lvt_ros.cpp:115-163), lazy
VO creation from the first synced CameraInfo pair (lvt_ros.cpp:172-182),
``reset_vo`` service (lvt_ros.cpp:184-198), and outputs:
``nav_msgs/Odometry`` with twist and a TF broadcast (lvt_ros.cpp:256-306).

Everything rclpy-specific comes in through the ``node`` object
(``create_subscription``, ``create_publisher``, ``create_service``,
``declare_parameter``), so the bridge is tested with a mock node and
imports without ROS 2; ``main()`` imports rclpy. Images are decoded from
``sensor_msgs/Image``'s fields (mono8/8UC1, 16UC1 and 32FC1 for depth),
without cv_bridge.

:class:`StereoSync` pairs the two image (and camera-info) streams as the
reference's ExactTime / ApproximateTime policies do (lvt_ros.cpp:
118-135): with ``approximate_sync`` false only equal stamps pair, with it
true the closest stamps within ``sync_slop``.
"""

from __future__ import annotations

import math
import numpy as np

from lvt_tpu_torch.core.system import SensorType
from lvt_tpu_torch.io.streaming import Odometry, StreamingVO

# reference parameter list (lvt_ros.cpp:144-161): name -> (vo-config field
# or None for node-level, default). enable_visualization is accepted but a
# no-op here (host viz is offline, viz.py).
ROS_PARAMS = {
    "queue_size": (None, 10),
    "approximate_sync": (None, False),
    # max stamp difference (s) for approximate_sync pairing; the reference's
    # ApproximateTime policy has no explicit slop knob, so this is additive
    "sync_slop": (None, 0.01),
    # NOTE: declared for parity with lvt_ros.cpp:150 but the base<->sensor
    # extrinsic is NOT looked up from TF here — StreamingVO always runs with
    # an identity base_from_sensor (deliberate divergence: the reference's
    # init_transforms TF wait, lvt_ros.cpp:204-219, needs a live tf2 buffer;
    # consumers that need the extrinsic can post-multiply the published
    # odometry).
    "sensor_frame_id": (None, "camera"),
    "odom_frame_id": (None, "odom"),
    "base_link_frame_id": (None, "base_link"),
    "near_plane_distance": ("near_plane_distance", 0.1),
    "far_plane_distance": ("far_plane_distance", 500.0),
    "triangulation_ratio_test_threshold":
        ("triangulation_ratio_test_threshold", 0.6),
    "tracking_ratio_test_threshold": ("tracking_ratio_test_threshold", 0.8),
    "descriptor_matching_threshold": ("descriptor_matching_threshold", 30.0),
    "tracking_radius": ("tracking_radius", 25),
    "detection_cell_size": ("detection_cell_size", 250),
    "max_keypoints_per_cell": ("max_keypoints_per_cell", 150),
    "agast_threshold": ("agast_threshold", 20),
    "untracked_threshold": ("untracked_threshold", 10),
    "staged_threshold": ("staged_threshold", 0),
    "enable_logging": ("enable_logging", True),
    "enable_visualization": (None, True),
    "triangulation_policy": ("triangulation_policy", 3),
    "reset_pose_on_lost_vo": (None, True),
    # the reference's literal parameter spelling (lvt_ros.cpp:161 declares
    # "m_reset_pose_on_lost_vo"); accepted as an alias so existing launch
    # files map unchanged. Declared with a typed default (rclpy forbids
    # None defaults for statically typed parameters); the effective value
    # is the AND of both spellings, so setting EITHER to false disables
    # the reset-on-lost behavior.
    "m_reset_pose_on_lost_vo": (None, True),
}


def _stamp_to_sec(stamp) -> float:
    """builtin_interfaces/Time -> float seconds."""
    return float(stamp.sec) + float(stamp.nanosec) * 1e-9


def decode_image(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy array (no cv_bridge)."""
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    if enc in ("mono8", "8uc1"):
        a = np.frombuffer(bytes(msg.data), np.uint8)
    elif enc in ("mono16", "16uc1"):
        dt = np.dtype(np.uint16).newbyteorder(">" if msg.is_bigendian else "<")
        a = np.frombuffer(bytes(msg.data), dt)
    elif enc == "32fc1":
        dt = np.dtype(np.float32).newbyteorder(">" if msg.is_bigendian else "<")
        a = np.frombuffer(bytes(msg.data), dt)
    else:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    row = msg.step // a.itemsize if msg.step else w
    return a.reshape(h, row)[:, :w]


class StereoSync:
    """Approximate/exact-time pairer for two stamped message streams
    (the reference's message_filters sync policies, lvt_ros.cpp:118-135).

    add(side, stamp, payload) returns a (stamp, left, right) tuple when a
    pair forms, else None. Unpaired messages are kept up to `queue_size`
    per side, oldest dropped first."""

    def __init__(self, queue_size: int = 10, slop: float = 0.0):
        self.queue_size = queue_size
        self.slop = slop
        self._buf = {0: [], 1: []}  # side -> list of (stamp, payload)

    def add(self, side: int, stamp: float, payload):
        other = self._buf[1 - side]
        best = None
        for i, (s, p) in enumerate(other):
            d = abs(s - stamp)
            if d <= self.slop and (best is None or d < best[0]):
                best = (d, i)
        if best is not None:
            s, p = other.pop(best[1])
            pair_stamp = min(stamp, s)
            return ((pair_stamp, payload, p) if side == 0
                    else (pair_stamp, p, payload))
        buf = self._buf[side]
        buf.append((stamp, payload))
        if len(buf) > self.queue_size:
            buf.pop(0)
        return None


class Ros2Bridge:
    """The bridge proper: wires a (real or mock) ROS2 node to StreamingVO."""

    IMG_LEFT_TOPIC = "/left/image_rect_gray"
    IMG_RIGHT_TOPIC = "/right/image_rect_gray"
    INFO_LEFT_TOPIC = "/left/camera_info"
    INFO_RIGHT_TOPIC = "/right/camera_info"

    def __init__(self, node, *, msg_types=None, tf_broadcaster=None,
                 sensor_type: SensorType = SensorType.STEREO,
                 streaming_cls=StreamingVO, async_worker: bool = False,
                 device="cuda"):
        """``node`` needs: declare_parameter(name, default) -> obj with
        .value, create_subscription(type, topic, cb, qos),
        create_publisher(type, topic, qos), create_service(type, name, cb),
        get_logger(). ``msg_types`` maps 'Odometry'/'Empty' to message
        classes (defaults to real nav_msgs/std_srvs when importable; the
        mock test injects stand-ins)."""
        self.node = node
        self.params = {
            name: node.declare_parameter(name, default).value
            for name, (_, default) in ROS_PARAMS.items()
        }
        self._msg_types = msg_types or _default_msg_types()
        self._tf_broadcaster = tf_broadcaster

        vo_overrides = {
            field: self.params[name]
            for name, (field, _) in ROS_PARAMS.items() if field is not None
        }
        self._vo_overrides = vo_overrides
        reset_on_lost = (bool(self.params["m_reset_pose_on_lost_vo"])
                         and bool(self.params["reset_pose_on_lost_vo"]))
        self.streaming = streaming_cls(
            sensor_type=sensor_type,
            reset_pose_on_lost=reset_on_lost,
            queue_size=int(self.params["queue_size"]),
            device=device,
        )
        self.streaming.on_odometry(self._publish_odometry)
        if async_worker:
            self.streaming.start()

        slop = (float(self.params["sync_slop"])
                if self.params["approximate_sync"] else 0.0)
        q = int(self.params["queue_size"])
        self._img_sync = StereoSync(q, slop)
        self._info_sync = StereoSync(q, slop)
        self._camera_ready = False

        img_t = self._msg_types.get("Image")
        info_t = self._msg_types.get("CameraInfo")
        node.create_subscription(
            img_t, self.IMG_LEFT_TOPIC, lambda m: self._on_image(0, m), q)
        node.create_subscription(
            img_t, self.IMG_RIGHT_TOPIC, lambda m: self._on_image(1, m), q)
        node.create_subscription(
            info_t, self.INFO_LEFT_TOPIC, lambda m: self._on_info(0, m), q)
        node.create_subscription(
            info_t, self.INFO_RIGHT_TOPIC, lambda m: self._on_info(1, m), q)
        self._odom_pub = node.create_publisher(
            self._msg_types.get("Odometry"), "~/odometry", 1)
        node.create_service(
            self._msg_types.get("Empty"), "~/reset_vo", self._on_reset)

    # -- callbacks ------------------------------------------------------
    def _on_info(self, side: int, msg) -> None:
        if self._camera_ready:
            return
        pair = self._info_sync.add(side, _stamp_to_sec(msg.header.stamp), msg)
        if pair is None:
            return
        _, left, right = pair
        # intrinsics from the RIGHT projection matrix, baseline = -P[3]/P[0]
        # (lvt_ros.cpp:174-181; fy deliberately = fx there too)
        p = np.asarray(right.p if hasattr(right, "p") else right.P,
                       np.float64).reshape(3, 4)
        self.streaming.set_camera_info(
            fx=p[0, 0], fy=p[0, 0], cx=p[0, 2], cy=p[1, 2],
            baseline=abs(p[0, 3] / p[0, 0]),
            width=left.width, height=left.height, **self._vo_overrides,
        )
        self._camera_ready = True

    def _on_image(self, side: int, msg) -> None:
        if not self._camera_ready:
            return
        pair = self._img_sync.add(side, _stamp_to_sec(msg.header.stamp), msg)
        if pair is None:
            return
        stamp, left, right = pair
        self.streaming.feed(stamp, decode_image(left), decode_image(right))

    def _on_reset(self, request, response):
        self.streaming.reset(zero_odometry=True)
        return response

    # -- publishing -----------------------------------------------------
    def _publish_odometry(self, odo: Odometry) -> None:
        cls = self._msg_types.get("Odometry")
        msg = cls()
        sec = int(math.floor(odo.stamp))
        nanosec = int(round((odo.stamp - sec) * 1e9))
        if nanosec >= 1_000_000_000:  # fractional part rounded up to 1.0 s
            sec += 1
            nanosec -= 1_000_000_000
        msg.header.stamp.sec = sec
        msg.header.stamp.nanosec = nanosec
        msg.header.frame_id = self.params["odom_frame_id"]
        msg.child_frame_id = self.params["base_link_frame_id"]
        pp = msg.pose.pose
        pp.position.x, pp.position.y, pp.position.z = map(float, odo.position)
        (pp.orientation.w, pp.orientation.x, pp.orientation.y,
         pp.orientation.z) = map(float, odo.orientation)
        tw = msg.twist.twist
        tw.linear.x, tw.linear.y, tw.linear.z = map(
            float, odo.linear_velocity)
        tw.angular.x, tw.angular.y, tw.angular.z = map(
            float, odo.angular_velocity)
        self._odom_pub.publish(msg)
        if self._tf_broadcaster is not None:
            self._broadcast_tf(msg)

    def _broadcast_tf(self, odom_msg) -> None:
        cls = self._msg_types.get("TransformStamped")
        t = cls()
        t.header = odom_msg.header
        t.child_frame_id = odom_msg.child_frame_id
        p, q = odom_msg.pose.pose.position, odom_msg.pose.pose.orientation
        t.transform.translation.x = p.x
        t.transform.translation.y = p.y
        t.transform.translation.z = p.z
        t.transform.rotation = q
        self._tf_broadcaster.sendTransform(t)

    def shutdown(self) -> None:
        self.streaming.stop()


def _default_msg_types() -> dict:
    try:  # pragma: no cover - requires a ROS2 install
        from builtin_interfaces.msg import Time  # noqa: F401
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry as OdometryMsg
        from sensor_msgs.msg import CameraInfo, Image
        from std_srvs.srv import Empty

        return {"Image": Image, "CameraInfo": CameraInfo,
                "Odometry": OdometryMsg, "Empty": Empty,
                "TransformStamped": TransformStamped}
    except ImportError:
        return {}


def main(args=None):  # pragma: no cover - requires a ROS2 install
    """``ros2 run``-style entry point (the reference's main, lvt_ros.cpp:
    313-318)."""
    import rclpy
    from rclpy.node import Node
    from tf2_ros import TransformBroadcaster

    rclpy.init(args=args)
    node = Node("lvt_tpu_torch")
    bridge = Ros2Bridge(node, tf_broadcaster=TransformBroadcaster(node),
                        async_worker=True)
    try:
        rclpy.spin(node)
    finally:
        bridge.shutdown()
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
