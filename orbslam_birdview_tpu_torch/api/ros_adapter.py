"""ROS adapter: image-callback wrappers around `System`.

The JAX package's `api/ros_adapter.py` on the port's `System`: the
reference's ROS nodes (`Examples/ROS/ORB_SLAM2/src/ros_mono.cc`,
`ros_stereo.cc`, `ros_rgbd.cc`) as a callback object per sensor mode that
a rospy/rclpy
subscriber can call with decoded images. ROS itself is not imported — the
adapter is transport-agnostic (wire it to cv_bridge outputs); this keeps it
importable and testable in any environment.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import lie
from .system import System


class MonoNode:
    """`ImageGrabber::GrabImage` (ros_mono.cc)."""

    def __init__(self, system: System,
                 on_pose: Optional[Callable] = None):
        self.system = system
        self.on_pose = on_pose

    def callback(self, img: np.ndarray, stamp: float):
        fd = self.system.track_monocular(img, stamp)
        if self.on_pose is not None and fd.pose_ok:
            self.on_pose(stamp, fd.Tcw())
        return fd


class StereoNode:
    """`ImageGrabber::GrabStereo` (ros_stereo.cc) — synchronized pairs.

    With `do_rectify`, raw pairs are rectified before tracking, exactly
    the reference node's `cv::remap` path (`ros_stereo.cc:main` builds
    initUndistortRectifyMap maps from the LEFT./RIGHT. YAML blocks and
    `GrabStereo` remaps both images when `do_rectify` is set). Pass either
    a ready `StereoRectifier` or a config path containing the blocks."""

    def __init__(self, system: System, on_pose: Optional[Callable] = None,
                 rectifier=None, config_path: Optional[str] = None):
        self.system = system
        self.on_pose = on_pose
        if rectifier is None and config_path is not None:
            from ..cli.datasets import parse_rectification

            rectifier = parse_rectification(config_path)
        self.rectifier = rectifier

    def callback(self, img_left: np.ndarray, img_right: np.ndarray,
                 stamp: float):
        if self.rectifier is not None:
            img_left, img_right = self.rectifier(img_left, img_right)
        fd = self.system.track_stereo(img_left, img_right, stamp)
        if self.on_pose is not None and fd.pose_ok:
            self.on_pose(stamp, fd.Tcw())
        return fd


class RGBDNode:
    """`ImageGrabber::GrabRGBD` (ros_rgbd.cc)."""

    def __init__(self, system: System, on_pose: Optional[Callable] = None):
        self.system = system
        self.on_pose = on_pose

    def callback(self, img: np.ndarray, depth: np.ndarray, stamp: float):
        fd = self.system.track_rgbd(img, depth, stamp)
        if self.on_pose is not None and fd.pose_ok:
            self.on_pose(stamp, fd.Tcw())
        return fd


class BirdviewNode:
    """Birdview-fused callback (no reference ROS analogue — the fork's
    `mono_fisheye` example as a node)."""

    def __init__(self, system: System, on_pose: Optional[Callable] = None):
        self.system = system
        self.on_pose = on_pose

    def callback(self, img: np.ndarray, bird: np.ndarray,
                 mask: Optional[np.ndarray], stamp: float):
        fd = self.system.track_monocular_with_birdview(img, bird, mask, stamp)
        if self.on_pose is not None and fd.pose_ok:
            self.on_pose(stamp, fd.Tcw())
        return fd


# ---------------------------------------------------------------------------
# transport wiring (ROS1). The reference nodes subscribe with
# roscpp + cv_bridge (`ros_mono.cc:main`, `ros_stereo.cc:main` uses
# message_filters::Synchronizer); this is the rospy equivalent. The ROS
# modules are injected (or imported lazily) so the wiring is unit-testable
# without ROS and importable anywhere.
# ---------------------------------------------------------------------------

def decode_image_msg(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy, without cv_bridge: mono8/mono16 pass
    through, bgr8/rgb8 convert to grayscale (the reference converts with
    cvtColor in `Frame`), 16UC1/32FC1 (depth) pass through."""
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    buf = np.frombuffer(msg.data, dtype=np.uint8)
    if enc in ("mono8", "8uc1"):
        img = buf.reshape(h, msg.step)[:, :w]
    elif enc in ("mono16", "16uc1"):
        img = buf.view(np.uint16).reshape(h, msg.step // 2)[:, :w]
    elif enc in ("bgr8", "rgb8"):
        c = buf.reshape(h, msg.step)[:, : w * 3].reshape(h, w, 3)
        wts = (np.array([0.114, 0.587, 0.299]) if enc == "bgr8"
               else np.array([0.299, 0.587, 0.114]))
        img = (c.astype(np.float32) @ wts.astype(np.float32))
    elif enc == "32fc1":
        img = buf.view(np.float32).reshape(h, msg.step // 4)[:, :w]
    else:
        raise ValueError(f"unsupported encoding {msg.encoding}")
    return np.ascontiguousarray(img)


def _stamp_of(msg) -> float:
    s = msg.header.stamp
    return float(s.secs) + 1e-9 * float(s.nsecs)


def run_ros1(node, topics, pose_topic: str = "/orb_slam/pose",
             queue_size: int = 5, sync_slop: float = 0.02,
             ros=None, spin: bool = True):
    """Wire a Mono/Stereo/RGBD/Birdview node to live ROS1 topics.

    `topics`: one topic string (mono) or a tuple of 2 (stereo/rgbd: left+
    right or rgb+depth; birdview: front+bird) or 3 (birdview with a mask
    topic). Publishes geometry_msgs/PoseStamped with T_cw on `pose_topic`
    for every tracked frame — the reference nodes display instead of
    publishing; a pose topic is the useful production surface.

    `ros`: an object with .rospy / .message_filters / .msgs attributes for
    tests; None imports the real modules (requires a ROS1 environment).
    """
    if ros is None:
        import importlib

        class _Ros:
            rospy = importlib.import_module("rospy")
            message_filters = importlib.import_module("message_filters")
            geometry_msgs = importlib.import_module("geometry_msgs.msg")
            sensor_msgs = importlib.import_module("sensor_msgs.msg")
        ros = _Ros()
    rospy = ros.rospy
    Image = ros.sensor_msgs.Image
    pub = rospy.Publisher(pose_topic, ros.geometry_msgs.PoseStamped,
                          queue_size=queue_size)

    def publish(stamp, Tcw):
        msg = ros.geometry_msgs.PoseStamped()
        msg.header.stamp = stamp
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        # publish camera pose in world (Twc), the ROS convention
        Rwc = R.T
        twc = -R.T @ t
        q = lie.rot_to_quat(torch.as_tensor(
            np.ascontiguousarray(Rwc))).numpy()
        p = msg.pose.position
        p.x, p.y, p.z = (float(x) for x in twc)
        o = msg.pose.orientation
        o.w, o.x, o.y, o.z = (float(x) for x in q)
        pub.publish(msg)

    if isinstance(topics, str):
        topics = (topics,)

    if isinstance(node, MonoNode):
        def cb(msg):
            fd = node.callback(decode_image_msg(msg), _stamp_of(msg))
            if fd.pose_ok:
                publish(msg.header.stamp, fd.Tcw())
        rospy.Subscriber(topics[0], Image, cb, queue_size=queue_size)
    else:
        subs = [ros.message_filters.Subscriber(t, Image) for t in topics]
        sync = ros.message_filters.ApproximateTimeSynchronizer(
            subs, queue_size, sync_slop)

        if isinstance(node, StereoNode):
            def cb2(left, right):
                fd = node.callback(decode_image_msg(left),
                                   decode_image_msg(right),
                                   _stamp_of(left))
                if fd.pose_ok:
                    publish(left.header.stamp, fd.Tcw())
            sync.registerCallback(cb2)
        elif isinstance(node, RGBDNode):
            def cb2(rgb, depth):
                fd = node.callback(decode_image_msg(rgb),
                                   decode_image_msg(depth),
                                   _stamp_of(rgb))
                if fd.pose_ok:
                    publish(rgb.header.stamp, fd.Tcw())
            sync.registerCallback(cb2)
        elif isinstance(node, BirdviewNode):
            if len(topics) == 3:
                def cb3(front, bird, mask):
                    fd = node.callback(decode_image_msg(front),
                                       decode_image_msg(bird),
                                       decode_image_msg(mask),
                                       _stamp_of(front))
                    if fd.pose_ok:
                        publish(front.header.stamp, fd.Tcw())
                sync.registerCallback(cb3)
            else:
                def cb2(front, bird):
                    fd = node.callback(decode_image_msg(front),
                                       decode_image_msg(bird), None,
                                       _stamp_of(front))
                    if fd.pose_ok:
                        publish(front.header.stamp, fd.Tcw())
                sync.registerCallback(cb2)
        else:
            raise TypeError(f"unsupported node type {type(node)}")
    if spin:
        rospy.spin()
    return pub
