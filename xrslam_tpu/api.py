"""Public API: the reference's C ABI surface, Python-native.

Mirrors the flat interface of xrslam-interface (reference:
xrslam-interface/include/XRSLAM.h:195-230 —
XRSLAMCreate/PushSensorData/RunOneFrame/GetResult/Destroy — and the
singleton XRSLAMManager, xrslam-interface/src/XRSLAMManager.{h,cpp}):
push IMU/camera samples, run one frame, query poses / state /
landmarks / biases. Pose composition (body = q·q_bi rooted at the
latest predicted center pose, camera = q·q_bc) follows
XRSLAMManager.cpp:153-186; quaternions cross this API in the C ABI's
[x,y,z,w] order.

Both the class-based interface (`XRSLAM`) and the module-level
singleton functions (`create`/`push_sensor_data`/`run_one_frame`/
`get_result`/`destroy`) are provided.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import __version__, runtime
from .config import Config, load_config
from .core import nputil
from .core.detail import VIOPipeline
from .frontend.tracker import KLTFeatureTracker
from .utils import inspection


class SensorType(enum.IntEnum):
    """reference XRSLAM.h XRSLAMSensorType."""
    CAMERA = 0
    DEPTH_CAMERA = 1
    ACCELERATION = 2
    GYROSCOPE = 3
    GRAVITY = 4
    ROTATION_VECTOR = 5
    UNKNOWN = 6


class ResultType(enum.IntEnum):
    """reference XRSLAM.h XRSLAMResultType."""
    BODY_POSE = 0
    CAMERA_POSE = 1
    STATE = 2
    LANDMARKS = 3
    FEATURES = 4
    BIAS = 5
    DEBUG_LOGS = 6
    VERSION = 7
    UNKNOWN = 8
    INTRINSICS = 9


class State(enum.IntEnum):
    """reference XRSLAM.h XRSLAMState."""
    INITIALIZING = 0
    TRACKING_SUCCESS = 1
    TRACKING_FAIL = 2


@dataclass
class Pose:
    """quaternion in the C ABI's [x,y,z,w] order
    (reference XRSLAM.h XRSLAMPose)."""
    timestamp: float = 0.0
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class IMUBias:
    acc_bias: np.ndarray = field(default_factory=lambda: np.zeros(3))
    gyr_bias: np.ndarray = field(default_factory=lambda: np.zeros(3))


def _wxyz_to_xyzw(q: np.ndarray) -> np.ndarray:
    return np.array([q[1], q[2], q[3], q[0]])


class XRSLAM:
    """One VIO engine instance (reference XRSLAMManager singleton,
    de-singleton-ized)."""

    def __init__(self, slam_config_path: Optional[str] = None,
                 device_config_path: Optional[str] = None,
                 config: Optional[Config] = None,
                 capacity: int = 256):
        runtime.configure()
        if config is None:
            if slam_config_path and device_config_path:
                config = load_config(slam_config_path, device_config_path)
            else:
                config = Config()
        self.config = config
        self.pipeline = VIOPipeline(
            config, KLTFeatureTracker(config, capacity=capacity))
        self._cur_image: Optional[tuple] = None
        self._cur_depth: Optional[tuple] = None
        self._last_output = None

    # -- input (reference XRSLAMPushSensorData, XRSLAMInternal.cpp:20) --
    def push_sensor_data(self, sensor_type: SensorType, timestamp: float,
                         data) -> None:
        if sensor_type == SensorType.CAMERA:
            self._cur_image = (float(timestamp), np.asarray(data))
        elif sensor_type == SensorType.DEPTH_CAMERA:
            # aligned depth image (XRSLAMDepthImage, XRSLAM.h:56-60):
            # (H,W) float32 meters (or uint16 millimeters), 0 = invalid;
            # paired with the next camera frame at a matching timestamp
            d = np.asarray(data)
            if d.dtype == np.uint16:
                d = d.astype(np.float32) / 1000.0
            self._cur_depth = (float(timestamp), d)
        elif sensor_type == SensorType.GYROSCOPE:
            out = self.pipeline.track_gyroscope(float(timestamp), data)
            self._note_output(out)
        elif sensor_type == SensorType.ACCELERATION:
            out = self.pipeline.track_accelerometer(float(timestamp), data)
            self._note_output(out)
        else:
            raise ValueError(f"unsupported sensor type {sensor_type!r}")

    def _note_output(self, out):
        if out is not None:
            self._last_output = out

    # -- step (reference XRSLAMRunOneFrame, XRSLAMManager.cpp:148-152) --
    def run_one_frame(self) -> None:
        assert self._cur_image is not None, \
            "push a CAMERA sample before run_one_frame"
        t, img = self._cur_image
        self._cur_image = None
        depth = None
        if self._cur_depth is not None:
            td, d = self._cur_depth
            if abs(td - t) < 0.02:  # within ~half a 20 Hz frame period
                depth = d
                self._cur_depth = None
            elif td <= t:
                self._cur_depth = None  # stale: matching frame already gone
            # else: depth stream leads the RGB stream — hold it for the
            # matching (future) camera frame
        self.pipeline.track_camera_image(t, img, depth=depth)
        out = self.pipeline.predict_pose(self.pipeline.last_imu_t)
        self._note_output(out)

    def flush(self) -> None:
        """Land deferred backend work (Config.worker_overlap): issue
        the last tracked frame and apply pending device write-backs.
        Call at end of stream; no-op otherwise."""
        self.pipeline.flush()

    # -- output (reference XRSLAMGetResult, XRSLAMManager.cpp:154-246) --
    def get_result(self, result_type: ResultType):
        rt = ResultType(result_type)
        if rt == ResultType.BODY_POSE:
            return self._compose_pose(self.config.imu_to_body_rotation,
                                      self.config.imu_to_body_translation)
        if rt == ResultType.CAMERA_POSE:
            return self._compose_pose(self.config.camera_to_body_rotation,
                                      self.config.camera_to_body_translation)
        if rt == ResultType.STATE:
            return (State.TRACKING_SUCCESS
                    if self.pipeline.state == "tracking"
                    else State.INITIALIZING)
        if rt == ResultType.LANDMARKS:
            return self._landmarks()
        if rt == ResultType.FEATURES:
            return self._features()
        if rt == ResultType.BIAS:
            return self._bias()
        if rt == ResultType.INTRINSICS:
            K = self.config.camera_intrinsic
            return dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])
        if rt == ResultType.VERSION:
            return __version__
        raise ValueError(f"unsupported result type {result_type!r}")

    def _compose_pose(self, q_bs, p_bs) -> Pose:
        out = self._last_output
        if out is None:
            return Pose()
        q = nputil.quat_mul(out.q, np.asarray(q_bs))
        p = out.p + nputil.quat_rotate(out.q, np.asarray(p_bs))
        return Pose(timestamp=out.t, quaternion=_wxyz_to_xyzw(q),
                    translation=p)

    def _landmarks(self) -> np.ndarray:
        swt = self.pipeline.swt
        if swt is None:
            return np.zeros((0, 3))
        pts = [tr.p_w for tr in swt.map.tracks.values()
               if tr.triangulated and tr.p_w is not None]
        return np.asarray(pts).reshape(-1, 3)

    def _features(self) -> np.ndarray:
        """2D pixel keypoints of the newest tracker frame."""
        frames = self.pipeline.tracker_map.frames
        if not frames:
            return np.zeros((0, 2))
        f = frames[-1]
        pts = getattr(f, "_pts", None)
        if pts is None:
            # bearings-only path (synthetic tracker): project through K
            sl = f.track_ids >= 0
            b = f.bearings[sl]
            z = np.clip(b[:, 2:3], 1e-9, None)
            return ((f.K @ (b / z).T).T)[:, :2]
        return pts[f.track_ids >= 0]

    def _bias(self) -> IMUBias:
        swt = self.pipeline.swt
        if swt is None:
            return IMUBias()
        _, _, _, _, bg, ba = swt.get_latest_state()
        inspection.inspect(inspection.CURRENT_BG, bg)
        inspection.inspect(inspection.CURRENT_BA, ba)
        return IMUBias(acc_bias=ba.copy(), gyr_bias=bg.copy())

    def destroy(self) -> None:
        self.pipeline = None
        self._cur_image = None
        self._last_output = None


# ---------------------------------------------------------------------------
# module-level singleton (the literal C ABI shape)
# ---------------------------------------------------------------------------

_instance: Optional[XRSLAM] = None


def create(slam_config_path: Optional[str] = None,
           device_config_path: Optional[str] = None,
           config: Optional[Config] = None) -> XRSLAM:
    """reference XRSLAMCreate (XRSLAMInternal.cpp:4)."""
    global _instance
    _instance = XRSLAM(slam_config_path, device_config_path, config)
    return _instance


def push_sensor_data(sensor_type: SensorType, timestamp: float, data) -> None:
    assert _instance is not None, "call create() first"
    _instance.push_sensor_data(sensor_type, timestamp, data)


def run_one_frame() -> None:
    assert _instance is not None, "call create() first"
    _instance.run_one_frame()


def get_result(result_type: ResultType):
    assert _instance is not None, "call create() first"
    return _instance.get_result(result_type)


def destroy() -> None:
    global _instance
    if _instance is not None:
        _instance.destroy()
    _instance = None
