"""Host side of the C ABI (native/xr_capi.cpp).

The native shim embeds CPython and calls the flat functions in this
module with only scalars / bytes / str — no numpy or jax objects cross
the C boundary, so the shim needs nothing beyond the stable CPython
object protocol. Together they export the reference's C surface
(reference: xrslam-interface/include/XRSLAM.h:195-230 and the singleton
XRSLAMManager, xrslam-interface/src/XRSLAMManager.{h,cpp}) over the
JAX engine. Embedded interpreters inherit only the environment, so
`JAX_PLATFORMS=cpu your_c_program` selects the backend as usual.

All returns are plain tuples/bytes/str. Pose tuples are
(qx, qy, qz, qw, px, py, pz, t) — the C ABI's [x,y,z,w] order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .api import XRSLAM, ResultType, SensorType

_engine: Optional[XRSLAM] = None


def create(slam_config_path: str, device_config_path: str) -> int:
    """Returns 1 on success; raises on config errors (the shim converts
    the exception to a 0 return + XRSLAMGetLastError)."""
    global _engine
    _engine = XRSLAM(slam_config_path or None, device_config_path or None)
    return 1


def destroy() -> None:
    global _engine
    if _engine is not None:
        _engine.flush()
        _engine.destroy()
        _engine = None


def camera_bytes(stride: int) -> int:
    """Byte count of one camera frame at the given row stride (the
    image height comes from the device config's camera resolution)."""
    _, h = _engine.config.camera_resolution
    return int(stride) * int(h)


def depth_bytes() -> int:
    w, h = _engine.config.camera_resolution
    return int(w) * int(h) * 2


def push_camera(t: float, data: bytes, stride: int, channel: int) -> None:
    """Gray or interleaved-RGB(A) rows of the configured resolution
    (the image height comes from the device config, exactly like the
    reference manager — XRSLAMManager.cpp:55-76 channel conversion)."""
    w, h = _engine.config.camera_resolution
    ch = max(int(channel), 1)
    arr = np.frombuffer(data, np.uint8, count=stride * h).reshape(h, stride)
    arr = arr[:, : w * ch]
    if ch > 1:
        rgb = arr.reshape(h, w, ch)[..., :3].astype(np.float32)
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2])
    else:
        gray = arr.astype(np.float32)
    # the pipeline's image convention is float32 in [0,1]
    # (VIOPipeline.track_camera_image)
    _engine.push_sensor_data(SensorType.CAMERA, t, gray / 255.0)


def push_depth(t: float, data: bytes) -> None:
    w, h = _engine.config.camera_resolution
    d = np.frombuffer(data, np.uint16, count=w * h).reshape(h, w)
    _engine.push_sensor_data(SensorType.DEPTH_CAMERA, t, d)


def push_imu(kind: int, t: float, x: float, y: float, z: float) -> None:
    _engine.push_sensor_data(SensorType(kind), t, np.array([x, y, z]))


def run_one_frame() -> None:
    _engine.run_one_frame()


def get_pose(which: int) -> tuple:
    pose = _engine.get_result(ResultType(which))
    q, p = pose.quaternion, pose.translation
    return (float(q[0]), float(q[1]), float(q[2]), float(q[3]),
            float(p[0]), float(p[1]), float(p[2]), float(pose.timestamp))


def get_state() -> int:
    return int(_engine.get_result(ResultType.STATE))


def get_landmarks() -> bytes:
    """float64 (x,y,z) triples."""
    pts = _engine.get_result(ResultType.LANDMARKS)
    return np.ascontiguousarray(pts, dtype=np.float64).tobytes()


def get_features() -> bytes:
    """float64 (x,y) pixel pairs of the newest tracked frame."""
    pts = _engine.get_result(ResultType.FEATURES)
    return np.ascontiguousarray(pts, dtype=np.float64).tobytes()


def get_bias() -> tuple:
    b = _engine.get_result(ResultType.BIAS)
    return tuple(float(v) for v in b.acc_bias) + \
        tuple(float(v) for v in b.gyr_bias)


def get_intrinsics() -> tuple:
    d = _engine.get_result(ResultType.INTRINSICS)
    return (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]))


def get_version() -> str:
    return str(_engine.get_result(ResultType.VERSION))


def get_debug_logs() -> str:
    """Drain the UI message queue (reference Logger::getAllMessage,
    utility/logger.h:5-27; exported through the C ABI's
    XRSLAM_RESULT_DEBUG_LOGS)."""
    from .utils.logging import Logger

    return "\n".join(Logger.instance().get_all_messages())
