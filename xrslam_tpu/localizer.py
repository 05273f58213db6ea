"""Visual (re)localization: SLAM→global-map registration.

The reference's Localizer is an HTTP/JSON client to an XRLocalization
server (reference: xrslam/src/xrslam/localizer/localizer.{h,cpp}): it
posts a base64 JPEG + intrinsics to `/loc`, receives a global camera
pose `qvec/tvec` + inlier count, and maintains the SLAM→SfM similarity
transform (localizer.cpp:96-155, 209-215), with throttled
fire-and-forget queries (:219-240) and periodic pose upload to `/pose`
(:180-207).

Two backends here:
  - `MapLocalizer` — the in-process equivalent: batched
    RANSAC PnP (ransac/pnp.py) against a prebuilt global landmark map,
    same transform bookkeeping, no server round-trip.
  - `HttpLocalizer` — protocol-compatible client for an actual
    XRLocalization server (stdlib http.client; JPEG via PIL).

Both share the transform math: given the global camera pose
T_g_cam and the SLAM-frame output pose at the same instant,
  slam_to_global = T_g_cam ∘ T_cam_slam          (localizer.cpp:152-155)
and subsequent outputs are mapped with
  out = slam_to_global ∘ pose                    (localizer.cpp:209-215).

Screen-orientation handling (localizer.cpp:258-317) is the Portrait
case here; the Right/Left/Down z-rotations are applied when the caller
passes `screen_state`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple

import numpy as np

from .core import nputil


class ScreenState(Enum):
    PORTRAIT = 0
    RIGHT = 1
    LEFT = 2
    DOWN = 3


@dataclass
class SE3:
    q: np.ndarray  # [w,x,y,z]
    p: np.ndarray

    @staticmethod
    def identity() -> "SE3":
        return SE3(np.array([1.0, 0, 0, 0]), np.zeros(3))

    def inverse(self) -> "SE3":
        qi = nputil.quat_conj(self.q)
        return SE3(qi, -nputil.quat_rotate(qi, self.p))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(nputil.quat_mul(self.q, other.q),
                   self.p + nputil.quat_rotate(self.q, other.p))

    def apply(self, x: np.ndarray) -> np.ndarray:
        return nputil.quat_rotate(self.q, x) + self.p


def _screen_rotation(q_slam_cam: np.ndarray, state: ScreenState) -> np.ndarray:
    """q_cam1_cam0: rotation about the camera's optical axis expressed
    in the SLAM frame (localizer.cpp:124-146)."""
    if state == ScreenState.PORTRAIT:
        return np.array([1.0, 0, 0, 0])
    z_in_slam = nputil.quat_rotate(q_slam_cam, np.array([0.0, 0.0, 1.0]))
    angle = {ScreenState.RIGHT: -np.pi / 2,
             ScreenState.LEFT: np.pi / 2,
             ScreenState.DOWN: np.pi}[state]
    return nputil.expmap(z_in_slam * angle)


class LocalizerBase:
    """Shared transform bookkeeping + query throttling."""

    def __init__(self, config=None, query_interval: float = 3.0,
                 min_inliers: int = 20):
        self.config = config
        self.query_interval = query_interval
        self.min_inliers = min_inliers
        self.slam_to_global = SE3.identity()
        self._init = False
        self._lock = threading.Lock()
        self._last_query_t = -np.inf
        self._query_frame_flag = False
        # output(cam)-to-body extrinsic used for transform anchoring
        if config is not None:
            self._q_bo = np.asarray(config.output_to_body_rotation, float)
            self._p_bo = np.asarray(config.output_to_body_translation, float)
        else:
            self._q_bo = np.array([1.0, 0, 0, 0])
            self._p_bo = np.zeros(3)

    def is_initialized(self) -> bool:
        return self._init

    def query_frame(self) -> None:
        """Force the next query_localization call through the throttle
        (reference Localizer::query_frame)."""
        self._query_frame_flag = True

    def transform(self, q: np.ndarray, p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """SLAM-frame pose → global frame (localizer.cpp:209-215)."""
        with self._lock:
            T = self.slam_to_global
        return (nputil.quat_mul(T.q, q), T.p + nputil.quat_rotate(T.q, p))

    # ------------------------------------------------------------------
    def _update_transform(self, q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                          q_g_cam: np.ndarray, p_g_cam: np.ndarray,
                          screen_state: ScreenState = ScreenState.PORTRAIT):
        """Register slam→global from one (body pose in SLAM, camera pose
        in global) pair — the math of localizer.cpp:113-155. The global
        pose is world-to-camera (COLMAP qvec/tvec convention)."""
        q_slam_cam = nputil.quat_mul(q_slam_body, self._q_bo)
        p_slam_cam = p_slam_body + nputil.quat_rotate(q_slam_body, self._p_bo)
        q_rot = _screen_rotation(q_slam_cam, screen_state)
        T_slam_cam1 = SE3(nputil.quat_mul(q_rot, q_slam_cam), p_slam_cam)
        T_cam1_slam = T_slam_cam1.inverse()
        T_g_cam1 = SE3(np.asarray(q_g_cam, float), np.asarray(p_g_cam, float))
        with self._lock:
            self.slam_to_global = T_g_cam1 @ T_cam1_slam
            self._init = True

    def _throttle(self, t: float) -> bool:
        if t - self._last_query_t > self.query_interval or self._query_frame_flag:
            self._last_query_t = t
            self._query_frame_flag = False
            return True
        return False


class MapLocalizer(LocalizerBase):
    """In-process relocalizer: batched RANSAC PnP against a prebuilt
    global landmark map. Replaces the reference's server round-trip
    with an on-device solve; the 'server' is a (points3d, bearings)
    correspondence provider."""

    def __init__(self, config=None, matcher=None, **kw):
        """`matcher(image_or_frame)` returns (X (N,3) global points,
        x (N,2) normalized image coords, valid (N,)) correspondences —
        the retrieval+matching stage of the XRLocalization server."""
        super().__init__(config, **kw)
        self.matcher = matcher
        self._seed = 0

    def query_localization(self, t: float, frame_data,
                           q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                           screen_state: ScreenState = ScreenState.PORTRAIT) -> bool:
        if not self._throttle(t) or self.matcher is None:
            return False
        import jax
        import jax.numpy as jnp

        from .ransac import pnp as pnp_mod

        got = self.matcher(frame_data)
        if got is None:
            return False
        X, x, valid = got
        if int(np.sum(valid)) < self.min_inliers:
            return False
        self._seed += 1
        key = jax.random.PRNGKey(self._seed)
        T, inliers, _count = pnp_mod.find_pnp_matrix(
            key, jnp.asarray(X), jnp.asarray(x), valid=jnp.asarray(valid))
        n_in = int(np.sum(np.asarray(inliers)))
        if n_in < self.min_inliers:
            return False
        T = np.asarray(T)
        # PnP yields world→camera [R|t]; the transform update expects
        # the camera pose in the global map (cam→global), which is what
        # the reference's server returns as qvec/tvec
        # (localizer.cpp:105-111,152-155)
        R_cw = T[:3, :3]
        q_g_cam = nputil.matrix_to_quat(R_cw.T)
        p_g_cam = -R_cw.T @ T[:3, 3]
        self._update_transform(q_slam_body, p_slam_body, q_g_cam, p_g_cam,
                               screen_state)
        return True


class HttpLocalizer(LocalizerBase):
    """Protocol client for an XRLocalization server (`/loc`, `/pose`) —
    reference localizer.cpp:53-207. Queries run on a daemon thread
    (fire-and-forget, :230-236)."""

    def __init__(self, config, ip: Optional[str] = None,
                 port: Optional[int] = None, **kw):
        super().__init__(config, **kw)
        self.ip = ip or config.visual_localization_config_ip
        self.port = port or config.visual_localization_config_port
        self._pose_buf: list = []

    def query_localization(self, t: float, image: np.ndarray,
                           q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                           screen_state: ScreenState = ScreenState.PORTRAIT,
                           block: bool = False):
        if not self._throttle(t):
            return
        args = (image.copy(), q_slam_body.copy(), p_slam_body.copy(),
                screen_state)
        if block:
            self._query_loc(*args)
        else:
            threading.Thread(target=self._query_loc, args=args,
                             daemon=True).start()

    def _query_loc(self, image, q_slam_body, p_slam_body, screen_state):
        import base64
        import io
        import json
        from http.client import HTTPConnection

        from .utils.logging import log_warning

        try:
            from PIL import Image as PILImage

            arr = np.clip(image * 255.0, 0, 255).astype(np.uint8) \
                if image.dtype != np.uint8 else image
            buf = io.BytesIO()
            PILImage.fromarray(arr).save(buf, format="JPEG")
            # XRLocalization request shape (reference localizer.cpp:67-79):
            # base64 JPEG + an OPENCV intrinsic block whose params are
            # [fx, fy, cx, cy] followed by the distortion coefficients
            K = np.asarray(self.config.camera_intrinsic)
            params = [float(K[0, 0]), float(K[1, 1]),
                      float(K[0, 2]), float(K[1, 2])]
            params += [float(d) for d in
                       np.ravel(self.config.camera_distortion)]
            msg = {
                "image": base64.b64encode(buf.getvalue()).decode(),
                "intrinsic": {
                    "model": "OPENCV",
                    "width": int(arr.shape[1]), "height": int(arr.shape[0]),
                    "params": params,
                },
            }
            conn = HTTPConnection(self.ip, self.port, timeout=30)
            conn.request("POST", "/loc", json.dumps(msg),
                         {"Content-Type": "application/json"})
            res = conn.getresponse()
            if res.status != 200:
                log_warning("localizer /loc query failed: HTTP %d",
                            res.status)
                return
            out = json.loads(res.read())
            if out.get("ninlier", 0) <= self.min_inliers:
                log_warning("localizer /loc rejected: ninlier %d <= %d",
                            int(out.get("ninlier", 0)), self.min_inliers)
                return
            qvec = np.asarray(out["qvec"], float)   # [w,x,y,z] (COLMAP)
            tvec = np.asarray(out["tvec"], float)
            self._update_transform(q_slam_body, p_slam_body, qvec, tvec,
                                   screen_state)
        except Exception as e:  # fire-and-forget like the reference's
            # detached thread (localizer.cpp:163-166) — but never silent
            log_warning("localizer /loc query failed: %s", e)

    def add_pose_message(self, t: float, q: np.ndarray, p: np.ndarray):
        """Buffer a pose for upload (reference add_pose_message)."""
        self._pose_buf.extend([float(p[0]), float(p[1]), float(p[2]),
                               float(q[1]), float(q[2]), float(q[3]),
                               float(q[0])])

    def send_pose(self):
        import json
        from http.client import HTTPConnection

        from .utils.logging import log_warning

        try:
            conn = HTTPConnection(self.ip, self.port, timeout=30)
            conn.request("POST", "/pose", json.dumps({"pose": self._pose_buf}),
                         {"Content-Type": "application/json"})
            if conn.getresponse().status == 200:
                self._pose_buf.clear()
        except Exception as e:
            log_warning("localizer /pose upload failed: %s", e)
