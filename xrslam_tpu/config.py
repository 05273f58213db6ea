"""Configuration: the reference's full Config surface as a frozen
dataclass, plus the two-file YAML loader.

Defaults mirror the reference's virtual-getter defaults
(reference: xrslam/src/xrslam/config.cpp:16-78); the YAML schema is the
reference's slam-config + device-config pair
(reference: xrslam-extra/src/xrslam/extra/yaml_config.cpp,
configs/euroc_slam.yaml, configs/euroc_sensor.yaml), including the
OpenCV-style `%YAML:1.0` header and the `[x,y,z,w]` quaternion order
used in the files (converted here to this library's `[w,x,y,z]`).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np


def _eye3():
    return np.eye(3)


def _zeros3():
    return np.zeros(3)


def _quat_identity():
    return np.array([1.0, 0.0, 0.0, 0.0])


@dataclass(frozen=True)
class Config:
    # --- camera (device yaml cam0.*) ---
    camera_intrinsic: np.ndarray = field(default_factory=_eye3)   # K (3,3)
    camera_distortion_flag: bool = False
    camera_distortion: np.ndarray = field(default_factory=lambda: np.zeros(4))
    camera_time_offset: float = 0.0
    camera_resolution: tuple = (752, 480)
    camera_to_body_rotation: np.ndarray = field(default_factory=_quat_identity)  # q_bc [w,x,y,z]
    camera_to_body_translation: np.ndarray = field(default_factory=_zeros3)      # p_bc
    keypoint_noise_cov: np.ndarray = field(default_factory=lambda: 0.5 * np.eye(2))

    # --- imu (device yaml imu.*) ---
    imu_to_body_rotation: np.ndarray = field(default_factory=_quat_identity)  # q_bi
    imu_to_body_translation: np.ndarray = field(default_factory=_zeros3)      # p_bi
    gyroscope_noise_cov: np.ndarray = field(default_factory=lambda: 1e-4 * np.eye(3))
    accelerometer_noise_cov: np.ndarray = field(default_factory=lambda: 1e-2 * np.eye(3))
    gyroscope_bias_noise_cov: np.ndarray = field(default_factory=lambda: 1e-8 * np.eye(3))
    accelerometer_bias_noise_cov: np.ndarray = field(default_factory=lambda: 1e-6 * np.eye(3))
    accelerometer_bias: np.ndarray = field(default_factory=_zeros3)
    gyroscope_bias: np.ndarray = field(default_factory=_zeros3)

    # --- output frame ---
    output_to_body_rotation: np.ndarray = field(default_factory=_quat_identity)  # q_bo
    output_to_body_translation: np.ndarray = field(default_factory=_zeros3)      # p_bo

    # --- sliding window (config.cpp:16-20) ---
    sliding_window_size: int = 10
    sliding_window_subframe_size: int = 3
    sliding_window_force_keyframe_landmarks: int = 35
    sliding_window_tracker_frequent: int = 1

    # --- feature tracker (config.cpp:22-36) ---
    feature_tracker_min_keypoint_distance: float = 20.0
    feature_tracker_max_keypoint_detection: int = 150
    feature_tracker_max_init_frames: int = 60
    feature_tracker_max_frames: int = 200
    feature_tracker_clahe_clip_limit: float = 6.0
    feature_tracker_clahe_width: int = 8
    feature_tracker_clahe_height: int = 8
    feature_tracker_predict_keypoints: bool = True

    # --- initializer (config.cpp:38-52) ---
    initializer_keyframe_num: int = 8
    initializer_keyframe_gap: int = 5
    initializer_min_matches: int = 50
    initializer_min_parallax: float = 10.0
    initializer_min_triangulation: int = 50
    initializer_min_landmarks: int = 30
    initializer_refine_imu: bool = True

    # --- camera-rate visual PnP pose path (the reference's iOS-only
    # high-rate path, compile-time gated by XRSLAM_IOS:
    # feature_tracker.cpp:95-112 synchronize_keymap/solve_pnp; here a
    # runtime flag). Combined with sliding_window_tracker_frequent > 1
    # it publishes camera-rate poses while the window BA runs at a
    # reduced rate.
    visual_pnp_enable: bool = False
    visual_pnp_min_landmarks: int = 8

    # --- visual localization (config.cpp:54-58) ---
    visual_localization_enable: bool = False
    visual_localization_config_ip: str = "0.0.0.0"
    visual_localization_config_port: int = 0

    # --- solver (config.cpp:60-62) ---
    solver_iteration_limit: int = 10
    # defer the subframe write-back fetch to the next frame so the
    # solve overlaps the tracker's host work (the reference's threaded
    # backend lag, XRSLAM_ENABLE_THREADING=ON semantics; outputs stay
    # fresh via IMU forward propagation). No reference config
    # counterpart; parsac_flag forces synchronous writes either way.
    deferred_subframe_write: bool = True
    # run the backend (initializer / sliding-window issue) for frame t
    # DURING frame t+1's tracker round trip — after the tracker's device
    # programs are dispatched, before its blocking fetch — so backend
    # host work overlaps device compute + the fetch. One-frame
    # backend lag, the reference's XRSLAM_ENABLE_THREADING=ON worker
    # semantics (frontend_worker.cpp job queue) without threads; output
    # poses stay fresh via IMU forward propagation from the last
    # optimized anchor. Call VIOPipeline.flush() (api.XRSLAM.flush) at
    # end of stream to land the final deferred frame.
    worker_overlap: bool = False
    # depth-2 write-back pipeline on top of worker_overlap: the tracker
    # pack (the one per-frame device→host transfer) is SUBMITTED BEFORE
    # the backend stage runs, so it never waits on the current frame's
    # solve programs — solve write-backs ride the NEXT frame's pack
    # instead (up to two solves in flight). Every window extraction
    # corrects its stale host reads by injecting the pending solves'
    # device states (SlidingWindowTracker._inject_solved), so the solve
    # sequence is value-identical to the depth-1 schedule; only output
    # anchoring and landmark-gate bookkeeping lag one extra frame (the
    # reference's threaded-backend semantics under load). Requires
    # worker_overlap + deferred_subframe_write, parsac-off.
    pipelined_writeback: bool = False
    # EXPERIMENTAL device-chained KLT frontend (requires worker_overlap
    # + pipelined_writeback): frame n's KLT is dispatched directly from
    # frame n-1's DEVICE-side outputs (stable keypoint slots, no host
    # compaction), so the per-frame pack pull drops off the
    # pull→host-relayout→KLT serial loop entirely — the host's Poisson
    # re-filter / detection decisions land as a masked slot-update put
    # one frame later. OFF by default: new
    # detections join the device state two frames after detection
    # (rotation-compensated injection), which breaks the subwindow
    # extraction's KLT-chain-contiguity assumption (observation gaps
    # {k, k+2}) and measurably degrades f32 end-to-end accuracy
    # (ATE 0.09 → ~0.5 on the bench scene; f64 CPU runs are fine).
    # Making the backend gap-tolerant is the remaining work.
    chained_frontend: bool = False
    # fixed landmark-slot capacities of the jitted window solves (no
    # reference counterpart — the reference builds dynamic Ceres
    # problems; we compile one executable per static shape)
    window_landmark_slots: int = 384
    init_landmark_slots: int = 256
    solver_time_limit: float = 1.0e6

    # --- rotation / pure-rotation detection (config.cpp:64-66) ---
    rotation_misalignment_threshold: float = 0.1
    rotation_ransac_threshold: float = 10.0

    # --- random seed (config.cpp:66: 648) ---
    random: int = 648

    # --- parsac (config.cpp:70-78) ---
    parsac_flag: bool = False
    parsac_dynamic_probability: float = 0.0
    parsac_threshold: float = 3.0
    parsac_norm_scale: float = 1.0
    parsac_keyframe_check_size: int = 3

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_INT = re.compile(r"[-+]?[0-9]+$")
# yaml-cpp (the reference's loader) also reads exponents without a
# sign ("1.0e6") as floats
_FLOAT = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")


def _scalar(tok: str):
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str, where: str):
    if not text.startswith("["):
        return _scalar(text)
    if not text.endswith("]") or "[" in text[1:]:
        raise ValueError(f"{where}: only flat flow lists are supported")
    inner = text[1:-1].strip()
    return [_scalar(t.strip()) for t in inner.split(",")] if inner else []


def parse_opencv_yaml(text: str, where: str = "<yaml>") -> dict:
    """Parse the OpenCV-YAML subset the config files use: the `%YAML`
    header, `#` comments, nested maps by indentation, scalars (int,
    float, bool, null, plain or quoted strings) and flow lists `[...]`,
    which may span lines. Anything else raises ValueError."""
    logical, pending = [], None
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.startswith("%YAML") or raw.strip() == "---":
            continue
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if pending is not None:
            pending[1] += " " + line.strip()
        else:
            pending = [n, line]
        if pending[1].count("[") <= pending[1].count("]"):
            logical.append(tuple(pending))
            pending = None
    if pending is not None:
        raise ValueError(f"{where}:{pending[0]}: unterminated flow list")

    root: dict = {}
    stack = [(0, root)]   # (indent of the map's keys, map) of open maps
    opened = None         # (indent, map) of a "key:" awaiting its keys
    empty = []            # (parent, key, map) opened by "key:"
    for n, line in logical:
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith(("-", "\t")) or ":" not in body:
            raise ValueError(f"{where}:{n}: unsupported syntax: {body!r}")
        key, _, rest = body.partition(":")
        if rest and not rest.startswith((" ", "\t")):
            raise ValueError(f"{where}:{n}: expected 'key: value'")
        key, rest = key.strip(), rest.strip()
        if opened is not None and indent > opened[0]:
            stack.append((indent, opened[1]))
        opened = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}:{n}: inconsistent indentation")
        parent = stack[-1][1]
        if rest:
            parent[key] = _value(rest, f"{where}:{n}")
        else:
            child: dict = {}
            parent[key] = child
            opened = (indent, child)
            empty.append((parent, key, child))
    for parent, key, child in empty:
        if not child:      # "key:" with nothing nested is a null value
            parent[key] = None
    return root


def _load_opencv_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read(), path)


def _quat_xyzw_to_wxyz(q) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return np.array([q[3], q[0], q[1], q[2]])


def load_config(slam_yaml: str, device_yaml: str) -> Config:
    """Load the reference's (slam, device) YAML pair into a Config."""
    slam = _load_opencv_yaml(slam_yaml) or {}
    dev = _load_opencv_yaml(device_yaml) or {}
    kw = {}

    cam = dev.get("cam0", {})
    if "intrinsics" in cam:
        fu, fv, cu, cv = cam["intrinsics"]
        kw["camera_intrinsic"] = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])
    if "resolution" in cam:
        kw["camera_resolution"] = tuple(cam["resolution"])
    if "camera_distortion_flag" in cam:
        kw["camera_distortion_flag"] = bool(cam["camera_distortion_flag"])
    if "distortion" in cam:
        kw["camera_distortion"] = np.asarray(cam["distortion"], dtype=np.float64)[:4]
    if "time_offset" in cam:
        kw["camera_time_offset"] = float(cam["time_offset"])
    if "extrinsic" in cam:
        kw["camera_to_body_rotation"] = _quat_xyzw_to_wxyz(cam["extrinsic"]["q_bc"])
        kw["camera_to_body_translation"] = np.asarray(cam["extrinsic"]["p_bc"], dtype=np.float64)
    if "noise" in cam:
        kw["keypoint_noise_cov"] = np.asarray(cam["noise"], dtype=np.float64).reshape(2, 2)

    imu = dev.get("imu", {})
    if "extrinsic" in imu:
        kw["imu_to_body_rotation"] = _quat_xyzw_to_wxyz(imu["extrinsic"]["q_bi"])
        kw["imu_to_body_translation"] = np.asarray(imu["extrinsic"]["p_bi"], dtype=np.float64)
    noise = imu.get("noise", {})
    for yk, ck in [("cov_g", "gyroscope_noise_cov"), ("cov_a", "accelerometer_noise_cov"),
                   ("cov_bg", "gyroscope_bias_noise_cov"), ("cov_ba", "accelerometer_bias_noise_cov")]:
        if yk in noise:
            kw[ck] = np.asarray(noise[yk], dtype=np.float64).reshape(3, 3)
    for yk, ck in [("accelerometer_bias", "accelerometer_bias"), ("gyroscope_bias", "gyroscope_bias")]:
        if yk in imu:
            kw[ck] = np.asarray(imu[yk], dtype=np.float64)

    out = slam.get("output", {})
    if "q_bo" in out:
        kw["output_to_body_rotation"] = _quat_xyzw_to_wxyz(out["q_bo"])
    if "p_bo" in out:
        kw["output_to_body_translation"] = np.asarray(out["p_bo"], dtype=np.float64)

    def take(section: str, prefix: str, names):
        sec = slam.get(section, {})
        for n in names:
            if n in sec:
                key = f"{prefix}_{n}" if prefix else n
                kw[key] = sec[n]

    take("sliding_window", "sliding_window", ["size", "subframe_size", "force_keyframe_landmarks"])
    if "sliding_window" in slam and "tracker_frequent" in slam["sliding_window"]:
        kw["sliding_window_tracker_frequent"] = slam["sliding_window"]["tracker_frequent"]
    take("feature_tracker", "feature_tracker",
         ["min_keypoint_distance", "max_keypoint_detection", "max_init_frames",
          "max_frames", "predict_keypoints", "clahe_clip_limit", "clahe_width", "clahe_height"])
    take("initializer", "initializer",
         ["keyframe_num", "keyframe_gap", "min_matches", "min_parallax",
          "min_triangulation", "min_landmarks", "refine_imu"])
    take("solver", "solver", ["iteration_limit", "time_limit"])
    rot = slam.get("rotation", {})
    if "misalignment_threshold" in rot:
        kw["rotation_misalignment_threshold"] = rot["misalignment_threshold"]
    if "ransac_threshold" in rot:
        kw["rotation_ransac_threshold"] = rot["ransac_threshold"]
    par = slam.get("parsac", {})
    for n in ["parsac_flag", "dynamic_probability", "threshold", "norm_scale", "keyframe_check_size"]:
        if n in par:
            kw["parsac_flag" if n == "parsac_flag" else f"parsac_{n}"] = par[n]
    vpnp = slam.get("visual_pnp", {})
    if "enable" in vpnp:
        kw["visual_pnp_enable"] = bool(vpnp["enable"])
    if "min_landmarks" in vpnp:
        kw["visual_pnp_min_landmarks"] = int(vpnp["min_landmarks"])
    loc = slam.get("visual_localization", {})
    for n in ["enable", "ip", "port"]:
        if n in loc:
            key = {"enable": "visual_localization_enable",
                   "ip": "visual_localization_config_ip",
                   "port": "visual_localization_config_port"}[n]
            kw[key] = loc[n]

    # coerce scalars to the declared field types (e.g. 0/1 flags)
    defaults = Config()
    for k, v in list(kw.items()):
        d = getattr(defaults, k)
        if isinstance(d, bool):
            kw[k] = v if isinstance(v, bool) else bool(int(v))
        elif isinstance(d, int):
            kw[k] = int(v)
        elif isinstance(d, float):
            kw[k] = float(v)
    return Config(**kw)
