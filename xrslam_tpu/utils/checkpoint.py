"""Checkpoint/resume of the full VIO pipeline state.

The reference has no checkpointing at all (SURVEY.md §5 — its only
persisted outputs are trajectory files); long-lived batched/distributed
runs on accelerators need restartability, so this module serializes everything
the online system owns: the tracker and window maps (frames, tracks,
landmarks, tags), the marginalization prior (sqrt-inv-cov, info vector,
linearization point), IMU buffers, forward-propagation state, PRNG
keys, PARSAC bin confidences, and the monotonic id counters.

Format: a single .npz — arrays stored flat under path-like keys plus a
JSON manifest (`__manifest__`) describing the tree; no pickle anywhere,
so checkpoints are safe to load from untrusted storage.

Limitations: the KLT tracker's image pyramids are not checkpointed
(they are per-frame caches); after resume, the first camera frame
re-detects keypoints and tracking continues on the restored window.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from ..config import Config
from ..core.detail import VIOPipeline
from ..core.map import FrameRec, PipelineMap, TrackRec
from ..core.sliding_window import SlidingWindowTracker
from ..estimation.window import MargPrior

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# generic tree <-> npz
# ---------------------------------------------------------------------------

def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str):
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, np.bool_)):
        return {"t": "bool", "v": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        return {"t": "int", "v": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"t": "float", "v": float(obj)}
    if isinstance(obj, str):
        return {"t": "str", "v": obj}
    if isinstance(obj, (list, tuple)):
        return {"t": "list",
                "items": [_encode(v, arrays, f"{path}/{i}")
                          for i, v in enumerate(obj)]}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        return {"t": "dict",
                "keys": [_encode(k, arrays, f"{path}/k{i}")
                         for i, k in enumerate(keys)],
                "vals": [_encode(obj[k], arrays, f"{path}/v{i}")
                         for i, k in enumerate(keys)]}
    arr = np.asarray(obj)  # ndarray or jax array
    arrays[path] = arr
    return {"t": "arr", "k": path}


def _decode(node, arrays) -> Any:
    t = node["t"]
    if t == "none":
        return None
    if t in ("bool", "int", "float", "str"):
        return node["v"]
    if t == "list":
        return [_decode(n, arrays) for n in node["items"]]
    if t == "dict":
        return {_decode(k, arrays): _decode(v, arrays)
                for k, v in zip(node["keys"], node["vals"])}
    return arrays[node["k"]]


def save_tree(path: str, tree: Any) -> None:
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode(tree, arrays, "r")
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"version": FORMAT_VERSION, "tree": manifest}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tree(path: str) -> Any:
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        assert manifest["version"] == FORMAT_VERSION, \
            f"checkpoint format {manifest['version']} != {FORMAT_VERSION}"
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _decode(manifest["tree"], arrays)


# ---------------------------------------------------------------------------
# pipeline <-> tree
# ---------------------------------------------------------------------------

_FRAME_ARRAYS = ["q", "p", "v", "bg", "ba", "q_bc", "p_bc", "q_bi", "p_bi",
                 "K", "sqrt_inv_cov2", "bearings", "track_ids",
                 "imu_t", "imu_w", "imu_a"]
_FRAME_FLAGS = ["keyframe", "no_translation", "fix_pose", "fix_motion"]


def _frame_tree(f: FrameRec) -> dict:
    d = {"id": f.id, "t": f.t}
    for k in _FRAME_ARRAYS:
        d[k] = getattr(f, k)
    for k in _FRAME_FLAGS:
        d[k] = getattr(f, k)
    d["subframes"] = [_frame_tree(s) for s in f.subframes]
    pts = getattr(f, "_pts", None)
    d["_pts"] = pts
    return d


def _frame_from(d: dict) -> FrameRec:
    f = FrameRec(
        id=int(d["id"]), t=float(d["t"]),
        **{k: np.asarray(d[k]) for k in _FRAME_ARRAYS})
    for k in _FRAME_FLAGS:
        setattr(f, k, bool(d[k]))
    f.subframes = [_frame_from(s) for s in d["subframes"]]
    if d.get("_pts") is not None:
        f._pts = np.asarray(d["_pts"])
    return f


def _track_tree(tr: TrackRec) -> dict:
    return {"id": tr.id, "obs": dict(tr.obs), "p_w": tr.p_w,
            "valid": tr.valid, "triangulated": tr.triangulated,
            "static": tr.static, "outlier": tr.outlier,
            "trash": tr.trash, "life": tr.life}


def _track_from(d: dict) -> TrackRec:
    return TrackRec(
        id=int(d["id"]), obs={int(k): int(v) for k, v in d["obs"].items()},
        p_w=None if d["p_w"] is None else np.asarray(d["p_w"]),
        valid=bool(d["valid"]), triangulated=bool(d["triangulated"]),
        static=bool(d["static"]), outlier=bool(d["outlier"]),
        trash=bool(d["trash"]), life=int(d["life"]))


def _map_tree(m: PipelineMap) -> dict:
    return {"frames": [_frame_tree(f) for f in m.frames],
            "tracks": [_track_tree(t) for t in m.tracks.values()]}


def _map_from(d: dict) -> PipelineMap:
    m = PipelineMap()
    m.frames = [_frame_from(f) for f in d["frames"]]
    m.tracks = {}
    for td in d["tracks"]:
        tr = _track_from(td)
        m.tracks[tr.id] = tr
    return m


def pipeline_tree(p: VIOPipeline) -> dict:
    """Everything needed to resume (see module docstring)."""
    swt = p.swt
    if swt is not None:
        # land any in-flight deferred subframe write before serializing
        # frame states
        swt.materialize_pending()
    tree = {
        "tracker_map": _map_tree(p.tracker_map),
        "gyro_buf": [[t, w] for t, w in p.gyro_buf],
        "accel_buf": [[t, a] for t, a in p.accel_buf],
        "imu_pending": [[t, w, a] for t, w, a in p.imu_pending],
        "last_imu_t": float(p.last_imu_t) if np.isfinite(p.last_imu_t) else None,
        "prop": p._prop,
        "imu_since_opt": [[t, w, a] for t, w, a in p._imu_since_opt],
        "last_frame_t": p._last_frame_t,
        "last_taken": None if p._last_taken is None else list(p._last_taken),
        "swt": None,
    }
    if swt is not None:
        marg = None
        if swt.marg is not None:
            marg = {"sqrt_inv_cov": swt.marg.sqrt_inv_cov,
                    "infovec": swt.marg.infovec,
                    "lin": list(swt.marg.lin)}
        tree["swt"] = {
            "map": _map_tree(swt.map),
            "marg": marg,
            "bin_conf": swt.bin_conf,
            "key": swt._key,
            "m_th": swt.m_th,
        }
    # id counters: store the horizon so resumed ids never collide
    from ..core import map as map_mod
    tree["next_frame_id"] = next(map_mod._frame_id_counter)
    tree["next_track_id"] = next(map_mod._track_id_counter)
    return tree


def restore_pipeline(tree: dict, config: Config, tracker) -> VIOPipeline:
    import itertools

    import jax.numpy as jnp

    from ..core import map as map_mod

    p = VIOPipeline(config, tracker)
    p.tracker_map = _map_from(tree["tracker_map"])
    p.gyro_buf = [(float(t), np.asarray(w)) for t, w in tree["gyro_buf"]]
    p.accel_buf = [(float(t), np.asarray(a)) for t, a in tree["accel_buf"]]
    p.imu_pending = [(float(t), np.asarray(w), np.asarray(a))
                     for t, w, a in tree["imu_pending"]]
    p.last_imu_t = (-np.inf if tree["last_imu_t"] is None
                    else float(tree["last_imu_t"]))
    prop = tree["prop"]
    if prop is not None:
        p._prop = {k: (float(v) if k == "t" else np.asarray(v))
                   for k, v in prop.items()}
    p._imu_since_opt = [(float(t), np.asarray(w), np.asarray(a))
                        for t, w, a in tree["imu_since_opt"]]
    p._last_frame_t = (None if tree.get("last_frame_t") is None
                       else float(tree["last_frame_t"]))
    lt = tree.get("last_taken")
    p._last_taken = None if lt is None else (
        float(lt[0]), np.asarray(lt[1]), np.asarray(lt[2]))

    if tree["swt"] is not None:
        s = tree["swt"]
        swt = SlidingWindowTracker(_map_from(s["map"]), config)
        if s["marg"] is not None:
            from ..estimation.window import WindowState
            m = s["marg"]
            swt.marg = MargPrior(
                sqrt_inv_cov=jnp.asarray(m["sqrt_inv_cov"]),
                infovec=jnp.asarray(m["infovec"]),
                lin=WindowState(*[jnp.asarray(x) for x in m["lin"]]))
        swt.bin_conf = jnp.asarray(s["bin_conf"])
        swt._key = jnp.asarray(s["key"])
        swt.m_th = float(s["m_th"])
        p.swt = swt
        p.initializer = None

    # fast-forward global id counters past the checkpoint horizon
    map_mod._frame_id_counter = itertools.count(int(tree["next_frame_id"]))
    map_mod._track_id_counter = itertools.count(int(tree["next_track_id"]))
    return p


def save_pipeline(path: str, p: VIOPipeline) -> None:
    save_tree(path, pipeline_tree(p))


def load_pipeline(path: str, config: Config, tracker) -> VIOPipeline:
    return restore_pipeline(load_tree(path), config, tracker)
