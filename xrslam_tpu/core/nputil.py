"""Tiny numpy quaternion helpers for host-side orchestration (the
jitted compute path uses geometry/lie.py; these avoid device round
trips for scalar bookkeeping). Convention [w,x,y,z], matching lie.py."""

from __future__ import annotations

import math

import numpy as np


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    # expanded cross products: two np.cross calls cost ~90 µs of numpy
    # envelope per rotation, and this runs per IMU sample on the host
    # prediction path — scalar arithmetic is ~20x faster here
    w, x, y, z = q
    vx, vy, vz = v
    cx = y * vz - z * vy + w * vx
    cy = z * vx - x * vz + w * vy
    cz = x * vy - y * vx + w * vz
    return np.array([
        vx + 2.0 * (y * cz - z * cy),
        vy + 2.0 * (z * cx - x * cz),
        vz + 2.0 * (x * cy - y * cx),
    ])


def quat_rotate_inv(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    if q[0] < 0:
        q = -q
    return q


def quat_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking a to b (Eigen Quaternion::FromTwoVectors)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d < -1.0 + 1e-12:
        # antipodal: rotate pi about any axis orthogonal to a
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis /= np.linalg.norm(axis)
        return np.array([0.0, *axis])
    q = np.array([1.0 + d, *c])
    return q / np.linalg.norm(q)


def expmap(w: np.ndarray) -> np.ndarray:
    # scalar math (np.linalg envelopes cost ~10 µs per call and this
    # runs per IMU sample on the host prediction path); keeps the
    # input's dtype like the numpy formulation did
    w0, w1, w2 = w
    th = math.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
    if th < 1e-12:
        return np.array([1.0, 0.5 * w0, 0.5 * w1, 0.5 * w2],
                        dtype=np.asarray(w).dtype)
    s = math.sin(0.5 * th) / th
    return np.array([math.cos(0.5 * th), s * w0, s * w1, s * w2],
                    dtype=np.asarray(w).dtype)


def logmap(q: np.ndarray) -> np.ndarray:
    w = np.clip(q[0], -1.0, 1.0)
    vn = np.linalg.norm(q[1:])
    if vn < 1e-12:
        return 2.0 * q[1:] / max(w, 1e-12)
    th = 2.0 * np.arctan2(vn, w)
    return th * q[1:] / vn


def quat_normalize(q: np.ndarray) -> np.ndarray:
    # NOTE: keep this exact numpy formulation. A scalar-math variant
    # (math.sqrt of the sum of squares) differs in the last f32 bits
    # (~6e-8) from q/np.linalg.norm(q); on the f32 device pipeline that
    # perturbation in the written-back window states is enough to send
    # the rendered-sequence ATE from 0.084 to 8.7 (measured round 5) —
    # the sliding-window estimate is knife-edge sensitive to the host
    # renormalization matching the device's own float path.
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q
