"""Single-transfer device→host fetches.

`jax.device_get` on a pytree issues one blocking copy PER LEAF, each
paying the transfer's fixed latency. `fetch_packed` flattens every leaf
into one 1-D device buffer with a tiny jitted concat (cached per
shape/dtype signature), pulls that single buffer, and unpacks on host —
one transfer per fetch regardless of leaf count.

Numerics: leaves are packed in the widest floating dtype present among
them (float64 with x64 enabled, float32 otherwise), so float leaves lose no
precision relative to a per-leaf fetch; bool/int leaves round-trip
exactly through the float encoding (ints up to the dtype's mantissa).
"""

from __future__ import annotations

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# All blocking device→host pulls of the pipeline serialize on this lock:
# the FetchWorker thread (deferred write-backs) and the main thread (the
# per-frame pack, PARSAC masks) never have two pulls in flight at once,
# so each pull's wall time in the XR_TRACE_FETCH trace is its own and
# the pulls form one ordered sequence. JAX transfers are thread-safe
# without it; this is ordering, not a guard. Any code that pulls from a
# helper thread while the pipeline runs (FetchWorker jobs, handle.get,
# packed fetches) holds it. Uploads (device_put) stay unlocked.
TRANSFER_LOCK = threading.RLock()

# Optional transfer-event trace (XR_TRACE_FETCH=1): (label, t_start,
# t_end) wall-clock tuples for every blocking pull, to see how
# transfers overlap host work. Read/reset via trace_events.
TRACE = []
_TRACE_ON = None


def _trace_on() -> bool:
    global _TRACE_ON
    if _TRACE_ON is None:
        import os

        _TRACE_ON = os.environ.get("XR_TRACE_FETCH", "0") != "0"
    return _TRACE_ON


def trace_mark(label: str) -> None:
    if _trace_on():
        import time as _t

        now = _t.perf_counter()
        TRACE.append((label, now, now))


def trace_events(reset: bool = False):
    ev = list(TRACE)
    if reset:
        TRACE.clear()
    return ev


def _traced(label: str, fn):
    if not _trace_on():
        return fn()
    import time as _t

    t0 = _t.perf_counter()
    try:
        return fn()
    finally:
        TRACE.append((label, t0, _t.perf_counter()))


def locked_asarray(x, label: str = "asarray") -> np.ndarray:
    """np.asarray(device_array) under TRANSFER_LOCK — the safe way to
    pull from a helper thread."""
    with TRANSFER_LOCK:
        return _traced(label, lambda: np.asarray(x))


@partial(jax.jit, static_argnames=("dtype",))
def _pack(leaves, dtype):
    """Flatten + concat, prefixed by ONE overflow flag: int leaves whose
    values exceed the float mantissa would be silently rounded by the
    cast, so the device computes the check and ships it in the same
    buffer (no extra round trip); fetch_packed raises on it."""
    mant = jnp.finfo(dtype).nmant + 1  # 24 (f32) / 53 (f64)
    limit = float(2 ** mant)
    flags = [jnp.any(jnp.abs(x) >= limit) for x in leaves
             if jnp.issubdtype(x.dtype, jnp.integer)
             and jnp.iinfo(x.dtype).bits > mant]
    ovf = jnp.any(jnp.stack(flags)) if flags else jnp.zeros((), bool)
    return jnp.concatenate([ovf.astype(dtype)[None]]
                           + [jnp.ravel(x).astype(dtype) for x in leaves])


@partial(jax.jit, static_argnames=("sig",))
def _unpack(buf, sig):
    out = []
    off = 0
    for shape, dt in sig:
        n = 1
        for s in shape:
            n *= s
        x = jax.lax.slice(buf, (off,), (off + n,)).reshape(shape)
        out.append(x.astype(dt) if dt != str(buf.dtype) else x)
        off += n
    return tuple(out)


def put_packed(arrays):
    """Host→device transfer of a tuple of numpy arrays as ONE buffer.

    The dual of fetch_packed: each jnp.asarray/device_put is a separate
    transfer with its own fixed cost, and a window extraction makes ~25
    of them. Packs everything into one flat buffer (widest float dtype present,
    ints/bools encoded exactly up to the mantissa), one device_put, and
    a cached jitted unpack (slices + casts fuse into the consumer).

    Returns a tuple of device arrays mirroring the input shapes/dtypes.
    """
    arrays = [np.asarray(a) for a in arrays]
    widest = np.float32
    for a in arrays:
        if a.dtype == np.float64:
            widest = np.float64
            break
    # int leaves ride the float encoding; values beyond the mantissa
    # would be silently rounded by the cast — fail loudly instead
    # (values are known host-side here, so the check is cheap)
    mant = np.finfo(widest).nmant + 1  # 24 (f32) / 53 (f64)
    for a in arrays:
        if np.issubdtype(a.dtype, np.integer) and a.size \
                and int(np.abs(a).max()) >= (1 << mant):
            raise ValueError(
                f"put_packed: int leaf max |{int(np.abs(a).max())}| "
                f"exceeds the {np.dtype(widest).name} mantissa "
                f"(2^{mant}) — transfer it separately")
    flat = np.concatenate([np.ravel(a).astype(widest) for a in arrays]) \
        if arrays else np.zeros((0,), widest)
    dev = _traced(f"put:{flat.size}", lambda: jnp.asarray(flat))
    sig = tuple((a.shape, ("bool" if a.dtype == np.bool_
                           else str(a.dtype))) for a in arrays)
    return _unpack(dev, sig)


class _FetchHandle:
    """An in-flight packed device→host fetch (fetch_packed_start)."""

    def __init__(self, leaves, treedef, dev_idx, widest, flat,
                 label="fetch"):
        self._label = label
        self._leaves = leaves
        self._treedef = treedef
        self._dev_idx = dev_idx
        self._widest = widest
        self._flat = flat
        self._buf = None  # host copy once completed (ride_along)
        # optional threading.Event: a puller thread completing this
        # handle (complete_with) sets it; get() blocks on it first, so
        # a consumer on another thread never double-transfers the buffer
        self._event = None

    @property
    def flat(self):
        """The single packed device buffer (ride it along another
        fetch: include it as a leaf there, then complete_with)."""
        return self._flat

    def complete_with(self, buf: np.ndarray) -> None:
        """Complete this fetch from an externally transferred host copy
        of `flat` — lets a different fetch_packed call carry this
        handle's buffer in ITS single transfer (one blocking sync
        instead of two)."""
        self._buf = np.asarray(buf)

    def get(self):
        if self._event is not None:
            self._event.wait()
        leaves, dev_idx, widest = self._leaves, self._dev_idx, self._widest
        if self._flat is None:
            with TRANSFER_LOCK:
                return _traced(self._label, lambda: jax.tree.unflatten(
                    self._treedef, [np.asarray(x) for x in leaves]))
        # completes the copy (already on host if ridden along another
        # fetch via complete_with)
        buf = self._buf if self._buf is not None \
            else locked_asarray(self._flat, self._label)
        if buf[0] != 0:
            raise ValueError(
                "fetch_packed: an int leaf holds values beyond the "
                f"{np.dtype(widest).name} mantissa and would be rounded — "
                "fetch it separately")
        out = list(leaves)
        off = 1  # skip the overflow flag
        for i in dev_idx:
            x = leaves[i]
            n = x.size
            piece = buf[off:off + n].reshape(x.shape)
            off += n
            if x.dtype == jnp.bool_:
                piece = piece > 0.5
            elif jnp.issubdtype(x.dtype, jnp.integer):
                piece = np.rint(piece).astype(np.dtype(x.dtype.name))
            else:
                piece = piece.astype(np.dtype(x.dtype.name))
            out[i] = piece
        return jax.tree.unflatten(self._treedef,
                                  [np.asarray(x) for x in out])


def fetch_packed_start(tree, async_copy: bool = True,
                       label: str = "fetch") -> _FetchHandle:
    """Begin a packed device→host fetch WITHOUT blocking: the single
    flat buffer's copy is kicked off (copy_to_host_async) so it
    overlaps host work; handle.get() completes it — starting the copy
    at dispatch time makes the later get() (next frame's materialize)
    nearly free.

    async_copy=False skips the early copy, for a caller that will
    .get() immediately."""
    leaves, treedef = jax.tree.flatten(tree)
    dev_idx = [i for i, x in enumerate(leaves)
               if isinstance(x, jax.Array) and x.size > 0]
    if not leaves or not dev_idx:
        return _FetchHandle(leaves, treedef, [], jnp.float32, None,
                            label=label)
    dev = [leaves[i] for i in dev_idx]
    widest = jnp.float32
    for x in dev:
        if x.dtype == jnp.float64:
            widest = jnp.float64
            break
    flat = _pack(tuple(dev), widest)
    if async_copy:
        try:
            flat.copy_to_host_async()
        except Exception:  # pragma: no cover - backends w/o async copy
            pass
    return _FetchHandle(leaves, treedef, dev_idx, widest, flat,
                        label=label)


def fetch_packed(tree):
    """Like jax.device_get(tree), but one device→host transfer total."""
    return fetch_packed_start(tree, async_copy=False).get()


class FetchWorker:
    """A single daemon thread draining FIFO transfer jobs.

    Device→host pulls block with the GIL released; routing them through
    one ordered worker lets the pipeline overlap pulls with host compute
    while keeping transfers in submission order. Jobs must catch their
    own exceptions and signal their own completion events."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue()
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="xrslam-fetch-worker")
        self._th.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            job()

    def submit(self, job) -> None:
        self._q.put(job)

    def close(self) -> None:
        self._q.put(None)
