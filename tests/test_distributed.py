"""Multi-process distributed tests.

Exercises `parallel.mesh.initialize_distributed` the way a multi-host
deployment would use it: two OS processes rendezvous at a localhost
coordinator (`jax.distributed`, the multi-host layer of SURVEY.md
§2.3), build a global mesh spanning both processes' devices, and run a
psum-carrying shard_map across the process boundary. The reference has
no distributed backend at all; this is the scale-out layer's only
cross-process integration test (everything else uses the virtual
single-process 8-device mesh).

CPU cross-process collectives need jaxlib's gloo backend; the test
skips (not fails) where that is unavailable.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from xrslam_tpu.parallel.mesh import initialize_distributed

    coord, pid = sys.argv[1], int(sys.argv[2])
    initialize_distributed(coordinator=coord, num_processes=2, process_id=pid)
    if jax.process_count() != 2:
        print(json.dumps({"skip": "process_count=%d" % jax.process_count()}))
        sys.exit(0)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices())  # 4 global devices, 2 local
    mesh = Mesh(devs.reshape(4), ("x",))

    # each device contributes its shard's sum; psum must cross the
    # process boundary (devices 0,1 live in proc 0; 2,3 in proc 1)
    x = jnp.arange(8.0)

    def f(xs):
        return jax.lax.psum(jnp.sum(xs), "x")

    y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P()),
                in_shardings=NamedSharding(mesh, P("x")))(x)
    total = float(np.asarray(jax.device_get(y)))
    print(json.dumps({"pid": pid, "total": total,
                      "n_global": jax.device_count(),
                      "n_local": jax.local_device_count()}))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, str(script), coord, str(i)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed child timed out")
        outs.append((p.returncode, out, err))

    results = []
    for rc, out, err in outs:
        if rc != 0:
            if "gloo" in err.lower() or "collectives" in err.lower() \
                    or "UNIMPLEMENTED" in err \
                    or "must be called before" in err:
                pytest.skip(f"CPU cross-process collectives unavailable: "
                            f"{err[-300:]}")
            pytest.fail(f"child failed rc={rc}:\n{err[-2000:]}")
        last = out.strip().splitlines()[-1]
        r = json.loads(last)
        if "skip" in r:
            pytest.skip(f"jax.distributed did not form 2 processes: {r}")
        results.append(r)

    for r in results:
        assert r["n_global"] == 4 and r["n_local"] == 2
        assert r["total"] == pytest.approx(28.0)  # sum(range(8))
