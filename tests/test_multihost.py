"""Multi-host correctness: 2 jax.distributed processes x 4 CPU devices.

SURVEY §4 mandates multi-host tests under ``jax.distributed`` with CPU
simulation. Two coordinated processes build a global 8-device mesh, run
``align_sharded`` on globally-sharded inputs, and the result must equal the
single-process 8-device run bit-for-near (the per-iteration psum is the only
cross-host traffic, SURVEY §2.3).

The workers run this same file in WORKER mode via subprocess so no real pod
is needed; the ``parallel.distributed.initialize`` wrapper's explicit-args
path is exercised for real (VERDICT round-1 item 4).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORKER_ENV = "PCR_MULTIHOST_WORKER"


def _scene():
    rng = np.random.RandomState(5)
    centers = rng.rand(50, 3) * 15
    pts = (centers[:, None, :] + rng.randn(50, 60, 3) * 0.4).reshape(-1, 3)
    pts = pts.astype(np.float32)
    scan = pts[rng.choice(len(pts), 1024, replace=False)] + np.float32(
        [0.04, -0.02, 0.06]
    )
    return pts, scan


def worker_main():
    cfgs = json.loads(os.environ[WORKER_ENV])
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from point_cloud_registration_tpu.core.config import VPlaneICPConfig
    from point_cloud_registration_tpu.models.voxelized_plane_icp import (
        build_vplane_target,
    )
    from point_cloud_registration_tpu.parallel import distributed
    from point_cloud_registration_tpu.parallel.sharded import align_sharded

    distributed.initialize(
        coordinator_address=f"localhost:{cfgs['port']}",
        num_processes=cfgs["num_processes"],
        process_id=cfgs["process_id"],
    )
    assert jax.process_count() == cfgs["num_processes"]
    assert jax.device_count() == 8, jax.devices()

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))
    pts, scan = _scene()
    cfg = VPlaneICPConfig(voxel_size=1.0, min_points=5)
    target = build_vplane_target(pts, cfg)
    # replicate the map pytree globally; shard the scan over "data"
    rep = NamedSharding(mesh, P())
    target_g = jax.tree.map(
        lambda x: jax.device_put(np.asarray(jax.device_get(x)), rep), target
    )
    src = jax.device_put(scan, NamedSharding(mesh, P("data")))
    w = jax.device_put(
        np.ones((len(scan),), np.float32), NamedSharding(mesh, P("data"))
    )
    T0 = jax.device_put(np.eye(4, dtype=np.float32), rep)
    res = align_sharded("vplane_icp", target_g, src, w, T0, cfg, mesh)
    T = np.asarray(jax.device_get(res.T))
    iters = int(np.asarray(jax.device_get(res.diagnostics.iterations)))
    if cfgs["process_id"] == 0:
        print("RESULT " + json.dumps({"T": T.tolist(), "iters": iters}), flush=True)


def test_two_process_align_matches_single_process():
    port = socket.socket().getsockname()  # placeholder
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env[WORKER_ENV] = json.dumps(
            {"port": port, "num_processes": 2, "process_id": pid}
        )
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        # the worker runs this file as a script (sys.path[0] = tests/), so
        # the package root must ride PYTHONPATH explicitly — inheriting the
        # parent's PYTHONPATH only works when pytest itself was launched
        # with the repo root on it
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    result = None
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
    assert result is not None, outs[0]
    T_multi = np.asarray(result["T"])

    # single-process 8-device reference (this pytest process)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from point_cloud_registration_tpu.core.config import VPlaneICPConfig
    from point_cloud_registration_tpu.models.voxelized_plane_icp import (
        build_vplane_target,
    )
    from point_cloud_registration_tpu.parallel.sharded import align_sharded

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))
    pts, scan = _scene()
    cfg = VPlaneICPConfig(voxel_size=1.0, min_points=5)
    target = build_vplane_target(pts, cfg)
    res = align_sharded(
        "vplane_icp",
        target,
        jnp.asarray(scan),
        jnp.ones((len(scan),), jnp.float32),
        jnp.eye(4, dtype=jnp.float32),
        cfg,
        mesh,
    )
    T_single = np.asarray(jax.device_get(res.T))
    np.testing.assert_allclose(T_multi, T_single, atol=1e-5)
    assert result["iters"] == int(np.asarray(res.diagnostics.iterations))


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    worker_main()
