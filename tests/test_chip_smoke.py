"""chip_smoke.py at tiny sizes on the CPU: every phase function, its float64
oracles against tests/oracles.py, and the refusal to run without a GPU.

The phases take their sizes as arguments; only ``main()`` insists on a GPU.
The map is a 50 m x 50 m tile of the bench city map at its full density, so
voxel counts and packed-block overflow are those of the real run.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke as cs
from oracles import (
    icp_stats_np,
    ndt_stats_np,
    pca_normal_np,
    plane_stats_np,
    voxel_map_np,
    vplane_stats_np,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tile():
    rng = np.random.RandomState(0)
    full = bench.make_city_map(rng, cs.N_MAP)
    x, y = full[:, 0], full[:, 1]
    map_np = full[(x > 60) & (x < 110) & (y > 60) & (y < 110)]
    scan_np = bench.make_scan(rng, map_np, len(map_np) // 12)
    return map_np, scan_np


@pytest.fixture(scope="module")
def small():
    """Small cloud + scan for the loop oracles of tests/oracles.py."""
    rng = np.random.RandomState(4)
    from oracles import make_scan, make_scene

    scene = make_scene(rng, n_floor=1500, n_wall=700)
    scan, _ = make_scan(rng, scene, np.array([0.05, -0.04, 0.1, 0.01, 0.0, -0.01]),
                        n_points=300)
    T = np.eye(4)
    T[:3, 3] = [0.01, -0.02, 0.03]
    return scene, scan, T


def test_phase_device_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()


def test_main_fails_without_gpu(capsys):
    old = jax.config.jax_compilation_cache_dir  # main() points the cache
    try:
        assert cs.main([]) != 0
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_script_alone_fails(tmp_path):
    """Without the rest of the repo the script exits nonzero, printing no
    result."""
    (tmp_path / "chip_smoke.py").write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize(
    "names",
    [("VPlaneICP",), ("NDT",), ("ICP",), ("PlaneICP",), ("VPlaneICP", "FastVPlaneICP")],
    ids=lambda n: "+".join(n),
)
def test_phase_solvers(tile, names, capsys):
    map_np, scan_np = tile
    Ts = cs.phase_solvers(map_np, scan_np, seed=0, n_sample=500, names=names)
    assert set(Ts) == set(names)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("phase ")]
    assert len(lines) == len(names)
    rec = json.loads(lines[-1].split(": ", 1)[1])
    assert rec["oracle_step_at_T"] < cs.STEP_TOL
    if "FastVPlaneICP" in names:
        assert rec["T_diff_vs_VPlaneICP"] <= cs.T_ATOL


def test_phase_solvers_fails_on_a_tight_bar(tile, monkeypatch):
    """A comparison that misses its bar raises; nothing carries on."""
    map_np, scan_np = tile
    monkeypatch.setattr(cs, "STATS_RTOL", 0.0)
    with pytest.raises(cs.SmokeFailure, match="rel err"):
        cs.phase_solvers(map_np, scan_np, seed=0, n_sample=500, names=("NDT",))


def test_phase_normals(tile):
    map_np, _ = tile
    rec = cs.phase_normals(map_np, seed=0, n_sample=2000)
    # both sides ran the same program on the same backend here
    assert rec["share"] == rec["cpu_share"]
    assert 0.5 < rec["share"] <= 1.0


def test_phase_voxel_filter(tile):
    map_np, _ = tile
    rec = cs.phase_voxel_filter(map_np)
    assert rec["cells"] == rec["ref_cells"]
    assert rec["max_abs_err"] <= cs.VF_ATOL


def test_phase_batched(tile):
    map_np, _ = tile
    rec = cs.phase_batched(map_np, seed=0, batch=2, n_points=2048)
    assert rec["converged"] == 2
    assert rec["T_diff_vs_single"] <= cs.T_ATOL


def test_phase_four_cards_on_virtual_devices(tile):
    """The --four-cards path on 4 virtual CPU devices: data-, batch- and
    map-sharded align against the single-device result."""
    map_np, scan_np = tile
    rec = cs.phase_four_cards(map_np, scan_np, seed=0, devices=jax.devices()[:4],
                              batch=4, n_points=2048)
    assert rec == {"devices": 4}


def test_check_spread_rejects_one_device():
    x = jax.device_put(np.zeros((8, 3), np.float32), jax.devices()[0])
    with pytest.raises(cs.SmokeFailure, match="expected one on each"):
        cs.check_spread("x", x, jax.devices()[:4])


# --- the vectorized float64 oracles against the loop oracles ---------------


@pytest.mark.parametrize("kind", ["vplane", "ndt"])
def test_voxel_oracle_stats_match_loop_oracle(small, kind):
    scene, scan, T = small
    ref = cs.voxel_oracle(scene, 1.0, min_points=10, with_icov=True)
    means, _, normals, icovs = voxel_map_np(scene, 1.0, min_points=10)
    H, g, e2 = cs.oracle_stats(kind, ref, scan, T)
    if kind == "vplane":
        H2, g2, e22, _ = vplane_stats_np(means, normals, scan, T, cs.MAX_DIST)
    else:
        H2, g2, e22, _ = ndt_stats_np(means, icovs, scan, T, cs.MAX_DIST)
    np.testing.assert_allclose(H, H2, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g, g2, rtol=1e-9, atol=1e-9)
    assert abs(e2 - e22) <= 1e-9 * max(e22, 1.0)


@pytest.mark.parametrize("kind", ["point", "plane"])
def test_point_oracle_stats_match_loop_oracle(small, kind):
    scene, scan, T = small
    normals = cs.pca_normals_np(scene, scene, 10)
    ref = cs.point_oracle(scene, normals, exact=True)
    H, g, e2 = cs.oracle_stats(kind, ref, scan, T)
    if kind == "point":
        H2, g2, e22, _ = icp_stats_np(scene, scan, T, cs.MAX_DIST)
    else:
        H2, g2, e22, _ = plane_stats_np(scene, normals, scan, T, cs.MAX_DIST)
    np.testing.assert_allclose(H, H2, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g, g2, rtol=1e-9, atol=1e-9)
    assert abs(e2 - e22) <= 1e-9 * max(e22, 1.0)


def test_pca_normals_match_loop_oracle(small):
    scene, _, _ = small
    from oracles import knn_np

    q = scene[:200]
    n = cs.pca_normals_np(scene, q, 12)
    _, idx = knn_np(scene, q, 12)
    n2 = np.stack([pca_normal_np(scene[i]) for i in idx])
    np.testing.assert_allclose(np.abs(np.sum(n * n2, axis=1)), 1.0, atol=1e-9)
