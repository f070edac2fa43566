"""Device-mesh helpers.

The reference is a single-process NumPy library with no distribution layer
(SURVEY §2.3); this framework's scaling axes are

* ``data`` — scan points sharded across devices; each Gauss-Newton iteration
  all-reduces only the (6x6 H, 6 g, e2, inlier-count) tuple (~40 floats), so
  data parallelism is near-embarrassingly parallel;
* ``batch`` — many (scan, init_T) problems against one replicated map, the
  SLAM front-end throughput axis (BASELINE.json configs[4]).

Maps are replicated here; maps larger than one device's memory are sharded
by voxel slab over a ``model`` axis (parallel/map_sharded.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    batch: int = 1,
    data: int | None = None,
    *,
    devices=None,
) -> Mesh:
    """Build a (batch, data) mesh over ``devices`` (default: all).

    ``data`` defaults to ``len(devices) // batch``. Devices are taken in
    ``jax.devices()`` order; the mesh follows the algorithm, not a physical
    topology. A 1-device mesh is valid (shard_map degenerates to the
    single-device program), so the same align code path runs everywhere.
    """
    if devices is None:
        devices = jax.devices()
    if data is None:
        data = len(devices) // batch
    n = batch * data
    if n > len(devices):
        raise ValueError(f"mesh {batch}x{data} needs {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(batch, data)
    return Mesh(dev_array, axis_names=("batch", "data"))
