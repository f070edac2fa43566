#!/usr/bin/env python3
"""Profile the VPlaneICP, ICP and normals phases on the GPU and list the top
device operations of each.

    python scripts/trace_phases.py [--out build/trace] [--seed 0]

Builds the B-01-protocol problem of ``chip_smoke.py`` (1.2M-point map,
100k-point scan), warms each phase, then traces ONE warm call of each in its
own ``jax.profiler`` window: VPlaneICP ``set_target`` + ``align``, ICP
``set_target`` + ``align`` and ``estimate_normals(map, k=15)``. For every
device plane of a window it prints, per trace line, the busy time (union of
event intervals), the window length and the top operations by summed device
time; the full reduction goes to ``<out>/summary.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(log_dir: str, top: int = 15) -> dict:
    """{device plane: {line: {busy_ns, span_ns, top: [[op, ns, count]]}}}."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb"))
    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {}
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            by_name = defaultdict(lambda: [0.0, 0])
            for e in events:
                by_name[e.name][0] += e.duration_ns
                by_name[e.name][1] += 1
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
            lines[line.name] = {
                "busy_ns": union_ns((e.start_ns, e.end_ns) for e in events),
                "span_ns": max(e.end_ns for e in events) - min(e.start_ns for e in events),
                "top": [[name, ns, n] for name, (ns, n) in ranked],
            }
        out[plane.name] = lines
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/trace")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from point_cloud_registration_tpu.utils.runtime import (
        card_name_and_power_limit,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    devices = require_gpu()
    import jax

    import chip_smoke
    import point_cloud_registration_tpu as pcr

    print(f"{devices[0].device_kind} x{len(devices)}; nvidia-smi: "
          f"{card_name_and_power_limit()}", flush=True)
    map_np, scan_np = chip_smoke.make_problem(args.seed)

    def solver_phase(name):
        def run():
            s = chip_smoke.make_solver(pcr, name)
            s.set_target(map_np)
            return s.align(scan_np)
        return run

    phases = {
        "vplane_icp": solver_phase("VPlaneICP"),
        "icp": solver_phase("ICP"),
        "normals": lambda: pcr.estimate_normals(map_np, k=chip_smoke.NORMALS_K),
    }
    summary = {}
    for name, fn in phases.items():
        fn()  # compile + warm
        log_dir = os.path.join(args.out, name)
        with jax.profiler.trace(log_dir):
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        red = reduce_trace(log_dir)
        summary[name] = {"wall_s": wall, "planes": red}
        print(f"== {name}: traced wall {wall:.4f} s", flush=True)
        for plane, lines in red.items():
            for line, r in lines.items():
                print(f"  {plane} | {line}: busy {r['busy_ns'] / 1e6:.3f} ms "
                      f"over {r['span_ns'] / 1e6:.3f} ms")
                for op, ns, n in r["top"][:10]:
                    print(f"      {ns / 1e6:9.3f} ms  x{n:<5d} {op[:110]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
