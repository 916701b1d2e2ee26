"""Offline track-algorithm replay — the ``math_toolbox/track_algorithm.py``
equivalent.

Replays a recorded ray-pair log (the reference's ``Targets.txt`` format,
also written by ``TargetFusion(log_path=...)``: one
``o1,d1;o2,d2;timestamp`` line per compared pair with space-separated
vectors) through the triangulation + track store, and prints hit
statistics.  Usage::

    python tools/track_replay.py Targets.txt [--plot out.png]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from beamforming_lk_tpu.config import TriangulationConfig
from beamforming_lk_tpu.models.fusion import TrackStore, triangulate_rays


def parse_log(path: str):
    """Yield (o1, d1, o2, d2, t) per line; skips malformed lines."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(";")
            if len(parts) != 3:
                continue
            try:
                o1, d1 = (np.fromstring(v, sep=" ") for v in parts[0].split(","))
                o2, d2 = (np.fromstring(v, sep=" ") for v in parts[1].split(","))
                t = float(parts[2])
            except (ValueError, IndexError):
                continue
            if any(v.shape != (3,) for v in (o1, d1, o2, d2)):
                continue
            yield o1, d1, o2, d2, t


def replay(path: str, cfg: TriangulationConfig = TriangulationConfig()):
    store = TrackStore(cfg)
    rays = list(parse_log(path))
    if not rays:
        print("no valid ray pairs in log")
        return store, []
    o1 = np.stack([r[0] for r in rays])
    d1 = np.stack([r[1] for r in rays])
    o2 = np.stack([r[2] for r in rays])
    d2 = np.stack([r[3] for r in rays])
    ts = np.array([r[4] for r in rays])
    # Normalize timestamps (the reference logs epoch counts).
    ts = (ts - ts.min()) * (1e-9 if ts.max() - ts.min() > 1e6 else 1.0)
    pts, valid = triangulate_rays(o1, d1, o2, d2, cfg)
    pts = np.asarray(pts)
    valid = np.asarray(valid)
    hits = []
    for k in np.where(valid)[0]:
        store.add_target(pts[k], float(ts[k]))
        store.update(float(ts[k]))
        hits.append(pts[k])
    print(f"{len(rays)} ray pairs, {valid.sum()} valid intersections")
    print(f"{len(store.tracks)} tracks ({len(store.valid_tracks())} alive at end)")
    for i, tr in enumerate(store.tracks):
        print(
            f"  track {i}: pos={np.round(tr.position, 2)} hits={tr.hits} "
            f"valid={tr.valid}"
        )
    if store.best is not None:
        print(f"best: {np.round(store.best.position, 3)} ({store.best.hits} hits)")
    return store, hits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--plot", default=None, help="save a 3D scatter PNG")
    ap.add_argument("--distance-threshold", type=float, default=1.0)
    args = ap.parse_args(argv)
    cfg = TriangulationConfig(distance_threshold=args.distance_threshold)
    store, hits = replay(args.log, cfg)
    if args.plot and hits:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        h = np.stack(hits)
        ax.scatter(h[:, 0], h[:, 1], h[:, 2], s=4, alpha=0.4)
        for tr in store.valid_tracks():
            ax.scatter(*tr.position, marker="x", s=80)
        ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
        fig.savefig(args.plot, dpi=120)
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
