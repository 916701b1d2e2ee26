"""Tracking-quality benchmark: angular accuracy + convergence time.

The reference has no quantitative tracker evaluation (its validation is
visual, SURVEY §4); this measures what matters on a synthetic ground-truth
scenario: convergence time (blocks until a tracker is within `lock_deg`),
steady-state angular RMSE, and track continuity for a moving source.

Runs anywhere (CPU-friendly):  python benchmarks/tracking_accuracy.py
"""

from __future__ import annotations

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from beamforming_lk_tpu.app import AwpuPipeline
from beamforming_lk_tpu.config import Config, MimoConfig, TrackerConfig
from beamforming_lk_tpu.io.synthetic import plane_wave_block
from beamforming_lk_tpu.ops.geometry import spherical_angle


def run_scenario(
    n_blocks: int = 96,
    lock_deg: float = 3.0,
    noise_std: float = 0.05,
    motion_deg_per_s: float = 10.0,
    seed: int = 0,
    probe_compute: str = "float32",
    interp: str = "linear",
    probe_layout: str = "quadrant",
):
    from beamforming_lk_tpu.config import DspConfig

    cfg = Config(
        dsp=DspConfig(probe_compute=probe_compute, interp=interp),
        mimo=MimoConfig(rows=8, columns=8),
        tracker=TrackerConfig(iterations=4, probe_layout=probe_layout),
    )
    pipe = AwpuPipeline(cfg, seed=seed, enable_mimo=False, enable_miso=False)
    dt = cfg.dsp.block_seconds
    rate = math.radians(motion_deg_per_s)

    lock_block = None
    errors = []
    tracked_blocks = 0
    for b in range(n_blocks):
        t = b * dt
        theta = 0.45 + 0.05 * math.sin(2 * math.pi * 0.5 * t)
        phi = 1.0 + rate * t
        block = plane_wave_block(
            pipe.points, [(theta, phi, 5000.0)], b * cfg.dsp.block_size,
            cfg.dsp.block_size, cfg.array, noise_std=noise_std,
        )
        pipe.process_block(block)
        tgts = pipe.targets()
        if not tgts:
            continue
        err = min(
            float(spherical_angle(tg["theta"], tg["phi"], theta, phi))
            for tg in tgts
        )
        if math.degrees(err) < lock_deg:
            if lock_block is None:
                lock_block = b
            tracked_blocks += 1
            errors.append(math.degrees(err))
    steady = errors[len(errors) // 2 :]
    return {
        "blocks": n_blocks,
        "lock_block": lock_block,
        "lock_time_ms": None if lock_block is None else round(lock_block * dt * 1e3, 1),
        "tracked_fraction": round(tracked_blocks / n_blocks, 3),
        "steady_rmse_deg": round(float(np.sqrt(np.mean(np.square(steady)))), 3)
        if steady else None,
        "steady_p95_deg": round(float(np.percentile(steady, 95)), 3) if steady else None,
    }


def run_multi_scenario(
    n_sources: int = 3,
    n_blocks: int = 160,
    lock_deg: float = 4.0,
    noise_std: float = 0.05,
    motion_deg_per_s: float = 8.0,
    seed: int = 0,
    probe_compute: str = "float32",
):
    """Simultaneous moving sources: per-source continuity/RMSE + merges.

    The reference runs up to 10 concurrent trackers
    (gradient_ascend.h:22-35) but never measures them; this pins the
    swarm's multi-target behavior: each source's lock/continuity/RMSE,
    how many distinct trackers stay up, and how often two sources
    collapse onto one tracker (`merged_blocks` — the closeness merge
    keeps ONE tracker when sources come within tracker_closeness).
    """
    from beamforming_lk_tpu.config import DspConfig

    cfg = Config(
        dsp=DspConfig(probe_compute=probe_compute),
        mimo=MimoConfig(rows=8, columns=8),
        tracker=TrackerConfig(iterations=4),
    )
    pipe = AwpuPipeline(cfg, seed=seed, enable_mimo=False, enable_miso=False)
    dt = cfg.dsp.block_seconds
    rate = math.radians(motion_deg_per_s)

    # Well-separated starts spread in azimuth, distinct elevations and
    # motion phases so paths cross in azimuth but not exactly in angle.
    base = [
        (0.40, 0.6, 5000.0),
        (0.55, 2.7, 4200.0),
        (0.30, 4.4, 6100.0),
    ][:n_sources]

    lock_block = [None] * n_sources
    errors = [[] for _ in range(n_sources)]
    tracked = [0] * n_sources
    merged_blocks = 0
    n_valid_hist = []
    for b in range(n_blocks):
        t = b * dt
        srcs = [
            (
                th0 + 0.04 * math.sin(2 * math.pi * 0.4 * t + k),
                ph0 + rate * t * (1 if k % 2 == 0 else -1),
                f,
            )
            for k, (th0, ph0, f) in enumerate(base)
        ]
        block = plane_wave_block(
            pipe.points, srcs, b * cfg.dsp.block_size,
            cfg.dsp.block_size, cfg.array, noise_std=noise_std,
        )
        pipe.process_block(block)
        tgts = pipe.targets()
        n_valid_hist.append(len(tgts))
        if not tgts:
            continue
        assignment = []
        for k, (th, ph, _f) in enumerate(srcs):
            errs = [
                float(spherical_angle(tg["theta"], tg["phi"], th, ph))
                for tg in tgts
            ]
            j = int(np.argmin(errs))
            err_deg = math.degrees(errs[j])
            if err_deg < lock_deg:
                assignment.append(j)
                if lock_block[k] is None:
                    lock_block[k] = b
                tracked[k] += 1
                errors[k].append(err_deg)
        if len(assignment) > len(set(assignment)):
            merged_blocks += 1

    def per_source(k):
        steady = errors[k][len(errors[k]) // 2 :]
        return {
            "lock_block": lock_block[k],
            "tracked_fraction": round(tracked[k] / n_blocks, 3),
            "steady_rmse_deg": round(
                float(np.sqrt(np.mean(np.square(steady)))), 3
            ) if steady else None,
        }

    return {
        "n_sources": n_sources,
        "blocks": n_blocks,
        "sources": [per_source(k) for k in range(n_sources)],
        "merged_blocks": merged_blocks,
        "mean_active_trackers": round(float(np.mean(n_valid_hist)), 2),
    }


if __name__ == "__main__":
    from beamforming_lk_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    for pc in ("float32", "bfloat16"):
        print(pc, json.dumps(run_scenario(probe_compute=pc), indent=2))
    for n in (2, 3):
        print(
            f"multi{n}",
            json.dumps(run_multi_scenario(n_sources=n), indent=2),
        )
