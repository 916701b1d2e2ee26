"""BASELINE config 3 on the device: 256 mics beamforming + gradient tracker
+ triangulation.

The reference's flagship demo deployment — 2 FPGAs concurrently beamforming
with target triangulation between them (/root/reference/README.md:10,
/root/reference/src/target_handler/target_handler.cpp:130-169) — mapped to
this framework: TWO 128-mic coherent clusters (2x1 of 8x8 arrays each,
256 mics total), each running the FULL fused deployment step (65x65 fft
bf16 heatmap at display-rate decimation + tracker + MISO), with the
host-side ``TargetFusion`` triangulation pass folding both
arrays' targets into world tracks every batch — driven through the real
application layer (``ControlUnit.process_batch``).

Methodology: like benchmarks/cli_replay.py — a 24-block pool staged on
device once, tiled on-device to two batch sizes, rate from DIFFERENCING
the two batch lengths (cancels the fixed per-call sync and fusion cost).
The two pipelines' batches dispatch back-to-back inside one
``process_batch`` call, and the fusion/triangulation pass runs on host
after each call (its cost is inside the measured time).

Prints one JSON line {config3_blocks_per_s, realtime_x, ...} to stdout.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from beamforming_lk_tpu.app.control import ControlUnit  # noqa: E402
from beamforming_lk_tpu.config import (  # noqa: E402
    Config,
    DspConfig,
    MimoConfig,
    TrackerConfig,
)
from beamforming_lk_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

SAMPLE_RATE = 48828.0
BLOCK = 256
CHANNELS_PER_ARRAY = 128          # 2 links x 128 mics = 256 beamformed mics
GRID = 65
POOL = 24
TILE = int(os.environ.get("CONFIG3_TILE", "32"))  # blocks = POOL * TILE


def main():
    signal.signal(
        signal.SIGALRM,
        lambda *_: (print("# DEADLINE", file=sys.stderr), os._exit(1)),
    )
    signal.alarm(int(os.environ.get("BENCH_DEADLINE_S", "2400")))

    use_compile_cache()
    cfg = Config(
        dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
        mimo=MimoConfig(rows=GRID, columns=GRID, backend="fft",
                        heatmap_every=3),
        tracker=TrackerConfig(iterations=2),
    )
    unit = ControlUnit(
        cfg, n_arrays=2, enable_tracker=True, enable_miso=True,
        channels=CHANNELS_PER_ARRAY,
    )
    assert unit.fusion is not None, "2-array fusion not active"
    rng = np.random.default_rng(0)
    pools = [
        jax.device_put(jnp.asarray(
            rng.standard_normal((POOL, CHANNELS_PER_ARRAY, BLOCK)),
            jnp.float32,
        ))
        for _ in range(2)
    ]
    tile_small = max(1, TILE // 4)
    tiler = jax.jit(jnp.tile, static_argnums=1)
    small = [tiler(p, (tile_small, 1, 1)) for p in pools]
    large = [tiler(p, (TILE, 1, 1)) for p in pools]
    n_small, n_large = POOL * tile_small, POOL * TILE
    print(
        f"# device={jax.devices()[0].device_kind} "
        f"2x{CHANNELS_PER_ARRAY} mics n={n_small}/{n_large} compiling...",
        file=sys.stderr, flush=True,
    )
    unit.process_batch(small)   # compile + warm both lengths
    unit.process_batch(large)

    def run(blocks, n):
        t0 = time.perf_counter()
        unit.process_batch(blocks, now=time.monotonic())
        return time.perf_counter() - t0

    # Each process_batch call pays per-call overhead (sync + the fusion
    # pass's stacked target fetches) whose run-to-run variance can rival
    # the device-time delta, so a single differenced pair is noisy:
    # measure several interleaved pairs and take the MEDIAN of the
    # positive per-pair rates (bench.py's median-of-repeats analog).
    rates = []
    t_large_best = float("inf")
    for _ in range(5):
        t_s = run(small, n_small)
        t_l = run(large, n_large)
        t_large_best = min(t_large_best, t_l)
        if t_l > t_s:
            rates.append((n_large - n_small) / (t_l - t_s))
    rates.sort()
    amortized = rates[len(rates) // 2] if rates else float("nan")
    raw = n_large / t_large_best
    print(f"# pair rates: {[round(r) for r in rates]}", file=sys.stderr)
    print(
        f"# config3 (2x{CHANNELS_PER_ARRAY} mics, fused step + fusion): "
        f"amortized {amortized:.0f} blocks/s, single-call {raw:.0f} blocks/s",
        file=sys.stderr,
    )
    signal.alarm(0)
    print(json.dumps({
        "config3_blocks_per_s": round(amortized, 1),
        "realtime_x": round(amortized * BLOCK / SAMPLE_RATE, 2),
        "single_call_blocks_per_s": round(raw, 1),
        "single_call_realtime_x": round(raw * BLOCK / SAMPLE_RATE, 2),
        "channels_total": 2 * CHANNELS_PER_ARRAY,
        "grid": GRID,
    }))


if __name__ == "__main__":
    main()
