"""App-path chunked replay throughput: the bench.py chunked-streaming rate
reached THROUGH the application layer.

bench.py measures the chunked heatmap program in isolation;
``--heatmap-chunk`` + ``ControlUnit.run(batch=N)`` expose the same program
from the CLI.  This benchmark drives that exact app path —
``ControlUnit.process_batch`` → ``AwpuPipeline.process_blocks`` →
the chunked scan program — at the north-star workload (256 mics × 65×65
directions, bf16 fft backend, chunk 8) and reports blocks/s.

Methodology: a 64-block pool is staged on device ONCE, then tiled
on-device to two batch sizes, so repeated ``process_batch`` calls measure
the app dispatch path rather than host→device bandwidth.  Like bench.py,
the rate is computed by DIFFERENCING the two batch lengths — each
``process_batch`` call pays one fixed host sync, and the difference
cancels it, leaving the app path's amortized per-block cost.  The raw
single-call rate (sync included) is also reported for the conservative
"what one call sees" number.

Prints one JSON line {cli_replay_blocks_per_s, realtime_x, ...} to stdout.
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
from beamforming_lk_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
from beamforming_lk_tpu.config import (  # noqa: E402
    Config,
    DspConfig,
    MimoConfig,
)

SAMPLE_RATE = 48828.0
BLOCK = 256
CHANNELS = 256
GRID = 65
CHUNK = 8
POOL = 64
TILE = int(os.environ.get("CLI_REPLAY_TILE", "16"))  # blocks = POOL * TILE


def main():
    signal.signal(
        signal.SIGALRM,
        lambda *_: (print("# DEADLINE", file=sys.stderr), os._exit(1)),
    )
    signal.alarm(int(os.environ.get("BENCH_DEADLINE_S", "2400")))
    use_compile_cache()

    cfg = Config(
        dsp=DspConfig(compute="bfloat16"),
        mimo=MimoConfig(rows=GRID, columns=GRID, backend="fft",
                        heatmap_chunk=CHUNK),
    )
    unit = ControlUnit(
        cfg, enable_tracker=False, enable_miso=False, channels=CHANNELS,
    )
    rng = np.random.default_rng(0)
    pool = jax.device_put(
        jnp.asarray(rng.standard_normal((POOL, CHANNELS, BLOCK)), jnp.float32)
    )
    tile_small = max(1, TILE // 4)
    blocks_small = jax.jit(lambda p: jnp.tile(p, (tile_small, 1, 1)))(pool)
    blocks_large = jax.jit(lambda p: jnp.tile(p, (TILE, 1, 1)))(pool)
    n_small, n_large = POOL * tile_small, POOL * TILE
    print(f"# device={jax.devices()[0].device_kind} n={n_small}/{n_large} "
          f"chunk={CHUNK} compiling...", file=sys.stderr, flush=True)
    unit.process_batch([blocks_small])  # compile + warm both lengths
    unit.process_batch([blocks_large])

    def run(blocks):
        t0 = time.perf_counter()
        unit.process_batch([blocks])
        return time.perf_counter() - t0

    t_small = min(run(blocks_small) for _ in range(3))
    t_large = min(run(blocks_large) for _ in range(3))
    # Amortized app-path rate: differencing cancels the fixed per-call
    # sync, same methodology as bench.py.
    amortized = (n_large - n_small) / max(t_large - t_small, 1e-9)
    # Conservative: one whole call, sync included.
    raw = n_large / t_large
    s = unit.metrics.summary()
    print(
        f"# app-path chunked replay: amortized {amortized:.0f} blocks/s, "
        f"single-call {raw:.0f} blocks/s (metrics realtime_factor over all "
        f"calls {s['realtime_factor']:.1f}x)",
        file=sys.stderr,
    )
    signal.alarm(0)
    print(json.dumps({
        "cli_replay_blocks_per_s": round(amortized, 1),
        "realtime_x": round(amortized * BLOCK / SAMPLE_RATE, 1),
        "single_call_blocks_per_s": round(raw, 1),
        "single_call_realtime_x": round(raw * BLOCK / SAMPLE_RATE, 1),
    }))


if __name__ == "__main__":
    main()
