"""Benchmark: the full fused AWPU step on one chip.

Measures blocks/s of the flagship ``make_awpu_step`` program — MIMO 64x64
heatmap + 10-iteration gradient tracker swarm + MISO beam, 64 mics,
256-sample blocks — i.e. everything the reference's three worker threads do
per block (``src/dsp/mimo.cpp``, ``src/dsp/gradient_ascend.cpp``,
``src/dsp/miso.cpp``), as ONE device program.

Methodology matches bench.py: N blocks chained in one jitted ``lax.scan``
(``step.scan``), synced by host-fetching a small output, fixed overhead
removed by differencing two scan lengths.

Variants:
  f32        — full-precision parity path (heatmap + probes f32 HIGHEST)
  bf16_mimo  — bf16 heatmap contraction, f32 probes (old production config)
  bf16_all   — bf16 heatmap AND bf16 monopulse probe beams (f32 accumulate;
               tracker accuracy validated by tracking_accuracy.py)

All variants use the aperture-sized probe stencil (ops.delay.probe_span —
32 instead of 64 samples for the 8x8 array), which is exact.

Prints one line per variant to stdout; runs on JAX's default device.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from beamforming_lk_tpu.app import awpu_init, make_awpu_step  # noqa: E402
from beamforming_lk_tpu.config import (  # noqa: E402
    Config,
    DspConfig,
    MimoConfig,
    TrackerConfig,
)
from beamforming_lk_tpu.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

SAMPLE_RATE = 48828.0
BLOCK = 256
# The differenced span must dwarf the per-call dispatch jitter, so it is
# ~2k blocks (min-of-3).  Both counts are multiples of the pool tile 8.
N_SMALL = 24
N_LARGE = int(os.environ.get("FUSED_N_LARGE", "2064"))


def timed_rate(scan_step, state, blocks_small, blocks_large):
    _, out = scan_step(state, blocks_small)  # compile + warm
    np.asarray(out.prev_max)
    _, out = scan_step(state, blocks_large)  # compile the large length too
    np.asarray(out.prev_max)

    def run(blocks):
        t0 = time.perf_counter()
        _, out = scan_step(state, blocks)
        np.asarray(out.prev_max)
        return time.perf_counter() - t0

    t_small = min(run(blocks_small) for _ in range(3))
    t_large = min(run(blocks_large) for _ in range(3))
    dt = t_large - t_small
    if dt <= 0:  # dispatch jitter swamped the difference
        return float("nan")
    return (N_LARGE - N_SMALL) / dt


def main():
    signal.signal(
        signal.SIGALRM,
        lambda *_: (print("# DEADLINE", file=sys.stderr), os._exit(1)),
    )
    signal.alarm(int(os.environ.get("BENCH_DEADLINE_S", "2400")))
    use_compile_cache()

    base = Config()
    variants = {
        "f32": base,
        "bf16_mimo": dataclasses.replace(
            base, dsp=DspConfig(compute="bfloat16")
        ),
        "bf16_all": dataclasses.replace(
            base, dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16")
        ),
        # bf16 probes + separable frequency-domain heatmap (ops/fft_das.py)
        "bf16_fft": dataclasses.replace(
            base,
            dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
            mimo=MimoConfig(backend="fft"),
        ),
        # Real-time-faithful tracker cadence: the reference's update loop
        # runs only until the next block lands (~1-2 iterations at real
        # time, gradient_ascend.cpp:315); our default of 10 is a
        # deterministic superset.  iterations=2 is the deployment profile.
        "bf16_fft_iter2": dataclasses.replace(
            base,
            dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
            mimo=MimoConfig(backend="fft"),
            tracker=TrackerConfig(iterations=2),
        ),
        # + display-rate heatmap decimation: recompute the heatmap every
        # 3rd block (the reference UI consumes ~60 fps = every ~3rd block
        # at the 190.7 block/s cadence, aw_control_unit.cpp:189); tracker
        # and MISO still run every block.  This is Config.realtime().
        "bf16_fft_iter2_hm3": dataclasses.replace(
            base,
            dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
            mimo=MimoConfig(backend="fft", heatmap_every=3),
            tracker=TrackerConfig(iterations=2),
        ),
        # 8-tap polyphase FIR interpolation (quality variant) at the
        # deployment cadence — the cost of the higher-quality stencil.
        "bf16_fft_iter2_fir": dataclasses.replace(
            base,
            dsp=DspConfig(
                compute="bfloat16", probe_compute="bfloat16", interp="fir"
            ),
            mimo=MimoConfig(backend="fft"),
            tracker=TrackerConfig(iterations=2),
        ),
    }
    only = os.environ.get("BENCH_VARIANTS")
    if only:
        keep = only.split(",")
        variants = {k: v for k, v in variants.items() if k in keep}
    points = ant.create_antenna_grid(8, 8, 0.02)
    c = points.shape[1]
    rng = np.random.default_rng(0)
    pool = jnp.asarray(rng.standard_normal((8, c, BLOCK)), jnp.float32)
    blocks_small = jnp.tile(pool, (N_SMALL // 8, 1, 1))
    blocks_large = jnp.tile(pool, (N_LARGE // 8, 1, 1))
    print(f"# device={jax.devices()[0].device_kind}", file=sys.stderr)

    for name, cfg in variants.items():
        step = make_awpu_step(points, cfg)
        state = awpu_init(cfg, c, seed=0)
        rate = timed_rate(step.scan, state, blocks_small, blocks_large)
        print(
            f"fused_step {name}: {rate:.1f} blocks/s "
            f"realtime_x={rate * BLOCK / SAMPLE_RATE:.2f}"
        )
        sys.stdout.flush()

    signal.alarm(0)


if __name__ == "__main__":
    main()
