"""Device throughput of the adaptive estimators: MVDR (Capon) and MUSIC.

Both are capabilities beyond the reference (which is time-domain DAS only)
and both are complex-free device programs (re/im planes, 2x2 real
block embedding for the per-bin covariance EMA / Cholesky solve / eigh —
see models/mvdr.py, models/music.py).  This measures blocks/s at the
north-star spatial config (256 mics x 4225 directions, 256-sample blocks,
F = 11 STFT bins in the 550-9000 Hz band) with the same chained-scan,
scan-length-differencing methodology as bench.py.

The [2, F, D, C] steering planes are ~95 MB — built on the device from
the [D, C] delay table (4 MB).

Usage: python benchmarks/adaptive_estimators.py  (runs on JAX's default
device)
"""

from __future__ import annotations

import os
import signal
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from beamforming_lk_tpu.config import ArrayConfig, MimoConfig  # noqa: E402
from beamforming_lk_tpu.models import mimo as mm  # noqa: E402
from beamforming_lk_tpu.models import music as mu  # noqa: E402
from beamforming_lk_tpu.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

SAMPLE_RATE = 48828.0
BLOCK = 256
GRID = 65
FRAME, HOP = 64, 32


def build_model(channels: int = 256):
    """(state_init, impl operands, n_bins) with the steering planes built
    on device from the small delay table."""
    arr = ArrayConfig()
    if channels == 64:
        points = ant.create_antenna_grid(arr.columns, arr.rows, arr.distance)
    else:
        points = ant.multi_array_cluster(
            channels, arr.columns, arr.rows, arr.distance
        )  # 2x2 coherent cluster (bench.py geometry)
    theta, phi = mm.make_mimo_grid(MimoConfig(rows=GRID, columns=GRID))
    delays = ant.steering_delays_np(
        points, theta, phi, arr.samples_per_meter
    )  # [D, C], ~4 MB
    bins = mv.select_bins(FRAME, arr.sample_rate, 550.0, 9000.0)
    freqs = np.fft.rfftfreq(FRAME, 1.0 / arr.sample_rate)[bins]

    d_dev = jax.device_put(jnp.asarray(delays, jnp.float32))
    f_dev = jnp.asarray(freqs, jnp.float32)

    @jax.jit
    def build_v(dl, f):
        phase = 2.0 * jnp.pi * f[:, None, None] * dl[None] / SAMPLE_RATE
        return jnp.stack([jnp.cos(phase), jnp.sin(phase)])  # [2, F, D, C]

    v = build_v(d_dev, f_dev)
    dft_t = jax.device_put(jnp.asarray(mv.dft_tables(FRAME, bins)))
    c = points.shape[1]
    return v, dft_t, len(bins), c


def timed_rate(scan, state, blocks, n_small=8, target_dt=0.7):
    _, p = scan(state, blocks, n_small)
    np.asarray(p[-1][:4])  # compile + warm + fence

    def run(n):
        t0 = time.perf_counter()
        _, p = scan(state, blocks, n)
        np.asarray(p[-1][:4])
        return time.perf_counter() - t0

    t_small = min(run(n_small) for _ in range(2))
    n_large = 72
    t_large = min(run(n_large) for _ in range(2))
    dt = max(t_large - t_small, 1e-9)
    rate = (n_large - n_small) / dt
    if dt < target_dt / 2:  # grow span until jitter is negligible
        # Cap the grown span: a jittery timing pair can give dt ~ 0 and an
        # absurd provisional rate, which would otherwise overflow the scan
        # length.
        n_large = min(
            n_small + int(np.ceil(rate * target_dt / 8.0)) * 8, 40_000
        )
        t_large = min(run(n_large) for _ in range(3))
        dt = max(t_large - t_small, 1e-9)
        rate = (n_large - n_small) / dt
    return rate


def main():
    signal.signal(
        signal.SIGALRM,
        lambda *_: (print("# DEADLINE", file=sys.stderr), os._exit(1)),
    )
    signal.alarm(int(os.environ.get("BENCH_DEADLINE_S", "2400")))
    use_compile_cache()
    print(f"# device={jax.devices()[0].device_kind}", file=sys.stderr)

    # Two configs: the app/deployment aperture (one 64-mic array — what
    # `--mvdr` / `--music` run) and the 256-mic stretch cluster
    # (bench.py's north-star spatial config).
    for channels in (64, 256):
        v, dft_t, n_bins, c = build_model(channels)
        rng = np.random.default_rng(0)
        blocks = jax.device_put(
            jnp.asarray(rng.standard_normal((8, c, BLOCK)), jnp.float32)
        )

        binw = jnp.ones((n_bins,), jnp.float32)
        # refresh=1: the exact every-block solve; refresh=8: the decimated
        # deployment profile (covariance EMA every block, Capon solve every
        # 8th — the 256-mic Cholesky-wall breaker, models/mvdr.py).
        for refresh in (1, 8):
            mvdr_impl = mv._make_mvdr_impl(
                FRAME, HOP, None, 0.1, 1e-3, weight_refresh=refresh
            )
            mvdr_scan = mv._attach_scan(mvdr_impl, (v, dft_t, binw))
            state0 = mv.mvdr_init(
                n_bins, c, GRID * GRID if refresh > 1 else None
            )
            rate = timed_rate(mvdr_scan, state0, blocks)
            tag = "mvdr" if refresh == 1 else f"mvdr_r{refresh}"
            print(
                f"{tag}: {rate:.1f} blocks/s realtime_x="
                f"{rate * BLOCK / SAMPLE_RATE:.2f} "
                f"(C={c} D={GRID * GRID} F={n_bins})"
            )
            sys.stdout.flush()

        k = 3
        for solver in ("subspace", "eigh"):
            music_impl = mu._make_music_impl(
                FRAME, HOP, None, 0.1, c, k, solver
            )
            music_scan = mv._attach_scan(music_impl, (v, dft_t))
            rate = timed_rate(
                music_scan, mu.music_init(n_bins, c, k), blocks
            )
            print(
                f"music_{solver}: {rate:.1f} blocks/s realtime_x="
                f"{rate * BLOCK / SAMPLE_RATE:.2f} "
                f"(C={c} D={GRID * GRID} F={n_bins} K={k})"
            )
            sys.stdout.flush()
    signal.alarm(0)


if __name__ == "__main__":
    main()
