"""Component ablation of the fused app step at the deployment profile.

Times the fused step (bf16 + fft heatmap + iterations=2) with components
toggled off to locate where its per-block time goes:

    all        heatmap + tracker + miso (the deployment step)
    no_mimo    tracker + miso only
    mimo_only  heatmap only
    trk_only   tracker only (no miso -> unfused swarm impl)

Methodology: bench-style scan differencing (see bench.py).
Run: PYTHONUNBUFFERED=1 python scripts/profile_fused.py
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from beamforming_lk_tpu.app import awpu_init, make_awpu_step  # noqa: E402
from beamforming_lk_tpu.config import (  # noqa: E402
    Config,
    DspConfig,
    MimoConfig,
    TrackerConfig,
)
from beamforming_lk_tpu.ops import antenna as ant  # noqa: E402

BLOCK = 256
N_SMALL, N_LARGE = 8, 2056  # differenced span must dwarf dispatch jitter


def timed(scan_step, state, blocks_small, blocks_large):
    _, out = scan_step(state, blocks_small)
    np.asarray(out.prev_max)
    _, out = scan_step(state, blocks_large)
    np.asarray(out.prev_max)

    def run(blocks):
        t0 = time.perf_counter()
        _, out = scan_step(state, blocks)
        np.asarray(out.prev_max)
        return time.perf_counter() - t0

    t_s = min(run(blocks_small) for _ in range(3))
    t_l = min(run(blocks_large) for _ in range(3))
    return (N_LARGE - N_SMALL) / max(t_l - t_s, 1e-9)


def main():
    cfg = Config(
        dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
        mimo=MimoConfig(backend="fft"),
        tracker=TrackerConfig(iterations=2),
    )
    points = ant.create_antenna_grid(8, 8, 0.02)
    c = points.shape[1]
    rng = np.random.default_rng(0)
    pool = jnp.asarray(rng.standard_normal((8, c, BLOCK)), jnp.float32)
    bs = jnp.tile(pool, (N_SMALL // 8, 1, 1))
    bl = jnp.tile(pool, (N_LARGE // 8, 1, 1))
    print(f"# device={jax.devices()[0].device_kind}", file=sys.stderr)

    combos = {
        "all": dict(),
        "no_mimo": dict(enable_mimo=False),
        "mimo_only": dict(enable_tracker=False, enable_miso=False),
        "trk_only": dict(enable_mimo=False, enable_miso=False),
        "miso_only": dict(enable_mimo=False, enable_tracker=False),
    }
    for name, kw in combos.items():
        step = make_awpu_step(points, cfg, **kw)
        state = awpu_init(cfg, c, seed=0)
        rate = timed(step.scan, state, bs, bl)
        print(f"fused[{name}]: {rate:.1f} blocks/s "
              f"({1e6 / rate:.0f} us/block)")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
