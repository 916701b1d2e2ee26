"""Ablation profile of the monopulse chain (models/tracker.py) on the device.

The fused app step is dominated by the sequential swarm chain —
``iterations x tracker_steps`` dependent monopulse dispatches.  This times
K chained rounds of each prefix of one round's work to find the per-round
cost split:

    w0  window slice + unfold only (hoisted per block, NOT per round)
    w1  + probe directions (quadrant trig + normalize)
    w2  + steering delays (rotate points, min-subtract)
    w3  + stencil weights build (one-hot interp weights)
    w4  + beam matmul + bandpass power (the full monopulse compute)
    w5  full _monopulse_step (adds the masked state update)

Each stage's output feeds the next round's particle state (theta shifted by
a tiny data-dependent amount) so XLA cannot parallelize or dead-code rounds.

Run:  PYTHONUNBUFFERED=1 python scripts/profile_tracker.py [n_particles]
"""

from __future__ import annotations

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, TrackerConfig
from beamforming_lk_tpu.models import tracker as tk
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops.geometry import normalize_spherical, quadrant_probes

BLOCK, SHIFT = 256, 64
ROUNDS = 10  # iterations=2 x tracker_steps=5, the deployment chain length


def timed_per_round(fn, *args, rounds=ROUNDS, reps=50):
    """us per chained round via scan-length differencing.

    fn(*args, n) runs ``n * 4`` chained rounds inside one jitted scan; the
    short/long difference cancels dispatch+fetch latency (the chain itself
    is on-device sequential, the honest shape for this workload).
    """
    f1 = jax.jit(functools.partial(fn, n=rounds))        # rounds*4 rounds
    f2 = jax.jit(functools.partial(fn, n=rounds * 5))    # rounds*20 rounds
    np.asarray(f1(*args))
    np.asarray(f2(*args))

    def run(f):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = f(*args)
        np.asarray(r)
        return time.perf_counter() - t0

    t1 = min(run(f1) for _ in range(2))
    t2 = min(run(f2) for _ in range(2))
    return (t2 - t1) / (reps * rounds * 16) * 1e6


def main():
    p = int(sys.argv[1]) if len(sys.argv) > 1 else 27  # 10 trackers+16 seekers+miso
    cfg = TrackerConfig()
    dsp = DspConfig(block_size=BLOCK, shift_range=SHIFT, probe_compute="bfloat16")
    arr = ArrayConfig()
    points = jnp.asarray(ant.create_antenna_grid(8, 8, 0.02))
    span = dl.probe_span(np.asarray(points), arr.samples_per_meter, 2, SHIFT)
    rng = np.random.default_rng(0)
    window = jnp.asarray(
        rng.standard_normal((64, SHIFT + BLOCK)), jnp.float32
    )
    pw = window[..., SHIFT - span:]
    unf = dl.unfold_window(pw, span, pw.shape[-1] - span).astype(jnp.bfloat16)
    theta0 = jnp.asarray(rng.uniform(0.05, 1.0, (p,)), jnp.float32)
    phi0 = jnp.asarray(rng.uniform(0.0, 6.2, (p,)), jnp.float32)
    spread = cfg.tracker_spread
    rate = cfg.tracker_step_gain * spread
    spm = arr.samples_per_meter

    # Chained stages: each returns a scalar-ish perturbation folded into
    # theta for the next round.
    def chain(body, theta, phi, n):
        def f(carry, _):
            th, ph = carry
            d = body(th, ph)
            return (th + 1e-6 * d, ph + 1e-6 * d), None

        (th, ph), _ = jax.lax.scan(f, (theta, phi), None, length=n * 4)
        return th

    def w0(th, ph):
        return jnp.sum(unf[0, 0, :8].astype(jnp.float32)) * 0 + jnp.sum(th) * 0

    def w1(th, ph):
        pt, pp, _ = quadrant_probes(th, ph, spread)
        pt, pp = normalize_spherical(pt, pp, cfg.theta_limit)
        return jnp.sum(pt) + jnp.sum(pp)

    def w2(th, ph):
        pt, pp, _ = quadrant_probes(th, ph, spread)
        pt, pp = normalize_spherical(pt, pp, cfg.theta_limit)
        delays = ant.steering_delays(points, pt, pp, spm)
        return jnp.sum(delays) * 1e-3

    def w3(th, ph):
        pt, pp, _ = quadrant_probes(th, ph, spread)
        pt, pp = normalize_spherical(pt, pp, cfg.theta_limit)
        delays = ant.steering_delays(points, pt, pp, spm)
        w = dl.das_weights(delays, span, "linear")
        return jnp.sum(w) * 1e-3

    def w4(th, ph):
        pt, pp, _ = quadrant_probes(th, ph, spread)
        pt, pp = normalize_spherical(pt, pp, cfg.theta_limit)
        delays = ant.steering_delays(points, pt, pp, spm)
        w = dl.das_weights(delays, span, "linear")
        beams = dl.das_beam_unfolded(unf, w.astype(unf.dtype))
        powers = dl.das_power(beams, use_bandpass=True, divisor=BLOCK)
        return jnp.sum(powers)

    mono = functools.partial(
        tk._monopulse_step,
        window=None,
        points=points,
        channel_mask=None,
        rate=rate,
        spread=spread,
        theta_limit=cfg.theta_limit,
        shift_range=SHIFT,
        mode="linear",
        fir_bank=None,
        samples_per_meter=spm,
        unfolded=unf,
    )
    active = jnp.ones((p,), bool)

    def w5_chain(theta, phi, n):
        parts = tk.Particles(theta, phi, theta * 0, theta * 0, theta * 0, theta * 0)

        def f(carry, _):
            pr = mono(carry, active)
            return pr, None

        pr, _ = jax.lax.scan(f, parts, None, length=n * 4)
        return pr.theta

    stages = {
        "w0_unfold_only": functools.partial(chain, w0, theta0, phi0),
        "w1_probes": functools.partial(chain, w1, theta0, phi0),
        "w2_delays": functools.partial(chain, w2, theta0, phi0),
        "w3_weights": functools.partial(chain, w3, theta0, phi0),
        "w4_beam_power": functools.partial(chain, w4, theta0, phi0),
        "w5_full_step": functools.partial(w5_chain, theta0, phi0),
    }
    print(f"particles={p} span={span} chain_rounds={ROUNDS}x4", flush=True)
    for name, fn in stages.items():
        us = timed_per_round(fn)
        print(f"{name}: {us:8.2f} us/round", flush=True)


if __name__ == "__main__":
    main()
