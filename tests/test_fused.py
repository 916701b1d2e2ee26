"""Parity of the fused swarm+MISO monopulse chain with the unfused impls.

``make_fused_step_impl`` batches tracker sub-step, seeker, and MISO-refine
probe evaluations into shared DAS dispatches (extra matmul rows).  Per-row
matmul results are independent of the other rows in a batch, so every
particle's trajectory must match the unfused
``make_swarm_step_impl`` + ``make_miso_step_impl`` composition exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beamforming_lk_tpu.config import ArrayConfig, Config, DspConfig, TrackerConfig
from beamforming_lk_tpu.io import ring_init, ring_push, ring_window
from beamforming_lk_tpu.io.synthetic import synthetic_blocks
from beamforming_lk_tpu.models import miso as ms
from beamforming_lk_tpu.models import tracker as trk
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl

ACFG = ArrayConfig()
TCFG = TrackerConfig(
    n_seekers=8, n_trackers=4, iterations=4, fov_degrees=120.0,
    seeker_reset_interval=64,
)
SOURCES = [(math.radians(25.0), math.radians(60.0), 5000.0)]


def _tree_allclose(a, b, **kw):
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), **kw)


@pytest.mark.parametrize("probe_compute", ["float32", "bfloat16"])
def test_fused_step_parity(probe_compute):
    dsp = DspConfig(probe_compute=probe_compute)
    pts_np = ant.create_antenna_grid(8, 8, 0.02)
    pts = jnp.asarray(pts_np)
    taps = dl.LINEAR_TAPS
    span = dl.probe_span(pts_np, ACFG.samples_per_meter, taps, dsp.shift_range)

    swarm_impl = trk.make_swarm_step_impl(TCFG, dsp, ACFG, probe_span=span)
    miso_impl = ms.make_miso_step_impl(TCFG, dsp, ACFG, probe_span=span)
    fused_impl = trk.make_fused_step_impl(TCFG, dsp, ACFG, probe_span=span)

    sw_a = sw_b = trk.swarm_init(TCFG, jax.random.PRNGKey(3))
    mi_a = ms.miso_init(math.radians(20.0), math.radians(50.0))
    mi_b_particle = mi_a.particle

    hist = ring_init(64, dsp.history)
    for i, b in enumerate(synthetic_blocks(pts_np, SOURCES, 8, amplitude=1e-2)):
        hist = ring_push(hist, b)
        window = ring_window(hist, dsp.block_size, dsp.shift_range, taps)
        sw_a, tg_a = swarm_impl(sw_a, window, np.int32(i), pts, None)
        mi_a, beam_a = miso_impl(mi_a, window, pts, None)
        sw_b, tg_b, mi_b_particle, beam_b = fused_impl(
            sw_b, mi_b_particle, window, np.int32(i), pts, None
        )
        # Not bit-exact: the batched per-particle-spread probe construction
        # reassociates a few float ops (~1e-6 rel); discrete divergence
        # (merge/promote flips) would show up as O(1) mismatches.
        _tree_allclose(sw_a, sw_b, rtol=1e-4, atol=1e-6)
        _tree_allclose(tg_a, tg_b, rtol=1e-4, atol=1e-6)
        _tree_allclose(mi_a.particle, mi_b_particle, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(beam_a), np.asarray(beam_b), rtol=1e-4, atol=1e-6
        )


def test_awpu_uses_fused_path_and_tracks():
    # End-to-end: the default awpu step (fused chain) still locks onto the
    # synthetic source and emits a coherent MISO beam.
    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    cfg = Config(tracker=TCFG)
    pts_np = ant.create_antenna_grid(8, 8, 0.02)
    step = make_awpu_step(pts_np, cfg)
    state = awpu_init(cfg, 64, seed=0)
    out = None
    for b in synthetic_blocks(pts_np, SOURCES, 20, amplitude=1e-2):
        state, out = step(state, jnp.asarray(b))
    valid = np.asarray(out.targets.valid)
    assert valid.any()
    d = np.degrees(
        np.asarray(
            spherical_angle(
                np.asarray(out.targets.theta)[valid],
                np.asarray(out.targets.phi)[valid],
                SOURCES[0][0],
                SOURCES[0][1],
            )
        )
    )
    assert d.min() < 10.0
    assert float(np.abs(np.asarray(out.miso_beam)).max()) > 0.0


def test_fused_step_requires_enough_slots():
    dsp = DspConfig()
    with pytest.raises(ValueError):
        trk.make_fused_step_impl(
            TrackerConfig(iterations=1, tracker_steps=2), dsp, ACFG,
            miso_refine_steps=3,
        )
