import math

import jax
import numpy as np
import pytest

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, TrackerConfig
from beamforming_lk_tpu.io import ring_init, ring_push, ring_window
from beamforming_lk_tpu.io.synthetic import synthetic_blocks
from beamforming_lk_tpu.models import tracker as trk
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops.geometry import spherical_angle

ACFG = ArrayConfig()
DCFG = DspConfig()
TCFG = TrackerConfig(
    n_seekers=8, n_trackers=4, iterations=4, fov_degrees=120.0,
    seeker_reset_interval=64,
)


def _run_blocks(sources, n_blocks, cfg=TCFG, seed=0, amplitude=1e-2, dsp=DCFG):
    pts = ant.create_antenna_grid(8, 8, 0.02)
    step = trk.make_swarm_step(pts, cfg, dsp, ACFG)
    state = trk.swarm_init(cfg, jax.random.PRNGKey(seed))
    hist = ring_init(64, dsp.history)
    targets = None
    for i, b in enumerate(
        synthetic_blocks(pts, sources, n_blocks, amplitude=amplitude)
    ):
        hist = ring_push(hist, b)
        window = ring_window(hist, dsp.block_size, dsp.shift_range, 2)
        state, targets = step(state, window, np.int32(i))
    return state, targets


def test_tracker_converges_to_source():
    src_theta, src_phi = math.radians(25.0), math.radians(60.0)
    state, targets = _run_blocks([(src_theta, src_phi, 5000.0)], 25)
    valid = np.asarray(targets.valid)
    assert valid.any(), "no tracker locked on"
    th = np.asarray(targets.theta)[valid]
    ph = np.asarray(targets.phi)[valid]
    d = np.degrees(
        np.asarray(spherical_angle(th, ph, src_theta, src_phi))
    )
    assert d.min() < 10.0, f"closest tracker {d.min():.1f} deg away"


def test_probe_span_reduction_is_exact():
    # A probe stencil sized to the aperture (ops.delay.probe_span) must give
    # the same beams/powers as the full shift_range stencil: the window is
    # sliced by the same constant the integer-shift base moves.
    import jax.numpy as jnp

    from beamforming_lk_tpu.ops import delay as dl

    pts = ant.create_antenna_grid(8, 8, 0.02)
    span = dl.probe_span(pts, ACFG.samples_per_meter, 2, DCFG.shift_range)
    assert span < DCFG.shift_range  # 8x8 @ 2 cm needs 32, not 64

    rng = np.random.default_rng(7)
    window = jnp.asarray(
        rng.standard_normal((64, DCFG.block_size + DCFG.shift_range)),
        jnp.float32,
    )
    particles = trk._empty_particles(6)._replace(
        theta=jnp.asarray(rng.uniform(0.0, 1.0, 6), jnp.float32),
        phi=jnp.asarray(rng.uniform(0.0, 2 * np.pi, 6), jnp.float32),
    )
    active = jnp.ones((6,), bool)
    kwargs = dict(
        window=window,
        points=jnp.asarray(pts),
        channel_mask=None,
        rate=0.02,
        spread=math.radians(2.0),
        theta_limit=math.radians(60.0),
        shift_range=DCFG.shift_range,
        mode="linear",
        fir_bank=None,
        samples_per_meter=ACFG.samples_per_meter,
    )
    full = trk._monopulse_step(particles, active, **kwargs)
    tight = trk._monopulse_step(particles, active, span=span, **kwargs)
    for a, b in zip(full, tight):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7)


def test_tracker_converges_with_bf16_probes():
    dsp = DspConfig(probe_compute="bfloat16")
    src_theta, src_phi = math.radians(25.0), math.radians(60.0)
    state, targets = _run_blocks([(src_theta, src_phi, 5000.0)], 25, dsp=dsp)
    valid = np.asarray(targets.valid)
    assert valid.any(), "no tracker locked on with bf16 probes"
    th = np.asarray(targets.theta)[valid]
    ph = np.asarray(targets.phi)[valid]
    d = np.degrees(np.asarray(spherical_angle(th, ph, src_theta, src_phi)))
    assert d.min() < 10.0, f"closest tracker {d.min():.1f} deg away"


def test_no_source_no_confident_targets():
    # Pure noise: any surviving target must carry near-noise power.
    rng = np.random.default_rng(3)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    step = trk.make_swarm_step(pts, TCFG, DCFG, ACFG)
    state = trk.swarm_init(TCFG, jax.random.PRNGKey(1))
    hist = ring_init(64, DCFG.history)
    for i in range(10):
        block = rng.normal(0, 1e-3, size=(64, DCFG.block_size)).astype(np.float32)
        hist = ring_push(hist, block)
        window = ring_window(hist, DCFG.block_size, DCFG.shift_range, 2)
        state, targets = step(state, window, np.int32(i))
    power = np.asarray(targets.power)[np.asarray(targets.valid)]
    if power.size:
        assert power.max() < 1e-4


def test_merge_trackers_keeps_oldest():
    theta = np.array([0.3, 0.3, 1.0], np.float32)
    phi = np.array([1.0, 1.01, 4.0], np.float32)
    particles = trk.Particles(
        theta=theta, phi=phi,
        grad_theta=np.zeros(3, np.float32), grad_phi=np.zeros(3, np.float32),
        radius=np.ones(3, np.float32), error=np.zeros(3, np.float32),
    )
    tracking = np.array([True, True, True])
    start = np.array([5.0, 2.0, 0.0], np.float32)  # tracker 1 older than 0
    new_tracking = np.asarray(
        trk._merge_trackers(particles, tracking, start, math.radians(5.0))
    )
    assert new_tracking.tolist() == [False, True, True]


def test_merge_tie_keeps_lower_index():
    particles = trk.Particles(
        theta=np.array([0.3, 0.3], np.float32),
        phi=np.array([1.0, 1.0], np.float32),
        grad_theta=np.zeros(2, np.float32), grad_phi=np.zeros(2, np.float32),
        radius=np.ones(2, np.float32), error=np.zeros(2, np.float32),
    )
    new_tracking = np.asarray(
        trk._merge_trackers(
            particles, np.array([True, True]), np.array([3.0, 3.0], np.float32),
            math.radians(5.0),
        )
    )
    assert new_tracking.tolist() == [True, False]


def test_swarm_state_shapes():
    state = trk.swarm_init(TCFG, jax.random.PRNGKey(0))
    assert state.seekers.theta.shape == (TCFG.n_seekers,)
    assert state.trackers.theta.shape == (TCFG.n_trackers,)
    assert not bool(np.asarray(state.tracking).any())
    assert (np.asarray(state.seekers.theta) <= TCFG.theta_limit + 1e-6).all()


def test_two_sources_both_tracked():
    """Two simultaneous sources (within 10 dB) are tracked to sub-degree
    accuracy — the reference's headline multi-tracker capability
    (TRACKER_MAX 10, gradient_ascend.h:28)."""
    import numpy as np

    from beamforming_lk_tpu.app import AwpuPipeline
    from beamforming_lk_tpu.config import Config, MimoConfig, TrackerConfig
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    cfg = Config(mimo=MimoConfig(rows=8, columns=8),
                 tracker=TrackerConfig(iterations=4))
    pipe = AwpuPipeline(cfg, seed=0, enable_mimo=False, enable_miso=False)
    s1 = (0.4, 0.8, 4000.0)
    s2 = (0.7, 3.5, 6500.0)
    for b in range(16):
        pipe.process_block(
            plane_wave_block(pipe.points, [s1, s2], b * 256, 256, cfg.array,
                             noise_std=0.02)
        )
    tgts = pipe.targets()
    d1 = min(float(spherical_angle(t["theta"], t["phi"], *s1[:2])) for t in tgts)
    d2 = min(float(spherical_angle(t["theta"], t["phi"], *s2[:2])) for t in tgts)
    assert np.degrees(d1) < 2.0, np.degrees(d1)
    assert np.degrees(d2) < 2.0, np.degrees(d2)


def test_tracker_converges_with_horizontal_probes():
    # USE_HORIZONTAL=1 layout (Spherical::nearby N/E/S/W probes with the
    # reference's max-normalized axis discriminants,
    # gradient_ascend.cpp:41-48) must also lock onto a source.
    src_theta, src_phi = math.radians(25.0), math.radians(60.0)
    import dataclasses

    cfg = dataclasses.replace(TCFG, probe_layout="horizontal")
    state, targets = _run_blocks([(src_theta, src_phi, 5000.0)], 25, cfg=cfg)
    valid = np.asarray(targets.valid)
    assert valid.any(), "no tracker locked on (horizontal probes)"
    th = np.asarray(targets.theta)[valid]
    ph = np.asarray(targets.phi)[valid]
    d = np.degrees(np.asarray(spherical_angle(th, ph, src_theta, src_phi)))
    assert d.min() < 10.0, f"closest tracker {d.min():.1f} deg away"


def _history_and_window(interp, n_blocks=5):
    """A filled ring history (source + noise) and the step's DAS window."""
    from beamforming_lk_tpu.io import ring as rg

    dsp = DspConfig(interp=interp)
    taps = 2 if interp == "linear" else dsp.fir_taps
    pts = ant.create_antenna_grid(8, 8, 0.02)
    hist = ring_init(64, dsp.history)
    for b in synthetic_blocks(pts, [(0.45, 1.3, 4500.0)], n_blocks,
                              noise_std=0.3):
        hist = ring_push(hist, b)
    window = ring_window(hist, dsp.block_size, dsp.shift_range, taps)
    b0 = rg.block_start(dsp.history, dsp.block_size)
    return dsp, pts, np.asarray(hist, np.float64), window, b0


def _das_block_ref(hist, pts, theta, phi, b0, dsp, bank):
    from tests import reference_impl as ref

    delays = ref.steering_delays_ref(pts, theta, phi, ACFG.samples_per_meter)
    if dsp.interp == "linear":
        return ref.das_ref(hist, delays, b0, dsp.block_size)
    return ref.das_fir_ref(hist, delays, b0, dsp.block_size, bank)


@pytest.mark.parametrize("interp", ["linear", "fir"])
@pytest.mark.parametrize("layout", ["quadrant", "horizontal"])
def test_monopulse_step_matches_reference(layout, interp):
    """One XLA monopulse step (the tracker chain's unit) against the loop
    reference: probe directions by explicit rotation, probe beams by
    das_ref / das_fir_ref, bandpassed powers, discriminants."""
    from beamforming_lk_tpu.ops import delay as dl
    from tests import reference_impl as ref

    dsp, pts, hist, window, b0 = _history_and_window(interp)
    bank = dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    rng = np.random.default_rng(4)
    theta = rng.uniform(0.1, 1.2, 5).astype(np.float32)
    phi = rng.uniform(0.0, 2 * np.pi, 5).astype(np.float32)
    spread = np.float32(np.radians(7.0))
    z = np.zeros_like(theta)
    out = trk._monopulse_step(
        trk.Particles(theta, phi, z, z, z, z), np.ones(5, bool),
        window=window, points=pts, channel_mask=None, rate=0.0,
        spread=spread, theta_limit=TrackerConfig().theta_limit,
        shift_range=dsp.shift_range, mode=interp,
        fir_bank=None if interp == "linear" else bank,
        samples_per_meter=ACFG.samples_per_meter, probe_layout=layout,
    )
    for i in range(5):
        probes, _ = ref.monopulse_probes_ref(
            float(theta[i]), float(phi[i]), float(spread), layout
        )
        q = [
            ref.bandpass_power_ref(
                _das_block_ref(hist, pts, pt, pp, b0, dsp, bank),
                dsp.block_size, dsp.block_size,
            )
            for pt, pp in probes
        ]
        if layout == "quadrant":
            total = sum(q)
            g_theta = ((q[0] + q[1]) - (q[2] + q[3])) / total
            g_phi = ((q[0] + q[3]) - (q[1] + q[2])) / total
        else:
            g_theta = (q[0] - q[2]) / max(q[0], q[2])
            g_phi = (q[1] - q[3]) / max(q[1], q[3])
        np.testing.assert_allclose(
            float(out.radius[i]), sum(q) / 4.0, rtol=1e-4
        )
        np.testing.assert_allclose(
            [float(out.grad_theta[i]), float(out.grad_phi[i])],
            [g_theta, g_phi], atol=1e-4,
        )


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_fused_step_miso_beam_matches_reference(interp):
    """The MISO audio beam the fused step emits is the DAS beam at the
    refined listener direction."""
    import jax.numpy as jnp

    from beamforming_lk_tpu.models import miso as ms
    from beamforming_lk_tpu.ops import delay as dl

    dsp, pts, hist, window, b0 = _history_and_window(interp)
    bank = dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    cfg = TrackerConfig(n_seekers=8, n_trackers=4, iterations=2)
    fused = trk.make_fused_step_impl(cfg, dsp, ACFG)
    state = trk.swarm_init(cfg, jax.random.PRNGKey(0))
    listener = ms.miso_init(0.4, 1.2).particle
    _, _, listener, beam = fused(
        state, listener, window, np.int32(0), jnp.asarray(pts), None
    )
    want = _das_block_ref(hist, pts, float(listener.theta[0]),
                          float(listener.phi[0]), b0, dsp, bank)
    beam = np.asarray(beam, np.float64)
    np.testing.assert_allclose(
        beam / np.abs(want).max(), want / np.abs(want).max(), atol=1e-5
    )
