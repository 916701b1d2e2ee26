"""Separable frequency-domain heatmap (ops/fft_das.py) tests."""

import math

import numpy as np
import jax.numpy as jnp

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig
from beamforming_lk_tpu.models import mimo as mm
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops import fft_das as fd
from tests.reference_impl import fft_das_power_ref

ACFG = ArrayConfig()
DCFG = DspConfig()


def _brute_force_fft_powers(window, points, mimo_cfg, dsp, arr, mask=None):
    """Direct per-(direction, channel) frequency-domain DAS — the
    non-separable reference the fast path must reproduce."""
    theta, phi = mm.make_mimo_grid(mimo_cfg)
    delays = ant.steering_delays_np(points, theta, phi, arr.samples_per_meter)
    return fft_das_power_ref(
        window, delays, dsp.shift_range, dsp.block_size, dl.LINEAR_TAPS, mask
    )


def test_lattice_factorization_grid_and_cluster():
    g = ant.create_antenna_grid(8, 8, 0.02)
    lat = fd.lattice_factorization(g)
    assert lat is not None and len(lat.x) == 8 and len(lat.y) == 8
    # Permutation maps lattice sites back to the right channels.
    site_xy = np.stack([lat.x[np.arange(64) % 8], lat.y[np.arange(64) // 8]])
    np.testing.assert_allclose(g[:2, lat.perm], site_xy, atol=1e-6)

    cluster = ant.multi_array_cluster(256, 8, 8, 0.02)
    lat2 = fd.lattice_factorization(cluster)
    assert lat2 is not None and len(lat2.x) == 16 and len(lat2.y) == 16

    rng = np.random.default_rng(0)
    blob = np.vstack([rng.normal(size=(2, 64)), np.zeros((1, 64))])
    assert fd.lattice_factorization(blob) is None


def test_fft_matches_brute_force_reference():
    mimo = MimoConfig(rows=12, columns=12, fov_degrees=120.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    model = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG)
    assert model is not None
    rng = np.random.default_rng(1)
    window = rng.standard_normal((64, DCFG.shift_range + DCFG.block_size)).astype(
        np.float32
    )
    got = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), model))
    want = _brute_force_fft_powers(window, pts, mimo, DCFG, ACFG)
    # Exact agreement on the FOV disc; clamped corner pixels are filled by
    # the nearest-pixel gather (within one pixel of the reference's clamp),
    # not the clamped-direction beam — exclude them here.
    on_disc = _on_disc(mimo)
    np.testing.assert_allclose(got[on_disc], want[on_disc], rtol=2e-4, atol=1e-9)


def _on_disc(mimo_cfg):
    src = fd._offdisc_gather(mimo_cfg)
    if src is None:
        return np.ones(mimo_cfg.rows * mimo_cfg.columns, bool)
    return src == np.arange(len(src))


def test_fft_dead_channel_subtraction():
    mimo = MimoConfig(rows=10, columns=10, fov_degrees=120.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    mask = np.ones(64, np.float32)
    mask[[3, 17, 44]] = 0.0
    model = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG, channel_mask=mask)
    assert model is not None and model.dead is not None
    rng = np.random.default_rng(2)
    window = rng.standard_normal((64, DCFG.shift_range + DCFG.block_size)).astype(
        np.float32
    )
    got = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), model))
    want = _brute_force_fft_powers(window, pts, mimo, DCFG, ACFG, mask=mask)
    on_disc = _on_disc(mimo)
    np.testing.assert_allclose(got[on_disc], want[on_disc], rtol=2e-4, atol=1e-9)
    # Gain (non-binary) masks are not supported -> None.
    assert (
        fd.make_fft_heatmap_model(
            pts, mimo, DCFG, ACFG, channel_mask=mask * 0.7
        )
        is None
    )


def test_srp_phat_peaks_and_is_level_invariant():
    # PHAT whitening: the steered-response map must still peak at the
    # source, and (unlike plain DAS power) be invariant to signal level.
    from beamforming_lk_tpu.io import ring_init, ring_push, ring_window
    from beamforming_lk_tpu.io.synthetic import synthetic_blocks

    mimo = MimoConfig(rows=16, columns=16, fov_degrees=120.0, phat=True)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    model = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG)
    assert model.phat

    # PHAT weights every bin equally, so use a broadband source (multiple
    # tones from ONE direction) — the whitening assumption.
    tones = [(0.35, 2.0, f) for f in (1000.0, 2500.0, 4000.0, 5500.0,
                                      7000.0, 8500.0, 10000.0, 12000.0)]

    def heatmap(amplitude):
        hist = ring_init(64, DCFG.history)
        for b in synthetic_blocks(pts, tones, 6, amplitude=amplitude, seed=4):
            hist = ring_push(hist, b)
        w = ring_window(hist, DCFG.block_size, DCFG.shift_range, 2)
        return np.asarray(fd.fft_heatmap_powers(w, model))

    p1 = heatmap(1e-2)
    p2 = heatmap(1e-1)  # 10x louder source
    theta, phi = mm.make_mimo_grid(mimo)
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    k = p1.argmax()
    d = math.degrees(float(spherical_angle(float(theta[k]), float(phi[k]), 0.35, 2.0)))
    assert d < 8.0, d
    # Whitened response: 100x power change in the input moves the map by
    # only a small factor (noise floor), not 100x.
    ratio = p2.max() / p1.max()
    assert ratio < 3.0, ratio


def test_fft_fir_mode_alignment():
    # With DspConfig(interp="fir") the dense path's effective delay is
    # tau - center (8-tap polyphase bank); the fft backend must use the
    # same alignment offset so the two agree on a physical source.
    from beamforming_lk_tpu.io import ring_init, ring_push, ring_window
    from beamforming_lk_tpu.io.synthetic import synthetic_blocks

    dsp = DspConfig(interp="fir")
    mimo = MimoConfig(rows=16, columns=16, fov_degrees=120.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    hist = ring_init(64, dsp.history)
    for b in synthetic_blocks(pts, [(0.35, 2.0, 5000.0)], 6):
        hist = ring_push(hist, b)
    window = ring_window(hist, dsp.block_size, dsp.shift_range, dsp.fir_taps)

    model = fd.make_fft_heatmap_model(pts, mimo, dsp, ACFG)
    p_fft = np.asarray(fd.fft_heatmap_powers(window, model))

    bank = dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    theta, phi = mm.make_mimo_grid(mimo)
    delays = ant.steering_delays_np(pts, theta, phi, ACFG.samples_per_meter)
    w = dl.das_weights_np(delays, dsp.shift_range, "fir", bank)
    beam = dl.das_beam(window, jnp.asarray(w))
    p_dense = np.asarray(dl.das_power(beam, divisor=dsp.block_size * 64))
    assert p_fft.argmax() == p_dense.argmax()
    assert np.corrcoef(p_fft, p_dense)[0, 1] > 0.99


def test_fft_bf16_mode_close_to_f32():
    mimo = MimoConfig(rows=12, columns=12, fov_degrees=120.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    m32 = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG)
    mbf = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG, compute="bfloat16")
    rng = np.random.default_rng(5)
    window = rng.standard_normal((64, DCFG.shift_range + DCFG.block_size)).astype(
        np.float32
    )
    p32 = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), m32))
    pbf = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), mbf))
    assert np.corrcoef(p32, pbf)[0, 1] > 0.999
    assert p32.argmax() == pbf.argmax()


def test_fft_offdisc_corners_copy_nearest():
    mimo = MimoConfig(rows=16, columns=16, fov_degrees=180.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    src = fd._offdisc_gather(mimo)
    assert src is not None
    out = np.nonzero(src != np.arange(len(src)))[0]
    assert len(out) > 0  # 180-degree FOV has clamped corners
    model = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG)
    rng = np.random.default_rng(3)
    window = rng.standard_normal((64, DCFG.shift_range + DCFG.block_size)).astype(
        np.float32
    )
    p = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), model))
    np.testing.assert_array_equal(p[out], p[src[out]])


def test_fft_heatmap_peaks_at_source_and_tracks_dense():
    from beamforming_lk_tpu.io import ring_init, ring_push, ring_window
    from beamforming_lk_tpu.io.synthetic import synthetic_blocks

    mimo = MimoConfig(rows=24, columns=24, fov_degrees=150.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    src_theta, src_phi = math.radians(22.0), math.radians(130.0)
    hist = ring_init(64, DCFG.history)
    for b in synthetic_blocks(pts, [(src_theta, src_phi, 5000.0)], 6):
        hist = ring_push(hist, b)
    window = ring_window(hist, DCFG.block_size, DCFG.shift_range, dl.LINEAR_TAPS)

    model = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG)
    p_fft = np.asarray(fd.fft_heatmap_powers(window, model))

    theta, phi = mm.make_mimo_grid(mimo)
    delays = ant.steering_delays_np(pts, theta, phi, ACFG.samples_per_meter)
    w = dl.das_weights_np(delays, DCFG.shift_range, "linear")
    beam = dl.das_beam(window, jnp.asarray(w))
    p_dense = np.asarray(dl.das_power(beam, divisor=DCFG.block_size * 64))

    # Same argmax, high correlation (linear vs exact sinc interpolation).
    assert p_fft.argmax() == p_dense.argmax()
    corr = np.corrcoef(p_fft, p_dense)[0, 1]
    assert corr > 0.995, corr
    # And the peak is the source direction.
    k = p_fft.argmax()
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    d = math.degrees(
        float(spherical_angle(float(theta[k]), float(phi[k]), src_theta, src_phi))
    )
    assert d < 6.0, d


def test_awpu_step_fft_backend_dir_sharded():
    # fft backend under a (ch=1, dir=4) mesh: replicated compute, per-shard
    # direction slice — must match the single-device fft step exactly.
    import jax
    import numpy as np

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import Config
    from beamforming_lk_tpu.io.synthetic import synthetic_blocks
    from beamforming_lk_tpu.parallel import mesh as pm

    cfg = Config(mimo=MimoConfig(rows=16, columns=16, backend="fft"))
    pts = ant.create_antenna_grid(8, 8, 0.02)
    mesh = pm.make_mesh((1, 4), devices=jax.devices()[:4])
    step_m = make_awpu_step(pts, cfg, mesh=mesh)
    step_1 = make_awpu_step(pts, cfg)
    sm = awpu_init(cfg, 64, mesh=mesh, seed=0)
    s1 = awpu_init(cfg, 64, seed=0)
    for b in synthetic_blocks(pts, [(0.4, 1.0, 5000.0)], 4):
        b = jnp.asarray(b)
        sm, om = step_m(sm, b)
        s1, o1 = step_1(s1, b)
    np.testing.assert_allclose(
        np.asarray(om.powers), np.asarray(o1.powers), rtol=1e-5, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(om.prev_max), np.asarray(o1.prev_max), rtol=1e-5
    )


def test_awpu_step_fft_backend():
    import dataclasses

    import jax

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import Config
    from beamforming_lk_tpu.io.synthetic import synthetic_blocks

    cfg = Config(mimo=MimoConfig(rows=16, columns=16, backend="fft"))
    cfg_dense = dataclasses.replace(
        cfg, mimo=dataclasses.replace(cfg.mimo, backend="dense")
    )
    pts = ant.create_antenna_grid(8, 8, 0.02)
    step_f = make_awpu_step(pts, cfg, enable_tracker=False, enable_miso=False)
    step_d = make_awpu_step(pts, cfg_dense, enable_tracker=False, enable_miso=False)
    sf = awpu_init(cfg, 64, seed=0)
    sd = awpu_init(cfg_dense, 64, seed=0)
    for b in synthetic_blocks(pts, [(0.4, 1.0, 5000.0)], 5):
        b = jnp.asarray(b)
        sf, of = step_f(sf, b)
        sd, od = step_d(sd, b)
    pf, pd = np.asarray(of.powers), np.asarray(od.powers)
    assert pf.argmax() == pd.argmax()
    assert np.corrcoef(pf, pd)[0, 1] > 0.99
    jax.block_until_ready(of)


def test_power_paths_agree():
    # "fused" (default) contracts the steered spectra straight against the
    # bandpass-folded restricted inverse DFT; "beam" is the reference-shaped
    # formulation.  Both are the same linear map — they must agree to float
    # round-off on every configuration knob.
    import dataclasses as dc

    mimo = MimoConfig(rows=12, columns=12, fov_degrees=150.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    mask = np.ones(64, np.float32)
    mask[[5, 40]] = 0.0
    rng = np.random.default_rng(7)
    window = jnp.asarray(
        rng.standard_normal((64, DCFG.shift_range + DCFG.block_size)),
        jnp.float32,
    )
    cases = [
        dict(),
        dict(channel_mask=mask),
        dict(compute="bfloat16"),
    ]
    dsps = [DCFG, dc.replace(DCFG, use_bandpass=False)]
    mimos = [mimo, dc.replace(mimo, phat=True)]
    for dsp in dsps:
        for mcfg in mimos:
            for kw in cases:
                base = fd.make_fft_heatmap_model(
                    pts, mcfg, dsp, ACFG, power_path="beam", **kw
                )
                got = {
                    path: np.asarray(
                        fd.fft_heatmap_powers(
                            window, dc.replace(base, power_path=path)
                        )
                    )
                    for path in ("beam", "fused")
                }
                tol = 5e-3 if kw.get("compute") == "bfloat16" else 1e-4
                np.testing.assert_allclose(
                    got["fused"], got["beam"], rtol=tol, atol=1e-12
                )


def test_lattice_order_model_skips_perm_matmul():
    # assume_lattice_order: identical powers from a pre-permuted window,
    # with no per-block permutation matmul — including dead channels.
    mimo = MimoConfig(rows=10, columns=10, fov_degrees=120.0)
    pts = ant.multi_array_cluster(256, 8, 8, 0.02)
    mask = np.ones(256, np.float32)
    mask[[5, 130]] = 0.0
    base = fd.make_fft_heatmap_model(pts, mimo, DCFG, ACFG, channel_mask=mask)
    fast = fd.make_fft_heatmap_model(
        pts, mimo, DCFG, ACFG, channel_mask=mask, assume_lattice_order=True
    )
    assert base.perm_matrix is not None
    assert fast.perm_matrix is None and fast.channel_perm is not None
    rng = np.random.default_rng(7)
    window = rng.standard_normal(
        (256, DCFG.shift_range + DCFG.block_size)
    ).astype(np.float32)
    p_base = np.asarray(fd.fft_heatmap_powers(jnp.asarray(window), base))
    p_fast = np.asarray(
        fd.fft_heatmap_powers(jnp.asarray(window[fast.channel_perm]), fast)
    )
    np.testing.assert_allclose(p_fast, p_base, rtol=1e-5, atol=1e-12)


def test_chunked_powers_match_per_window():
    # fft_heatmap_powers_chunked == vmap(fft_heatmap_powers), in f32 and
    # bf16.
    import jax

    mimo = MimoConfig(rows=10, columns=10, fov_degrees=120.0)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    rng = np.random.default_rng(3)
    wins = jnp.asarray(
        rng.standard_normal(
            (4, 64, DCFG.shift_range + DCFG.block_size)
        ).astype(np.float32)
    )
    for compute in ("float32", "bfloat16"):
        model = fd.make_fft_heatmap_model(
            pts, mimo, DCFG, ACFG, compute=compute
        )
        want = np.asarray(
            jax.vmap(lambda w: fd.fft_heatmap_powers(w, model))(wins)
        )
        got = np.asarray(fd.fft_heatmap_powers_chunked(wins, model))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-12,
                                   err_msg=compute)
