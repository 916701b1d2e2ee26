"""MVDR/Capon beamformer: finds sources, suppresses interferers better
than DAS (its raison d'etre), handles masks, stays finite while warming."""

import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.config import ArrayConfig, MimoConfig
from beamforming_lk_tpu.io.synthetic import plane_wave_block
from beamforming_lk_tpu.models.mimo import make_mimo_grid
from beamforming_lk_tpu.models.mvdr import make_mvdr_step, mvdr_init, select_bins
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops.geometry import spherical_angle

ACFG = ArrayConfig()


def _run(sources, n_blocks=6, grid=16, **kw):
    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=grid, columns=grid))
    step, n_bins = make_mvdr_step(points, theta, phi, ACFG, **kw)
    c = points.shape[1]
    state = mvdr_init(n_bins, c)
    powers = None
    for b in range(n_blocks):
        block = plane_wave_block(points, sources, b * 256, 256, ACFG, noise_std=0.05)
        state, powers = step(state, jnp.asarray(block))
    return np.asarray(powers), theta, phi, state


def test_real_embedding_matches_complex_capon():
    """v^H R^-1 v computed via the 2x2 real block embedding == the complex
    value (CPU reference; the device path never touches complex dtypes)."""
    from beamforming_lk_tpu.models.mvdr import hermitian_embed

    rng = np.random.default_rng(7)
    c, d = 12, 9
    a = rng.standard_normal((c, c)) + 1j * rng.standard_normal((c, c))
    r = a @ a.conj().T + 0.5 * np.eye(c)          # HPD
    v = rng.standard_normal((d, c)) + 1j * rng.standard_normal((d, c))
    want = np.einsum("dc,cd->d", v.conj(), np.linalg.solve(r, v.T)).real

    m = np.asarray(hermitian_embed(jnp.asarray(r.real), jnp.asarray(r.imag)))
    v_emb = np.concatenate([v.real, v.imag], axis=-1)  # [D, 2C]
    got = np.einsum("dc,cd->d", v_emb, np.linalg.solve(m, v_emb.T))
    np.testing.assert_allclose(got, want, rtol=1e-5)  # f32 embed rounding


def test_dft_tables_match_rfft():
    from beamforming_lk_tpu.models.mvdr import dft_tables

    rng = np.random.default_rng(3)
    frame = 64
    bins = select_bins(frame, 48828.0)
    x = rng.standard_normal((5, frame)).astype(np.float32)
    w = np.hanning(frame)
    want = np.fft.rfft(x * w, axis=-1)[:, bins]
    tab = dft_tables(frame, bins)
    got = (x @ tab[0]) - 1j * (x @ tab[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bin_selection():
    bins = select_bins(64, 48828.0, 550.0, 9000.0)
    freqs = np.fft.rfftfreq(64, 1 / 48828.0)
    assert len(bins) > 3
    assert freqs[bins].min() >= 550.0 and freqs[bins].max() <= 9000.0


def test_single_source_peak():
    src = (0.5, 1.2, 4000.0)
    powers, theta, phi, state = _run([src])
    d = int(np.argmax(powers))
    ang = float(spherical_angle(theta[d], phi[d], src[0], src[1]))
    assert ang < np.radians(12), ang
    assert np.all(np.isfinite(powers))
    assert int(np.asarray(state.count)) == 6


def test_two_sources_resolved():
    s1 = (0.45, 0.8, 3500.0)
    s2 = (0.45, 0.8 + np.pi, 5200.0)
    powers, theta, phi, _ = _run([s1, s2], n_blocks=8)
    # Both directions are local maxima regions: check the peak bins near
    # each source out-power the map median by a wide margin.
    def power_near(src):
        ang = np.asarray(spherical_angle(theta, phi, src[0], src[1]))
        return powers[ang < np.radians(10)].max()

    med = np.median(powers)
    assert power_near(s1) > 5 * med
    assert power_near(s2) > 5 * med


def test_mask_zeroes_channels():
    src = (0.4, 1.0, 4000.0)
    points = ant.create_antenna_grid()
    mask = np.ones(64, np.float32)
    mask[5] = 0.0
    theta, phi = make_mimo_grid(MimoConfig(rows=12, columns=12))
    step, n_bins = make_mvdr_step(points, theta, phi, ACFG, channel_mask=mask)
    state = mvdr_init(n_bins, 64)
    for b in range(4):
        block = plane_wave_block(points, [src], b * 256, 256, ACFG, noise_std=0.05)
        state, powers = step(state, jnp.asarray(block))
    powers = np.asarray(powers)
    assert np.all(np.isfinite(powers))
    d = int(np.argmax(powers))
    ang = float(spherical_angle(theta[d], phi[d], src[0], src[1]))
    assert ang < np.radians(15)


def test_bin_sharded_mvdr_matches_dense():
    """Bins sharded over the mesh (the stretch config): sharded Capon
    powers match the single-device path."""
    from beamforming_lk_tpu.models.mvdr import make_sharded_mvdr_step
    from beamforming_lk_tpu.parallel import mesh as pm

    src = (0.5, 1.2, 4000.0)
    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=12, columns=12))

    dense_step, n_bins = make_mvdr_step(points, theta, phi, ACFG)
    dense_state = mvdr_init(n_bins, 64)

    mesh = pm.make_mesh((1, 8))
    sh_step, sh_state = make_sharded_mvdr_step(points, theta, phi, mesh)

    for b in range(5):
        block = jnp.asarray(
            plane_wave_block(points, [src], b * 256, 256, ACFG, noise_std=0.05)
        )
        dense_state, dense_p = dense_step(dense_state, block)
        sh_state, sh_p = sh_step(sh_state, block)

    a = np.asarray(dense_p, np.float64)
    b = np.asarray(sh_p, np.float64)
    np.testing.assert_allclose(b, a, rtol=5e-4)
    assert int(np.argmax(a)) == int(np.argmax(b))


def test_weight_refresh_exact_parity_on_refresh_blocks():
    """weight_refresh=k: the covariance EMA is identical to the undecimated
    path on EVERY block, and on refresh blocks (count % k == 0) the Capon
    spectrum is bit-identical to the every-block solver; in between the
    carried spectrum is exactly the last refresh's."""
    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=12, columns=12))
    k = 3
    step_full, n_bins = make_mvdr_step(points, theta, phi, ACFG)
    step_dec, _ = make_mvdr_step(points, theta, phi, ACFG, weight_refresh=k)
    s_full = mvdr_init(n_bins, 64)
    s_dec = step_dec.init()
    assert s_dec.powers is not None and s_dec.powers.shape == (144,)

    last_refresh = None
    for b in range(7):
        block = jnp.asarray(
            plane_wave_block(points, [(0.5, 1.2, 4000.0)], b * 256, 256,
                             ACFG, noise_std=0.05)
        )
        s_full, p_full = step_full(s_full, block)
        s_dec, p_dec = step_dec(s_dec, block)
        np.testing.assert_array_equal(
            np.asarray(s_dec.cov_re), np.asarray(s_full.cov_re)
        )
        if b % k == 0:
            np.testing.assert_array_equal(
                np.asarray(p_dec), np.asarray(p_full)
            )
            last_refresh = np.asarray(p_dec)
        else:
            np.testing.assert_array_equal(np.asarray(p_dec), last_refresh)


def test_weight_refresh_staleness_bound():
    """On a stationary scene the spectrum a few blocks stale stays within
    EMA noise of the fresh one — the bound that makes decimation an honest
    deployment default at 256 mics."""
    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=12, columns=12))
    step_full, n_bins = make_mvdr_step(points, theta, phi, ACFG)
    step_dec, _ = make_mvdr_step(points, theta, phi, ACFG, weight_refresh=4)
    s_full = mvdr_init(n_bins, 64)
    s_dec = step_dec.init()
    src = (0.5, 1.2, 4000.0)
    for b in range(12):
        block = jnp.asarray(
            plane_wave_block(points, [src], b * 256, 256, ACFG,
                             noise_std=0.05)
        )
        s_full, p_full = step_full(s_full, block)
        s_dec, p_dec = step_dec(s_dec, block)
        if b >= 4:  # past warmup
            a, d = np.asarray(p_full), np.asarray(p_dec)
            # Same peak every block, stale spectrum within 25 % relative
            # (alpha=0.1 EMA moves the covariance <~ 30 % over 3 blocks).
            assert int(np.argmax(a)) == int(np.argmax(d))
            rel = np.abs(d - a) / np.maximum(np.abs(a), 1e-20)
            assert float(rel.max()) < 0.25, (b, float(rel.max()))


def test_bin_sharded_weight_refresh_matches_dense():
    """Decimated solve under the bin-sharded mesh: the replicated carried
    spectrum and uniform cond branch reproduce the single-device decimated
    path."""
    from beamforming_lk_tpu.models.mvdr import make_sharded_mvdr_step
    from beamforming_lk_tpu.parallel import mesh as pm

    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=12, columns=12))
    step_dec, _ = make_mvdr_step(points, theta, phi, ACFG, weight_refresh=3)
    s_dec = step_dec.init()
    mesh = pm.make_mesh((1, 8))
    sh_step, sh_state = make_sharded_mvdr_step(
        points, theta, phi, mesh, weight_refresh=3
    )
    for b in range(5):
        block = jnp.asarray(
            plane_wave_block(points, [(0.5, 1.2, 4000.0)], b * 256, 256,
                             ACFG, noise_std=0.05)
        )
        s_dec, p_dec = step_dec(s_dec, block)
        sh_state, sh_p = sh_step(sh_state, block)
        np.testing.assert_allclose(
            np.asarray(sh_p, np.float64), np.asarray(p_dec, np.float64),
            rtol=5e-4,
        )


def test_scan_matches_stepwise():
    # step.scan (one chained device program, the replay and benchmark
    # shape) must reproduce the per-block step sequence.
    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
    step, n_bins = make_mvdr_step(points, theta, phi, ACFG)
    c = points.shape[1]
    blocks = np.stack([
        plane_wave_block(points, [(0.4, 1.0, 3000.0)], b * 256, 256, ACFG,
                         noise_std=0.05)
        for b in range(4)
    ])
    s1 = s2 = mvdr_init(n_bins, c)
    for b in blocks:
        s1, p1 = step(s1, jnp.asarray(b))
    s2, ps = step.scan(s2, blocks)
    np.testing.assert_allclose(np.asarray(ps[-1]), np.asarray(p1),
                               rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s2.cov_re), np.asarray(s1.cov_re),
                               rtol=2e-5, atol=1e-9)


def test_music_scan_matches_stepwise():
    from beamforming_lk_tpu.models.music import make_music_step

    points = ant.create_antenna_grid()
    theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
    step, n_bins = make_music_step(points, theta, phi, ACFG, n_sources=2)
    c = points.shape[1]
    blocks = np.stack([
        plane_wave_block(points, [(0.4, 1.0, 3000.0)], b * 256, 256, ACFG,
                         noise_std=0.05)
        for b in range(4)
    ])
    s1 = s2 = step.init()
    for b in blocks:
        s1, p1 = step(s1, jnp.asarray(b))
    s2, ps = step.scan(s2, blocks)
    # eigh in a scan body may pick different eigenvector signs per step on
    # some backends; the pseudo-spectrum is sign-invariant.
    np.testing.assert_allclose(np.asarray(ps[-1]), np.asarray(p1),
                               rtol=5e-4, atol=1e-9)
