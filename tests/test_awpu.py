"""The fused AWPU step must produce identical results single-device and
shard_mapped over a (ch=2, dir=4) mesh — heatmap powers, tracker targets and
the MISO beam all at once (the multi-chip program IS the single-chip
program)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beamforming_lk_tpu.app import AwpuPipeline, awpu_init, make_awpu_step
from beamforming_lk_tpu.config import Config, DspConfig, MimoConfig, TrackerConfig
from beamforming_lk_tpu.io.synthetic import plane_wave_block
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops.geometry import spherical_angle
from beamforming_lk_tpu.parallel import mesh as pm

CFG = Config(
    mimo=MimoConfig(rows=16, columns=16),
    tracker=TrackerConfig(iterations=2),
)
SRC = (0.5, 2.0, 5000.0)


def _blocks(points, n):
    return [
        plane_wave_block(
            points, [SRC], b * CFG.dsp.block_size, CFG.dsp.block_size,
            CFG.array, noise_std=0.02,
        )
        for b in range(n)
    ]


def test_fused_step_sharded_matches_dense():
    points = ant.create_antenna_grid()
    mask = np.ones(points.shape[1], np.float32)
    mask[13] = 0.0  # one dead mic, as calibration would produce
    blocks = _blocks(points, 3)

    dense_step = make_awpu_step(points, CFG, channel_mask=mask)
    dense_state = awpu_init(CFG, points.shape[1], seed=3)

    mesh = pm.make_mesh((2, 4))
    sh_step = make_awpu_step(points, CFG, channel_mask=mask, mesh=mesh)
    sh_state = awpu_init(CFG, points.shape[1], mesh=mesh, seed=3)

    for blk in blocks:
        blk = jnp.asarray(blk)
        dense_state, dense_out = dense_step(dense_state, blk)
        sh_state, sh_out = sh_step(sh_state, blk)

    np.testing.assert_allclose(
        np.asarray(sh_out.powers), np.asarray(dense_out.powers),
        rtol=2e-4, atol=1e-14,
    )
    # psum reduction order differs from the dense sum; the tiny float
    # difference compounds through the 3 monopulse refinement steps, so the
    # bound is absolute against the beam's ~0.06 amplitude.
    np.testing.assert_allclose(
        np.asarray(sh_out.miso_beam), np.asarray(dense_out.miso_beam),
        rtol=2e-3, atol=2e-5,
    )
    assert np.array_equal(
        np.asarray(sh_out.targets.valid), np.asarray(dense_out.targets.valid)
    )
    np.testing.assert_allclose(
        np.asarray(sh_out.targets.theta), np.asarray(dense_out.targets.theta),
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.history), np.asarray(dense_state.history),
        rtol=0, atol=0,
    )


def test_pipeline_finds_source():
    cfg = Config(
        mimo=MimoConfig(rows=16, columns=16),
        tracker=TrackerConfig(iterations=4),
    )
    pipe = AwpuPipeline(cfg, seed=0)
    for blk in _blocks(pipe.points, 8):
        out = pipe.process_block(blk)

    # Heatmap argmax near the true source.
    from beamforming_lk_tpu.models.mimo import make_mimo_grid

    theta, phi = make_mimo_grid(cfg.mimo)
    d = int(np.argmax(np.asarray(out.powers)))
    assert float(spherical_angle(theta[d], phi[d], SRC[0], SRC[1])) < np.radians(12)

    img = pipe.heatmap()
    assert img.shape == (16, 16) and img.max() == 255

    # Tracker publishes at least one target near the source.
    tgts = pipe.targets()
    assert any(
        float(spherical_angle(t["theta"], t["phi"], SRC[0], SRC[1])) < np.radians(10)
        for t in tgts
    ), tgts

    # Click-to-steer re-pins MISO.
    pipe.steer(SRC[0], SRC[1])
    out = pipe.process_block(_blocks(pipe.points, 9)[-1])
    assert np.asarray(out.miso_beam).shape == (cfg.dsp.block_size,)


def test_multi_array_cluster_pipeline():
    """256-mic coherent cluster (4 fused 8x8 arrays) through the fused
    step — BASELINE config 3's aperture."""
    cfg = Config(mimo=MimoConfig(rows=16, columns=16),
                 tracker=TrackerConfig(iterations=2))
    pipe = AwpuPipeline(cfg, channels=256, enable_tracker=False,
                        enable_miso=False)
    assert pipe.points.shape == (3, 256)
    out = None
    for blk in [
        plane_wave_block(pipe.points, [SRC], b * 256, 256, cfg.array,
                         noise_std=0.02)
        for b in range(4)
    ]:
        out = pipe.process_block(blk)
    from beamforming_lk_tpu.models.mimo import make_mimo_grid

    theta, phi = make_mimo_grid(cfg.mimo)
    d = int(np.argmax(np.asarray(out.powers)))
    assert float(spherical_angle(theta[d], phi[d], SRC[0], SRC[1])) < np.radians(10)


def test_oversized_aperture_rejected():
    import pytest

    cfg = Config(mimo=MimoConfig(rows=8, columns=8))
    with pytest.raises(ValueError, match="shift_range"):
        AwpuPipeline(cfg, channels=1024)


def test_scan_batch_matches_stepwise():
    """process_blocks (one on-device scan dispatch) == per-block stepping,
    single-device and sharded."""
    import jax

    cfg = Config(mimo=MimoConfig(rows=16, columns=16),
                 tracker=TrackerConfig(iterations=1))
    blocks = _blocks(ant.create_antenna_grid(), 4)

    a = AwpuPipeline(cfg, seed=7)
    for b in blocks:
        a.process_block(b)

    b_pipe = AwpuPipeline(cfg, seed=7)
    stacked = b_pipe.process_blocks(np.stack(blocks))
    assert np.asarray(stacked.powers).shape[0] == 4
    np.testing.assert_allclose(
        np.asarray(b_pipe.last.powers), np.asarray(a.last.powers),
        rtol=1e-6, atol=1e-12,
    )
    np.testing.assert_array_equal(
        np.asarray(b_pipe.state.history), np.asarray(a.state.history)
    )
    assert int(np.asarray(b_pipe.state.block_index)) == 4

    mesh = pm.make_mesh((2, 4))
    c_pipe = AwpuPipeline(cfg, seed=7, mesh=mesh)
    c_pipe.process_blocks(np.stack(blocks))
    np.testing.assert_allclose(
        np.asarray(c_pipe.last.powers), np.asarray(a.last.powers),
        rtol=2e-4, atol=1e-13,
    )


def test_bf16_compute_close_to_f32():
    from beamforming_lk_tpu.config import DspConfig

    cfg32 = Config(mimo=MimoConfig(rows=16, columns=16),
                   tracker=TrackerConfig(iterations=1))
    cfg16 = Config(dsp=DspConfig(compute="bfloat16"),
                   mimo=MimoConfig(rows=16, columns=16),
                   tracker=TrackerConfig(iterations=1))
    blocks = _blocks(ant.create_antenna_grid(), 3)
    a = AwpuPipeline(cfg32, seed=5)
    b = AwpuPipeline(cfg16, seed=5)
    for blk in blocks:
        oa = a.process_block(blk)
        ob = b.process_block(blk)
    pa = np.asarray(oa.powers, np.float64)
    pb = np.asarray(ob.powers, np.float64)
    # bf16 input quantization (~0.4%) squares into power: a few % on the
    # tiny off-peak bins is expected.
    assert np.max(np.abs(pa - pb) / np.maximum(np.abs(pa), 1e-30)) < 5e-2
    # Peak direction unchanged.
    assert int(np.argmax(pa)) == int(np.argmax(pb))


def test_auto_calibration_masks_dead_channel():
    """Startup auto-calibration (the reference's connect-time calibrate):
    a dead mic is detected from the first blocks and masked out of the
    rebuilt step; the heatmap peak survives."""
    cfg = Config(mimo=MimoConfig(rows=16, columns=16),
                 tracker=TrackerConfig(iterations=1))
    pipe = AwpuPipeline(cfg, seed=2, enable_tracker=False, enable_miso=False)
    blocks = _blocks(pipe.points, 4)
    dead = 21
    for b in blocks:
        b[dead] = 0.0  # dead mic
    result = pipe.calibrate(blocks)
    mask = np.asarray(result.mask)
    assert mask[dead] == 0.0
    assert mask.sum() >= 60  # the healthy mics survive
    out = pipe.process_block(_blocks(pipe.points, 5)[-1])
    from beamforming_lk_tpu.models.mimo import make_mimo_grid

    theta, phi = make_mimo_grid(cfg.mimo)
    d = int(np.argmax(np.asarray(out.powers)))
    assert float(spherical_angle(theta[d], phi[d], SRC[0], SRC[1])) < np.radians(10)


def test_fft_backend_falls_back_to_dense_under_channel_sharding(capsys):
    # backend="fft" requires the full channel axis on every shard; under a
    # ch>1 mesh the step must WARN and fall back to the dense kernel with
    # numerically-equivalent heatmap powers (awpu.py fft_model gating).
    import dataclasses

    points = ant.create_antenna_grid()
    fft_cfg = dataclasses.replace(
        CFG, mimo=MimoConfig(rows=16, columns=16, backend="fft")
    )
    blocks = _blocks(points, 2)

    dense_step = make_awpu_step(points, CFG)
    dense_state = awpu_init(CFG, points.shape[1], seed=3)

    mesh = pm.make_mesh((2, 4))  # ch axis = 2 -> fft unavailable
    fb_step = make_awpu_step(points, fft_cfg, mesh=mesh)
    fb_state = awpu_init(fft_cfg, points.shape[1], mesh=mesh, seed=3)
    assert "using dense" in capsys.readouterr().err

    for blk in blocks:
        blk = jnp.asarray(blk)
        dense_state, dense_out = dense_step(dense_state, blk)
        fb_state, fb_out = fb_step(fb_state, blk)

    np.testing.assert_allclose(
        np.asarray(fb_out.powers), np.asarray(dense_out.powers),
        rtol=2e-4, atol=1e-14,
    )


def test_heatmap_chunked_scan_matches_per_block():
    # Heatmap-only chunked streaming (MimoConfig.heatmap_chunk): identical
    # per-block powers and EMA maxima to block-at-a-time processing, for
    # both backends.
    import dataclasses

    from beamforming_lk_tpu.io.synthetic import plane_wave_block

    for backend in ("dense", "fft"):
        cfg = Config(
            mimo=MimoConfig(rows=8, columns=8, backend=backend),
            dsp=DspConfig(block_size=64, shift_range=32, history=256),
        )
        cfg_ck = dataclasses.replace(
            cfg, mimo=dataclasses.replace(cfg.mimo, heatmap_chunk=4)
        )
        pts = ant.create_antenna_grid(8, 8, 0.02)
        src = [(0.4, 1.0, 5000.0)]
        blocks = np.stack([
            plane_wave_block(pts, src, i * 64, 64, cfg.array, noise_std=0.01)
            for i in range(8)
        ]).astype(np.float32)

        kw = dict(enable_tracker=False, enable_miso=False)
        a = AwpuPipeline(cfg, points=pts, **kw)
        b = AwpuPipeline(cfg_ck, points=pts, **kw)
        out_a = a.process_blocks(blocks)
        out_b = b.process_blocks(blocks)
        np.testing.assert_allclose(
            np.asarray(out_b.powers), np.asarray(out_a.powers),
            rtol=2e-5, atol=1e-12, err_msg=backend,
        )
        np.testing.assert_allclose(
            np.asarray(out_b.prev_max), np.asarray(out_a.prev_max),
            rtol=2e-5, err_msg=backend,
        )
        np.testing.assert_allclose(
            np.asarray(b.state.prev_max), np.asarray(a.state.prev_max),
            rtol=2e-5, err_msg=backend,
        )


def test_process_blocks_drives_mvdr_through_scan():
    """The adaptive estimators ride process_blocks as ONE on-device scan
    (models/mvdr.py _attach_scan) and match per-block stepping exactly."""
    cfg = Config(mimo=MimoConfig(rows=8, columns=8))
    pts = ant.create_antenna_grid()
    blocks = _blocks(pts, 6)
    kw = dict(points=pts, enable_tracker=False, enable_miso=False)

    for mode in ("mvdr", "music"):
        a = AwpuPipeline(cfg, heatmap_mode=mode, **kw)
        for b in blocks:
            a.process_block(b)
        b_pipe = AwpuPipeline(cfg, heatmap_mode=mode, **kw)
        b_pipe.process_blocks(np.stack(blocks))
        np.testing.assert_allclose(
            np.asarray(b_pipe._mvdr_powers), np.asarray(a._mvdr_powers),
            rtol=1e-5, atol=1e-30, err_msg=mode,
        )
        np.testing.assert_allclose(
            np.asarray(b_pipe._mvdr_state.cov_re),
            np.asarray(a._mvdr_state.cov_re), rtol=1e-6, atol=1e-12,
            err_msg=mode,
        )
        assert int(np.asarray(b_pipe._mvdr_state.count)) == 6


def test_heatmap_every_decimation_reuses_carried_powers():
    """MimoConfig.heatmap_every=k recomputes the heatmap on every k-th
    block (block_index % k == 0) and carries it in between; computed
    blocks match the every-block pipeline exactly, tracker/MISO unaffected."""
    import dataclasses

    cfg1 = Config(mimo=MimoConfig(rows=16, columns=16),
                  tracker=TrackerConfig(iterations=1))
    cfg2 = dataclasses.replace(
        cfg1, mimo=dataclasses.replace(cfg1.mimo, heatmap_every=2)
    )
    pts = ant.create_antenna_grid()
    blocks = _blocks(pts, 5)
    a = AwpuPipeline(cfg1, points=pts, seed=3)
    b = AwpuPipeline(cfg2, points=pts, seed=3)
    pa, pb, beams = [], [], []
    for blk in blocks:
        oa = a.process_block(blk)
        ob = b.process_block(blk)
        pa.append(np.asarray(oa.powers))
        pb.append(np.asarray(ob.powers))
        beams.append((np.asarray(oa.miso_beam), np.asarray(ob.miso_beam)))
    for i in (0, 2, 4):  # computed blocks
        np.testing.assert_allclose(pb[i], pa[i], rtol=1e-6, err_msg=str(i))
    for i in (1, 3):  # decimated blocks reuse the previous computation
        np.testing.assert_array_equal(pb[i], pb[i - 1])
        assert np.abs(pb[i] - pa[i]).max() > 0  # genuinely stale, not equal
    for ba, bb in beams:  # tracker/MISO path untouched by decimation
        np.testing.assert_allclose(bb, ba, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("heatmap_every", [0, 1, 3])
def test_process_blocks_matches_per_block_fused(heatmap_every):
    """The deployment profile's fused tracker+MISO step: one scanned
    dispatch (process_blocks) gives the per-block outputs of
    process_block, with the heatmap off (0), every block, and decimated."""
    import dataclasses

    base = Config(mimo=MimoConfig(rows=12, columns=12),
                  tracker=TrackerConfig(n_seekers=8, n_trackers=4,
                                        seeker_reset_interval=4)).realtime()
    cfg = dataclasses.replace(
        base, mimo=dataclasses.replace(base.mimo,
                                       heatmap_every=max(heatmap_every, 1)))
    blocks = np.stack(_blocks(ant.create_antenna_grid(), 7))
    kw = dict(seed=2, enable_mimo=heatmap_every > 0)
    a = AwpuPipeline(cfg, **kw)
    per_block = [a.process_block(b) for b in blocks]
    b = AwpuPipeline(cfg, **kw)
    stacked = b.process_blocks(blocks)
    for i, out in enumerate(per_block):
        np.testing.assert_allclose(
            np.asarray(stacked.powers[i]), np.asarray(out.powers),
            rtol=1e-5, atol=1e-12,
        )
        np.testing.assert_array_equal(
            np.asarray(stacked.targets.valid[i]), np.asarray(out.targets.valid)
        )
        np.testing.assert_allclose(
            np.asarray(stacked.targets.theta[i]),
            np.asarray(out.targets.theta), atol=1e-5,
        )
        scale = max(float(np.abs(np.asarray(out.miso_beam)).max()), 1e-12)
        np.testing.assert_allclose(
            np.asarray(stacked.miso_beam[i]) / scale,
            np.asarray(out.miso_beam) / scale, atol=1e-5,
        )
    assert int(np.asarray(b.state.block_index)) == len(blocks)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_realtime_profile_ignores_backend(monkeypatch, backend):
    """Config.realtime() is one profile whatever device JAX runs on."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = Config().realtime()
    assert cfg == Config().realtime()
    assert cfg.dsp.compute == cfg.dsp.probe_compute == "bfloat16"
    assert (cfg.mimo.backend, cfg.mimo.heatmap_every) == ("fft", 3)
    assert cfg.tracker.iterations == 2
