"""Run the beamformer's main path once on the GPU and check what it computes.

    python chip_smoke.py              # phases A-D on one card
    python chip_smoke.py --devices 4  # only the sharded paths, on four cards

Phases (each prints its measured error beside its tolerance; any failure
raises and the script exits non-zero):

A. North-star heatmap: 256 mics, 65x65 directions, 256-sample blocks,
   S = 64.  Dense f32 and bf16 against the loop reference
   (``tests/reference_impl.py``); the separable fft heatmap in f32 and in
   bf16 chunked 8 blocks per dispatch against the dense map's peak and the
   frequency-domain reference; device steering delays against the
   reference rotation.
B. The deployment step through the CLI (``--realtime``: 64 mics, 64x64
   fft heatmap every 3rd block, 16 seekers + 10 trackers, MISO), once
   block by block and once replayed 16 blocks per dispatch.
C. Config 3 through ``ControlUnit.process_batch``: two 128-mic arrays,
   65x65 fft bf16 heatmaps, tracker + MISO, triangulation.  Also times the
   tracker + MISO chain alone per block.
D. MVDR and MUSIC at 64 mics against complex NumPy references.

``--devices N`` runs only the fused step ``shard_map``ped over a (ch, dir)
mesh against the same step on card 0, and the bin-sharded MVDR against the
single-device MVDR.

Timings are smoke timings, printed beside the card name and power limit;
they are not benchmark numbers.  The last line of stdout is one JSON object
naming the device.  There is no CPU fallback: without a GPU the script
exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SOURCE_DEG = (20.0, 45.0, 5000.0)   # phase B's synthetic source
#: Relative-to-map-maximum tolerances.  f32 runs every product at HIGHEST
#: precision, so its error is f32 rounding over a 256 x 256-term sum;
#: bf16 rounds inputs to 8 mantissa bits (the repo's stated bf16 envelope,
#: DspConfig.compute).
TOL_F32 = 1e-4
TOL_BF16 = 5e-3
#: The bf16 fft heatmap rounds to bf16 at four cascaded matmul stages
#: (forward DFT, two steering stages, power), so its envelope is wider.
TOL_BF16_FFT = 2e-2


def check(phase: str, what: str, err: float, tol: float) -> None:
    """Print ``err`` beside ``tol``; raise if it is not within (NaN fails)."""
    ok = bool(err <= tol)
    print(f"{phase} {what}: {err:.3e} (tol {tol:.1e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"phase {phase}: {what} = {err} > {tol}")


def require_gpu(devices) -> None:
    """Refuse to run on anything but a GPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found platform {platform!r}"
        )


def card_info() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _cell_distance(cols: int, i: int, j: int) -> int:
    """Chebyshev distance in grid cells between flat pixel indices."""
    return max(abs(i // cols - j // cols), abs(i % cols - j % cols))


def _nearest_cell(theta, phi, src_theta: float, src_phi: float) -> int:
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    return int(np.argmin(np.asarray(
        spherical_angle(theta, phi, src_theta, src_phi))))


def _rel_to_max(got, want, scale) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(float(scale), 1e-30))


# --------------------------------------------------------------------------
# Phase A: north-star heatmap.


def phase_a(n_mics: int = 256, grid: int = 65, n_check: int = 256,
            seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig
    from beamforming_lk_tpu.io import ring as rg
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.ops import antenna as ant
    from beamforming_lk_tpu.ops import delay as dl
    from beamforming_lk_tpu.ops import fft_das as fd
    from tests import reference_impl as ref

    chunk, taps = 8, dl.LINEAR_TAPS
    arr = ArrayConfig()
    dsp = DspConfig(block_size=256, shift_range=64)
    t, s = dsp.block_size, dsp.shift_range
    mimo = MimoConfig(rows=grid, columns=grid)
    points = ant.multi_array_cluster(n_mics, arr.columns, arr.rows,
                                     arr.distance)
    c = points.shape[1]
    theta, phi = mm.make_mimo_grid(mimo)
    delays = ant.steering_delays_np(points, theta, phi, arr.samples_per_meter)
    assert delays.max() <= s - taps, delays.max()
    rng = np.random.default_rng(seed)
    src_cell = _nearest_cell(theta, phi, 0.5, 1.2)
    src = (float(theta[src_cell]), float(phi[src_cell]), 4000.0)
    check_dirs = np.unique(np.concatenate([
        rng.choice(theta.size, size=min(n_check, theta.size), replace=False),
        [src_cell],
    ]))

    # Steering delays on the device (they feed the tracker's probes) vs
    # the reference rotation, in samples.
    dev_delays = np.asarray(jax.jit(ant.steering_delays, static_argnums=3)(
        jnp.asarray(points), jnp.asarray(theta[check_dirs]),
        jnp.asarray(phi[check_dirs]), arr.samples_per_meter,
    ))
    want = np.stack([
        ref.steering_delays_ref(points, theta[d], phi[d],
                                arr.samples_per_meter)
        for d in check_dirs
    ])
    check("A", "steering delays max abs err [samples]",
          float(np.max(np.abs(dev_delays - want))), 1e-3)

    def stream(noise_std):
        """Histories after pushing chunk + 1 blocks: (1024-sample ring,
        chunk-sized ring)."""
        sig = np.concatenate([
            plane_wave_block(points, [src], b * t, t, arr,
                             noise_std=noise_std, rng=rng)
            for b in range(chunk + 1)
        ], axis=1)
        return (sig[:, -dsp.history:],
                sig[:, -(chunk * t + s + rg.LOOKAHEAD_GUARD):])

    hist_np, hist_chunk = stream(noise_std=0.5)
    window = rg.ring_window(jnp.asarray(hist_np), t, s, taps)
    windows = rg.ring_windows(jnp.asarray(hist_chunk), t, s, taps, chunk)

    # Dense stencil built on the device from the [D, C] delay table.
    weights = jax.jit(lambda d: dl.das_weights(d, s, "linear"))(
        jnp.asarray(delays))

    @jax.jit
    def dense_f32(win, w):
        return dl.das_power(dl.das_beam(win, w), divisor=t * c)

    @jax.jit
    def dense_bf16(win, w):
        beam = dl.das_beam(win.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           precision=jax.lax.Precision.DEFAULT)
        return dl.das_power(beam, divisor=t * c)

    p32 = np.asarray(dense_f32(window, weights), np.float64)
    p16 = np.asarray(dense_bf16(window, weights), np.float64)
    b0 = rg.block_start(dsp.history, t)
    hist64 = hist_np.astype(np.float64)
    want = np.array([
        ref.bandpass_power_ref(
            ref.das_ref(hist64, delays[d].astype(np.float64), b0, t),
            t, t * c)
        for d in check_dirs
    ])
    check("A", f"dense f32 vs das_ref ({len(check_dirs)} dirs), rel to max",
          _rel_to_max(p32[check_dirs], want, p32.max()), TOL_F32)
    check("A", f"dense bf16 vs das_ref ({len(check_dirs)} dirs), rel to max",
          _rel_to_max(p16[check_dirs], want, p16.max()), TOL_BF16)
    dense_peak = int(np.argmax(p32))
    check("A", "dense f32 peak, cells from source",
          _cell_distance(grid, dense_peak, src_cell), 1)

    # fft heatmaps: on noise they legitimately differ from the dense map
    # (exact sinc vs linear fractional delays reweight broadband noise), so
    # check their peaks on the noisy input and their powers on a noise-free
    # plane wave against the frequency-domain reference.
    m32 = fd.make_fft_heatmap_model(points, mimo, dsp, arr)
    m16 = fd.make_fft_heatmap_model(points, mimo, dsp, arr,
                                    compute="bfloat16")
    fft_f32 = jax.jit(lambda w: fd.fft_heatmap_powers(w, m32))
    fft_x8 = jax.jit(lambda ws: fd.fft_heatmap_powers_chunked(ws, m16))
    q32 = np.asarray(fft_f32(window))
    q16 = np.asarray(fft_x8(windows))
    for name, maps in (("fft f32", q32[None]), ("fft bf16 x8", q16)):
        peaks = maps.argmax(axis=-1)
        check("A", f"{name} peak, cells from source",
              max(_cell_distance(grid, int(k), src_cell)
                  for k in peaks), 1)
        check("A", f"{name} peak, cells from dense peak",
              _cell_distance(grid, int(peaks[-1]), dense_peak), 1)

    clean_np, clean_chunk = stream(noise_std=0.0)
    window_c = rg.ring_window(jnp.asarray(clean_np), t, s, taps)
    windows_c = rg.ring_windows(jnp.asarray(clean_chunk), t, s, taps, chunk)
    q32 = np.asarray(fft_f32(window_c), np.float64)
    q16 = np.asarray(fft_x8(windows_c), np.float64)
    # Corner pixels off the FOV disc copy their nearest on-disc pixel
    # (ops/fft_das.py), so the beam reference holds on the disc only.
    src_map = (np.arange(theta.size) if m32.src_map is None
               else np.asarray(m32.src_map))
    disc = check_dirs[src_map[check_dirs] == check_dirs]
    want32 = ref.fft_das_power_ref(np.asarray(window_c), delays[disc],
                                   s, t, taps)
    want16 = ref.fft_das_power_ref(np.asarray(windows_c), delays[disc],
                                   s, t, taps)
    check("A", f"fft f32 vs frequency-domain ref ({len(disc)} dirs, "
               "noise-free), rel to max",
          _rel_to_max(q32[disc], want32, want32.max()), TOL_F32)
    check("A", f"fft bf16 x8 vs frequency-domain ref ({len(disc)} dirs, "
               "noise-free), rel to max",
          _rel_to_max(q16[:, disc], want16, want16.max()), TOL_BF16_FFT)
    # The dense kernel's 2-tap linear interpolation loses a few per cent of
    # a 4 kHz tone's power against the exact sinc delays: 10 % bounds it.
    p32c = np.asarray(dense_f32(window_c, weights), np.float64)
    check("A", "fft f32 / dense f32 at the source (noise-free), |ratio-1|",
          abs(q32[src_cell] / p32c[src_cell] - 1.0), 0.1)


# --------------------------------------------------------------------------
# Phase B: the deployment step through the CLI.


def _cli_checks(name, unit, src_theta, src_phi):
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    pipe = unit.pipelines[0]
    targets = pipe.targets()
    ang = min((math.degrees(float(spherical_angle(
        tg["theta"], tg["phi"], src_theta, src_phi))) for tg in targets),
        default=math.inf)
    check("B", f"{name}: nearest published target to source [deg]", ang, 3.0)
    theta, phi = mm.make_mimo_grid(pipe.cfg.mimo)
    powers = np.asarray(pipe.last.powers)
    check("B", f"{name}: heatmap peak, cells from source",
          _cell_distance(pipe.cfg.mimo.columns, int(np.argmax(powers)),
                         _nearest_cell(theta, phi, src_theta, src_phi)), 1)
    beam = np.asarray(pipe.last.miso_beam)
    check("B", f"{name}: MISO beam non-finite samples",
          int(np.sum(~np.isfinite(beam))), 0)
    check("B", f"{name}: MISO beam all zero", int(not np.any(beam)), 0)
    return powers, beam, targets


def phase_b(n_blocks: int = 384, batch: int = 16, mimo_res: int = 64,
            warm: int = 8) -> dict:
    from beamforming_lk_tpu.app import cli

    argv = ["--mimo", "--tracking", "--miso", "--realtime",
            "--synthetic-source", *(str(v) for v in SOURCE_DEG),
            "--blocks", str(n_blocks), "--mimo-res", str(mimo_res)]
    live, _ = cli.run(argv)
    replay, _ = cli.run(argv + ["--replay-batch", str(batch)])
    src_theta, src_phi = (math.radians(v) for v in SOURCE_DEG[:2])
    p_live, b_live, t_live = _cli_checks("live", live, src_theta, src_phi)
    p_rep, b_rep, t_rep = _cli_checks("replay", replay, src_theta, src_phi)

    # Per-block and scanned programs are compiled separately, so sums may
    # round differently; over hundreds of blocks the bf16 probe chain can
    # move a tracker by a fraction of a probe spread.
    check("B", "replay vs live: final heatmap, rel to max",
          _rel_to_max(p_rep, p_live, p_live.max()), 1e-3)
    check("B", "replay vs live: MISO beam, rel to max",
          _rel_to_max(b_rep, b_live, np.abs(b_live).max()), 5e-2)

    def strongest(targets):
        return max(targets, key=lambda tg: tg["power"])

    from beamforming_lk_tpu.ops.geometry import spherical_angle

    a, b = strongest(t_live), strongest(t_rep)
    check("B", "replay vs live: strongest target [deg]",
          math.degrees(float(spherical_angle(a["theta"], a["phi"],
                                             b["theta"], b["phi"]))), 0.5)

    lat = np.asarray(list(live.metrics.latencies)[warm:]) * 1e3
    rep = np.asarray(list(replay.metrics.latencies)[1:])
    return {
        "live_blocks": int(lat.size),
        "live_p50_ms": float(np.percentile(lat, 50)),
        "live_p99_ms": float(np.percentile(lat, 99)),
        "replay_blocks_per_s": float(1.0 / rep.mean()),
        "replay_batch": batch,
    }


# --------------------------------------------------------------------------
# Phase C: config 3 through ControlUnit.process_batch.


def phase_c(channels: int = 128, grid: int = 65, n_batches: int = 6,
            batch: int = 24, chain_blocks: int = 384) -> dict:
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.app.control import ControlUnit
    from beamforming_lk_tpu.config import (
        Config, DspConfig, MimoConfig, TrackerConfig,
    )
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.models.fusion import target_rays, triangulate_rays
    from beamforming_lk_tpu.ops import antenna as ant
    from beamforming_lk_tpu.ops.geometry import cartesian_to_spherical

    cfg = Config(
        dsp=DspConfig(compute="bfloat16", probe_compute="bfloat16"),
        mimo=MimoConfig(rows=grid, columns=grid, backend="fft",
                        heatmap_every=3),
        tracker=TrackerConfig(iterations=2),
    )
    positions = [np.array([-1.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])]
    unit = ControlUnit(cfg, n_arrays=2, enable_tracker=True,
                       enable_miso=True, channels=channels,
                       array_positions=positions)
    check("C", "fusion inactive", int(unit.fusion is None), 0)
    target = np.array([0.3, 0.2, 5.0])
    rng = np.random.default_rng(3)
    streams = []
    for pipe, pos in zip(unit.pipelines, positions):
        d = target - pos
        th, ph, _ = (float(v) for v in
                     np.asarray(cartesian_to_spherical(d / np.linalg.norm(d))))
        streams.append(np.stack([
            plane_wave_block(pipe.points, [(th, ph, 4500.0)], b * 256, 256,
                             cfg.array, noise_std=0.02, rng=rng)
            for b in range(n_batches * batch)
        ]))
    times = []
    outs = None
    for k in range(n_batches):
        sl = slice(k * batch, (k + 1) * batch)
        t0 = time.perf_counter()
        outs = unit.process_batch([s[sl] for s in streams],
                                  now=k * batch * cfg.dsp.block_seconds)
        times.append(time.perf_counter() - t0)
    for i, o in enumerate(outs):
        bad = sum(int(np.sum(~np.isfinite(np.asarray(x))))
                  for x in (o.powers, o.miso_beam, o.prev_max,
                            o.targets.theta, o.targets.phi))
        check("C", f"array {i}: non-finite outputs", bad, 0)
    check("C", "fusion holds no valid track",
          int(not unit.fusion.store.valid_tracks()), 0)
    # A seeker promoted onto a sidelobe adds a spurious target whose pairs
    # the track store's 1 m merge box can fold into the true track, so
    # check the triangulation of the published targets directly.
    (o1, d1), (o2, d2) = (target_rays(p.targets(), pos)
                          for p, pos in zip(unit.pipelines, positions))
    pts, valid = triangulate_rays(
        np.repeat(o1, len(o2), axis=0), np.repeat(d1, len(o2), axis=0),
        np.tile(o2, (len(o1), 1)), np.tile(d2, (len(o1), 1)),
        cfg.triangulation,
    )
    err = min((float(np.linalg.norm(p - target))
               for p in np.asarray(pts)[np.asarray(valid)]), default=math.inf)
    check("C", "nearest triangulated target pair to target [m]", err, 0.1)

    # The tracker + MISO chain alone (no heatmap) at the 64-mic deployment
    # profile, per block, through one scanned dispatch.
    rt = Config().realtime()
    pts = ant.create_antenna_grid()
    step = make_awpu_step(pts, rt, enable_mimo=False)
    state = awpu_init(rt, pts.shape[1], seed=0)
    blocks = jax.device_put(jnp.asarray(np.stack([
        plane_wave_block(pts, [(0.5, 1.2, 4500.0)], b * 256, 256,
                         rt.array, noise_std=0.02, rng=rng)
        for b in range(chain_blocks)
    ])))
    jax.block_until_ready(step.scan(state, blocks))
    chain = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(step.scan(state, blocks))
        chain.append((time.perf_counter() - t0) / chain_blocks)
    # unit.metrics times the two pipelines' dispatches up to their sync;
    # the rest of each process_batch call is host-side fusion.
    dispatch = np.asarray(list(unit.metrics.latencies)[1:]) * batch
    return {
        "config3_blocks_per_s": float(batch * (n_batches - 1)
                                      / sum(times[1:])),
        "config3_pipelines_blocks_per_s": float(batch * dispatch.size
                                                / dispatch.sum()),
        "config3_batch": batch,
        "chain_us_per_block": float(np.median(chain) * 1e6),
    }


# --------------------------------------------------------------------------
# Phase D: adaptive estimators.


def phase_d(n_mics: int = 64, grid: int = 32, n_blocks: int = 6) -> None:
    import jax.numpy as jnp

    from beamforming_lk_tpu.config import ArrayConfig, MimoConfig
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.models.music import make_music_step
    from beamforming_lk_tpu.models.mvdr import make_mvdr_step
    from beamforming_lk_tpu.ops import antenna as ant
    from tests import reference_impl as ref

    arr = ArrayConfig()
    points = ant.multi_array_cluster(n_mics, arr.columns, arr.rows,
                                     arr.distance)
    theta, phi = mm.make_mimo_grid(MimoConfig(rows=grid, columns=grid))
    rng = np.random.default_rng(5)
    sources = [(0.5, 1.2, 4000.0), (0.9, 4.0, 3000.0, 0.7)]
    blocks = [plane_wave_block(points, sources, b * 256, 256, arr,
                               noise_std=0.05, rng=rng)
              for b in range(n_blocks)]
    args = (points, theta, phi, arr.samples_per_meter, arr.sample_rate)

    def run(step):
        state = step.init()
        for blk in blocks:
            state, out = step(state, jnp.asarray(blk))
        return np.asarray(out, np.float64)

    # The Capon solve amplifies covariance error by the loaded covariance's
    # condition number; f32 at HIGHEST lands near 1e-4 of the maximum.
    got = run(make_mvdr_step(points, theta, phi, arr)[0])
    want = ref.capon_ref(blocks, *args)
    check("D", "MVDR vs complex Capon, rel to max",
          _rel_to_max(got, want, want.max()), 2e-3)
    check("D", "MVDR peak, cells from reference peak",
          _cell_distance(grid, int(got.argmax()), int(want.argmax())),
          0)
    # MUSIC's streaming solver tracks the signal subspace by warm-started
    # orthogonal iteration, and near the peaks its complement identity
    # cancels; compare the normalized spectrum on the log scale.
    got = run(make_music_step(points, theta, phi, arr)[0])
    want = ref.music_ref(blocks, *args)
    check("D", "MUSIC vs complex eigh MUSIC, max |log10 ratio|",
          float(np.max(np.abs(np.log10(got / got.max())
                              - np.log10(want / want.max())))), 0.1)
    check("D", "MUSIC peak, cells from reference peak",
          _cell_distance(grid, int(got.argmax()), int(want.argmax())),
          0)


# --------------------------------------------------------------------------
# --devices N: the sharded paths against one device.


def phase_sharded(n_devices: int = 4, n_mics: int = 256, grid: int = 65,
                  n_blocks: int = 3) -> None:
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import Config, MimoConfig, TrackerConfig
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.models.mvdr import (
        make_mvdr_step, make_sharded_mvdr_step,
    )
    from beamforming_lk_tpu.ops import antenna as ant
    from beamforming_lk_tpu.parallel import mesh as pm

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise SystemExit(f"--devices {n_devices}: JAX sees {len(devices)}")
    cfg = Config(mimo=MimoConfig(rows=grid, columns=grid),
                 tracker=TrackerConfig(iterations=2))
    points = ant.multi_array_cluster(n_mics)
    c = points.shape[1]
    rng = np.random.default_rng(11)
    blocks = [jnp.asarray(plane_wave_block(points, [(0.5, 1.2, 4500.0)],
                                           b * 256, 256, cfg.array,
                                           noise_std=0.02, rng=rng))
              for b in range(n_blocks)]

    # Fused step: channels split over `ch`; a 65x65 grid (4225, odd) only
    # splits over a dir axis of 1, so the mesh is (n, 1).
    n_dir = math.gcd(n_devices, cfg.mimo.n_directions)
    mesh = pm.make_mesh((n_devices // n_dir, n_dir), devices=devices)
    one = make_awpu_step(points, cfg)
    sharded = make_awpu_step(points, cfg, mesh=mesh)
    s1 = awpu_init(cfg, c, seed=3)
    sn = awpu_init(cfg, c, mesh=mesh, seed=3)
    for blk in blocks:
        s1, o1 = one(s1, jax.device_put(blk, devices[0]))
        sn, on = sharded(sn, blk)
    mesh_desc = dict(zip(mesh.axis_names, mesh.devices.shape))
    p1 = np.asarray(o1.powers)
    # psum's reduction order differs from the one-device sum.
    check("S", f"fused step {mesh_desc} vs card 0: heatmap, rel to max",
          _rel_to_max(on.powers, p1, p1.max()), 2e-4)
    b1 = np.asarray(o1.miso_beam)
    check("S", "fused step: MISO beam, rel to max",
          _rel_to_max(on.miso_beam, b1, np.abs(b1).max()), 2e-3)
    check("S", "fused step: tracker flags differing",
          int(np.sum(np.asarray(on.targets.valid)
                     != np.asarray(o1.targets.valid))), 0)
    check("S", "fused step: tracker theta max abs err [rad]",
          float(np.max(np.abs(np.asarray(on.targets.theta)
                              - np.asarray(o1.targets.theta)))), 1e-3)

    theta, phi = mm.make_mimo_grid(cfg.mimo)
    bin_mesh = pm.make_mesh((1, n_devices), devices=devices)
    step1, _ = make_mvdr_step(points, theta, phi, cfg.array)
    stepn, staten = make_sharded_mvdr_step(points, theta, phi, bin_mesh)
    state1 = step1.init()
    for blk in blocks:
        state1, q1 = step1(state1, jax.device_put(blk, devices[0]))
        staten, qn = stepn(staten, blk)
    q1 = np.asarray(q1, np.float64)
    check("S", f"bin-sharded MVDR over {n_devices} vs card 0, rel to max",
          _rel_to_max(qn, q1, q1.max()), 5e-4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1,
                        help="run only the sharded paths over this many "
                             "cards (default: phases A-D on one card)")
    args = parser.parse_args(argv)

    from beamforming_lk_tpu.utils.compile_cache import use_compile_cache

    cache_dir = use_compile_cache()
    import jax

    require_gpu(jax.devices())
    card = card_info()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r};"
          f" compile cache {cache_dir}; devices {jax.devices()}", flush=True)
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"{name} done in {time.perf_counter() - t0:.1f} s "
              "(compilation included)", flush=True)
        return out

    if args.devices > 1:
        timed("sharded", phase_sharded, args.devices)
    else:
        timed("A", phase_a)
        b = timed("B", phase_b)
        c = timed("C", phase_c)
        timed("D", phase_d)
        print(f"B timing [{card}] (smoke, not a benchmark): live per-block "
              f"latency p50 {b['live_p50_ms']} ms, p99 {b['live_p99_ms']} ms "
              f"over {b['live_blocks']} blocks; replay "
              f"{b['replay_blocks_per_s']} blocks/s at "
              f"{b['replay_batch']} blocks/dispatch", flush=True)
        print(f"C timing [{card}] (smoke, not a benchmark): config 3 "
              f"{c['config3_blocks_per_s']} blocks/s per array at "
              f"{c['config3_batch']} blocks/dispatch with fusion, "
              f"{c['config3_pipelines_blocks_per_s']} blocks/s for the two "
              "pipelines' dispatches alone; tracker + MISO chain "
              f"{c['chain_us_per_block']} us/block (64 mics, realtime "
              "profile, no heatmap)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
