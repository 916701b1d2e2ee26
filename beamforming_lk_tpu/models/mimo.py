"""MIMO heatmap model: full-grid delay-and-sum power maps.

Re-design of the reference's ``MIMOWorker`` (``src/dsp/mimo.cpp``): the
per-pixel scalar loop over ``rows*cols`` directions x 64 mics x 256 samples
(mimo.cpp:121-151) becomes one precomputed stencil tensor and a single
matmul per block via :mod:`beamforming_lk_tpu.ops.delay`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl


def make_mimo_grid(cfg: MimoConfig):
    """Direction grid for the heatmap, shape ([R*C], [R*C]) of (theta, phi).

    Pixel (r, c) maps to (x, y) on the sin-projected field-of-view disc and
    then to spherical angles — the exact construction of
    ``MIMOWorker::computeDelayLUT`` (mimo.cpp:20-59), vectorized.  Pixels
    outside the unit disc are clamped onto it (``norm > 1 -> 1``), again as
    the reference does.
    """
    fov = np.radians(cfg.fov_degrees)
    rows, cols = cfg.rows, cfg.columns
    sep_r = np.sin(fov / 2.0) / (rows / 2.0)
    sep_c = np.sin(fov / 2.0) / (cols / 2.0)
    r = np.arange(rows, dtype=np.float64)
    c = np.arange(cols, dtype=np.float64)
    y = r * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
    x = c * sep_c - cols * sep_c / 2.0 + sep_c / 2.0
    yy, xx = np.meshgrid(y, x, indexing="ij")   # [rows, cols]
    norm = np.hypot(xx, yy)
    theta = np.arcsin(np.minimum(norm, 1.0))
    # Odd-sized grids place a pixel exactly at the disc center (norm == 0);
    # that pixel is boresight, where phi is arbitrary — use 0 instead of the
    # reference's 0/0 (mimo.cpp:36-43, which never sees this because its
    # default sizes are even).
    safe = np.maximum(norm, 1e-30)
    phi = np.where(norm > 0.0, np.arctan2(yy / safe, xx / safe), 0.0)
    return theta.reshape(-1).astype(np.float32), phi.reshape(-1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MimoModel:
    """Precomputed state for heatmap beamforming (the delay LUT analog)."""

    weights: jax.Array          # [D, C, S] DAS stencil
    theta: np.ndarray           # [D]
    phi: np.ndarray             # [D]
    rows: int
    columns: int
    shift_range: int
    taps: int
    use_bandpass: bool = True


def make_mimo_model(
    points,
    mimo_cfg: MimoConfig,
    dsp_cfg: DspConfig,
    array_cfg: ArrayConfig,
    channel_mask=None,
    fir_bank=None,
) -> MimoModel:
    """Build the static per-direction DAS stencil for the heatmap grid
    (the analog of ``computeDelayLUT``, mimo.cpp:20-59)."""
    theta, phi = make_mimo_grid(mimo_cfg)
    # Static LUT: build entirely on host (numpy) and device_put once — no
    # per-op eager dispatches at build time.
    delays = ant.steering_delays_np(
        np.asarray(points), theta, phi, array_cfg.samples_per_meter
    )
    mode = dsp_cfg.interp
    taps = dl.LINEAR_TAPS if mode == "linear" else dsp_cfg.fir_taps
    if mode == "fir" and fir_bank is None:
        fir_bank = dl.fractional_delay_fir_bank(dsp_cfg.fir_phases, dsp_cfg.fir_taps)
    weights = dl.das_weights_np(delays, dsp_cfg.shift_range, mode, fir_bank)
    if channel_mask is not None:
        weights = weights * np.asarray(channel_mask, weights.dtype)[:, None]
    return MimoModel(
        weights=jax.device_put(weights),
        theta=theta,
        phi=phi,
        rows=mimo_cfg.rows,
        columns=mimo_cfg.columns,
        shift_range=dsp_cfg.shift_range,
        taps=taps,
        use_bandpass=dsp_cfg.use_bandpass,
    )


def mimo_power(window, model: MimoModel, n_active: Optional[float] = None):
    """Heatmap powers [D] for one block window [C, T + S].

    Normalized by ``T * n_active`` as in the reference (mimo.cpp:137).
    """
    beam = dl.das_beam(window, model.weights)
    t = beam.shape[-1]
    if n_active is None:
        n_active = model.weights.shape[-2]
    return dl.das_power(
        beam, use_bandpass=model.use_bandpass, divisor=t * n_active
    )


def render_heatmap(power, rows: int, columns: int, prev_power, ema_alpha=0.2,
                   use_db: bool = False):
    """Powers [D] -> uint8 heatmap [rows, cols] + updated EMA state.

    Mirrors ``MIMOWorker::populateHeatmap`` (mimo.cpp:61-95): per-frame
    max normalization to [0, 255]; the running EMA of the frame max is
    carried as state exactly as the reference does.  ``use_db`` applies a
    well-defined log mapping (the reference's USE_DB branch saturates for
    any normalized value above 1e-4 — mimo.cpp:81-84 — so we use
    ``20*log10`` over a 60 dB window instead; documented deviation).
    """
    power = jnp.asarray(power)
    max_v = jnp.max(power)
    min_v = jnp.min(power)
    new_prev = max_v * ema_alpha + (1.0 - ema_alpha) * prev_power
    if use_db:
        norm = (power - min_v) / jnp.maximum(max_v - min_v, 1e-30)
        db = 20.0 * jnp.log10(jnp.maximum(norm, 1e-30))
        scaled = (db + 60.0) / 60.0 * 255.0
    else:
        scaled = power / jnp.maximum(max_v, 1e-30) * 255.0
    img = jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8).reshape(rows, columns)
    return img, new_prev
