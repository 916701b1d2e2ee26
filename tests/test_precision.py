"""Every float32 matrix product on the main path asks for HIGHEST precision.

Without it a GPU may run f32 products in TF32 (about 10 mantissa bits):
~1e-3 relative error on a 60-sample steering delay is 0.06 sample, and the
Capon solve amplifies covariance error by its condition number.  The check
reads the lowered StableHLO, so it holds on any backend.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beamforming_lk_tpu.app import awpu_init, make_awpu_step
from beamforming_lk_tpu.config import (
    ArrayConfig, Config, DspConfig, MimoConfig, TrackerConfig,
)
from beamforming_lk_tpu.models import mimo as mm
from beamforming_lk_tpu.models.kalman import KalmanFilter3D
from beamforming_lk_tpu.models.music import make_music_step
from beamforming_lk_tpu.models.mvdr import make_mvdr_step
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops import fft_das as fd
from beamforming_lk_tpu.ops import geometry as geo

ACFG = ArrayConfig()
PTS = ant.create_antenna_grid()
GRID = MimoConfig(rows=8, columns=8)
_DOT = re.compile(r"stablehlo\.dot_general.*?(precision = \[(\w+), (\w+)\])?"
                  r" : \((tensor<[^>]*>), (tensor<[^>]*>)\)")


def _awpu(backend):
    cfg = Config(mimo=MimoConfig(rows=8, columns=8, backend=backend),
                 tracker=TrackerConfig(n_seekers=4, n_trackers=2,
                                       iterations=2))
    step = make_awpu_step(PTS, cfg)
    block = jnp.zeros((64, cfg.dsp.block_size), jnp.float32)
    return step, (awpu_init(cfg, 64), block)


def _window():
    dsp = DspConfig()
    return jnp.zeros((64, dsp.shift_range + dsp.block_size), jnp.float32)


def _adaptive(make):
    theta, phi = mm.make_mimo_grid(GRID)
    step, _ = make(PTS, theta, phi, ACFG)
    return step, (step.init(), jnp.zeros((64, 256), jnp.float32))


CASES = {
    # Dense heatmap + fused tracker/MISO chain: the f32 parity step.
    "awpu_dense": lambda: _awpu("dense"),
    "awpu_fft": lambda: _awpu("fft"),
    "fft_heatmap": lambda: (
        lambda w: fd.fft_heatmap_powers(
            w, fd.make_fft_heatmap_model(PTS, GRID, DspConfig(), ACFG)),
        (_window(),),
    ),
    "steering": lambda: (
        lambda t, p: ant.steering_delays(PTS, t, p, ACFG.samples_per_meter),
        (jnp.zeros(5), jnp.zeros(5)),
    ),
    "probes": lambda: (
        lambda t, p: (geo.quadrant_probes(t, p, 0.1),
                      geo.nearby_probes(t, p, 0.1),
                      geo.quadrant_probes_reference(t, p, 0.1)),
        (jnp.zeros(5), jnp.zeros(5)),
    ),
    "fir_stencil": lambda: (
        lambda d: dl.das_weights(d, 64, "fir",
                                 dl.fractional_delay_fir_bank()),
        (jnp.zeros((5, 64)),),
    ),
    "mvdr": lambda: _adaptive(make_mvdr_step),
    "music_subspace": lambda: _adaptive(make_music_step),
    "music_eigh": lambda: _adaptive(
        lambda *a: make_music_step(*a, solver="eigh")),
    "kalman": lambda: (
        lambda s, z: (KalmanFilter3D(0.005).update(s, z),
                      KalmanFilter3D(0.005).predict(s, 2)),
        (KalmanFilter3D(0.005).init(), jnp.zeros(3)),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_products_ask_for_highest(name):
    fn, args = CASES[name]()
    text = jax.jit(fn).lower(*args).as_text()
    dots = [m.groups() for m in _DOT.finditer(text)]
    assert dots, f"{name}: no dot_general lowered"
    loose = [
        d for d in dots
        if "xf32>" in d[3] and "xf32>" in d[4]
        and (d[1], d[2]) != ("HIGHEST", "HIGHEST")
    ]
    assert not loose, f"{name}: f32 products below HIGHEST: {loose}"


def test_bf16_products_stay_default():
    """The bf16 paths keep DEFAULT: their inputs are already bf16."""
    cfg = Config(mimo=MimoConfig(rows=8, columns=8),
                 tracker=TrackerConfig(n_seekers=4, n_trackers=2)).realtime()
    step = make_awpu_step(PTS, cfg)
    block = jnp.zeros((64, cfg.dsp.block_size), jnp.float32)
    text = jax.jit(step).lower(awpu_init(cfg, 64), block).as_text()
    dots = [m.groups() for m in _DOT.finditer(text)]
    assert any("xbf16>" in d[3] for d in dots)
    assert all(
        (d[1], d[2]) == ("HIGHEST", "HIGHEST")
        for d in dots if "xf32>" in d[3] and "xf32>" in d[4]
    )
    np.testing.assert_equal(
        sorted({d[1] for d in dots if "xbf16>" in d[3]}), ["DEFAULT"]
    )
