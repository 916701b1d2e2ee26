"""Microphone auto-calibration: dead/hot channel masking + gain correction.

Vectorized re-design of ``AWProcessingUnit::calibrate``
(``src/aw_processing_unit/aw_processing_unit.cpp:102-212``): per-channel mean
power over a full ring of history, per-antenna median, outlier rejection,
and a power-correction gain.  Where the reference compacts surviving
channels into an ``index[]`` list (dynamic length), we emit a static-shape
validity mask that folds directly into the DAS stencil — the static-shape
equivalent (zeroed channels cost nothing extra in the matmul).

Note the reference computes ``power_correction_mask`` but never applies it
in any worker (SURVEY §2.1); we keep gains available and actually support
applying them.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass
class CalibrationResult:
    mask: jnp.ndarray      # [C] float32 validity (1 = usable)
    gains: jnp.ndarray     # [C] reference_power / channel_power (0 if masked)
    power: jnp.ndarray     # [C] measured mean power
    median: jnp.ndarray    # per-antenna median power, broadcast to [C]
    mean: jnp.ndarray      # mean power over usable channels, broadcast to [C]

    @property
    def usable(self):
        return jnp.sum(self.mask).astype(jnp.int32)


def calibrate(
    history,
    elements_per_antenna: int = 64,
    reference_power: float = 1.0,
    diff_threshold: float = 1e-4,
    low_ratio: float = 1e-3,
) -> CalibrationResult:
    """history: [C, H] snapshot (a full ring, as the reference waits for
    4 barriers before calibrating, aw_processing_unit.cpp:105-107).

    A channel survives iff ``|power - median| <= diff_threshold`` and
    ``power >= median * low_ratio`` (aw_processing_unit.cpp:161-179).
    """
    history = jnp.asarray(history)
    c = history.shape[0]
    if c % elements_per_antenna != 0:
        raise ValueError(f"{c} channels not divisible by {elements_per_antenna}")
    n_ant = c // elements_per_antenna

    power = jnp.mean(jnp.square(history), axis=-1)        # [C]
    grouped = power.reshape(n_ant, elements_per_antenna)  # [A, E]

    # Reference median: sort, then (sorted[E/2] + sorted[E/2 + 1]) / 2
    # (aw_processing_unit.cpp:149-151 — note the off-by-one vs the textbook
    # definition; reproduced for parity).
    s = jnp.sort(grouped, axis=-1)
    e = elements_per_antenna
    median = (s[:, e // 2] + s[:, e // 2 + 1]) / 2.0      # [A]
    median_b = jnp.repeat(median, e)                      # [C]

    ok = (jnp.abs(power - median_b) <= diff_threshold) & (
        power >= median_b * low_ratio
    )
    mask = ok.astype(jnp.float32)
    gains = jnp.where(ok, reference_power / jnp.maximum(power, 1e-30), 0.0)

    grouped_mask = mask.reshape(n_ant, e)
    usable = jnp.maximum(jnp.sum(grouped_mask, axis=-1), 1.0)
    mean = jnp.sum(grouped * grouped_mask, axis=-1) / usable
    return CalibrationResult(
        mask=mask,
        gains=gains,
        power=power,
        median=median_b,
        mean=jnp.repeat(mean, e),
    )
