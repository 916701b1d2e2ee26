"""9-state constant-acceleration Kalman filter (pos/vel/acc x xyz).

Functional jnp port of the reference's header-only ``KalmanFilter3D``
(``src/geometry/kf.h:22-154``), used to smooth/lead the best tracker in the
heatmap UI (gradient_ascend.cpp:242-246).  State is an explicit pytree so
the filter composes into jitted steps and batches with ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

# float32 products at full precision (no TF32 rounding on the GPU).
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


class KalmanState(NamedTuple):
    x: jnp.ndarray  # [9] state (pos, vel, acc interleaved by axis groups)
    p: jnp.ndarray  # [9, 9] covariance


def _model_matrices(dt: float):
    """A, Q, H, R exactly as kf.h:34-83 (sj = rp = 1)."""
    dt2, dt3, dt4, dt5, dt6 = dt**2, dt**3, dt**4, dt**5, dt**6
    a = np.eye(9, dtype=np.float32)
    for i in range(3):
        a[i, i + 3] = dt
        a[i, i + 6] = dt2 / 2.0
        a[i + 3, i + 6] = dt
    q = np.zeros((9, 9), np.float32)
    for i in range(3):
        q[i, i] = dt6 / 36
        q[i, i + 3] = q[i + 3, i] = dt5 / 12
        q[i, i + 6] = q[i + 6, i] = dt4 / 6
        q[i + 3, i + 3] = dt4 / 4
        q[i + 3, i + 6] = q[i + 6, i + 3] = dt3 / 2
        q[i + 6, i + 6] = dt2
    h = np.zeros((3, 9), np.float32)
    h[:3, :3] = np.eye(3)
    r = np.eye(3, dtype=np.float32)
    return a, q, h, r


class KalmanFilter3D:
    """Thin functional wrapper: holds the (static) model matrices."""

    def __init__(self, dt: float):
        a, q, h, r = _model_matrices(dt)
        self.a = jnp.asarray(a)
        self.q = jnp.asarray(q)
        self.h = jnp.asarray(h)
        self.r = jnp.asarray(r)

    def init(self) -> KalmanState:
        return KalmanState(x=jnp.zeros(9, jnp.float32), p=jnp.eye(9, dtype=jnp.float32))

    def update(self, state: KalmanState, measurement) -> KalmanState:
        """Predict + correct (kf.h:85-98)."""
        a, q, h, r = self.a, self.q, self.h, self.r
        x = _mm(a, state.x)
        p = _mm(_mm(a, state.p), a.T) + q
        s = _mm(_mm(h, p), h.T) + r
        k = _mm(_mm(p, h.T), jnp.linalg.inv(s))
        y = jnp.asarray(measurement, jnp.float32) - _mm(h, x)
        x = x + _mm(k, y)
        p = _mm(jnp.eye(9, dtype=jnp.float32) - _mm(k, h), p)
        return KalmanState(x=x, p=p)

    def position(self, state: KalmanState):
        return state.x[:3]

    def velocity(self, state: KalmanState):
        return state.x[3:6]

    def predict(self, state: KalmanState, steps: int):
        """Forward-extrapolate N steps with the reference's accumulating
        transition (kf.h:107-118: ``xn = An xn; An = An A`` — the applied
        powers of A grow triangularly, reproduced for parity)."""
        xn = state.x
        an = self.a
        for _ in range(int(steps)):
            xn = _mm(an, xn)
            an = _mm(an, self.a)
        return xn[:3]

    def predict_time(self, state: KalmanState, t: float):
        """Fractional-step extrapolation (kf.h:120-153).  In the reference,
        ``xp`` is assigned on the loop's final iteration so it always equals
        ``xn`` and the trailing interpolation is a no-op; the effective
        behavior — ``floor(t) + 1`` accumulating steps — is what we
        implement.  Only ``predict(0)`` (one plain A step) is exercised by
        the reference UI (gradient_ascend.cpp:243)."""
        if t > 10:
            return self.position(state)
        xn = state.x
        an = self.a
        for _ in range(int(t) + 1):
            xn = _mm(an, xn)
            an = _mm(an, self.a)
        return xn[:3]
