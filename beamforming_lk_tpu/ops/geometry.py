"""Spherical / horizontal / Cartesian geometry, fully vectorized in jnp.

Semantics mirror the reference's coordinate conventions
(``src/geometry/geometry.{h,cpp}``): physics convention with theta the
inclination from the +Z boresight (theta in [0, pi/2] inside the field of
view) and phi the azimuth from +X.  All functions broadcast over leading
batch dimensions so a whole grid or particle swarm is one call — there are
no scalar loops anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PI_HALF = np.pi / 2.0


def wrap_angle(angle):
    """Wrap an angle to [0, 2*pi).  (reference: geometry.cpp:11-20)"""
    return jnp.mod(angle, 2.0 * np.pi)


def smallest_angle(target, current):
    """Signed smallest difference between two angles.
    (reference: geometry.cpp:22-24)"""
    d = target - current
    return jnp.arctan2(jnp.sin(d), jnp.cos(d))


def spherical_to_cartesian(theta, phi, radius=1.0):
    """Unit-sphere direction -> xyz, stacked on a trailing axis of size 3.
    (reference: geometry.cpp:29-37)"""
    theta, phi = jnp.broadcast_arrays(jnp.asarray(theta), jnp.asarray(phi))
    st = jnp.sin(theta)
    return jnp.stack(
        [radius * st * jnp.cos(phi), radius * st * jnp.sin(phi), radius * jnp.cos(theta)],
        axis=-1,
    )


def cartesian_to_spherical(xyz):
    """xyz[..., 3] -> (theta, phi, radius).  (reference: geometry.cpp:62-66)"""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    radius = jnp.sqrt(x * x + y * y + z * z)
    theta = jnp.arccos(jnp.clip(z / jnp.maximum(radius, 1e-12), -1.0, 1.0))
    phi = jnp.arctan2(y, x)
    return theta, phi, radius


def horizontal_to_spherical(azimuth, elevation):
    """(azimuth, elevation) -> (theta, phi).  (reference: geometry.cpp:47-60)"""
    x = jnp.sin(azimuth)
    y = jnp.sin(elevation)
    phi = jnp.arctan2(y, x)
    flipped_theta = PI_HALF - elevation
    z_height = jnp.sin(flipped_theta) * jnp.cos(azimuth)
    theta = PI_HALF - jnp.arcsin(jnp.clip(z_height, -1.0, 1.0))
    return theta, phi


def spherical_angle(theta1, phi1, theta2, phi2):
    """Geodesic angle between two directions.  (reference: geometry.cpp:109-118)"""
    s1 = jnp.sin(PI_HALF - theta1)
    s2 = jnp.sin(PI_HALF - theta2)
    c1 = jnp.cos(PI_HALF - theta1)
    c2 = jnp.cos(PI_HALF - theta2)
    return jnp.arccos(jnp.clip(s1 * s2 + c1 * c2 * jnp.cos(phi1 - phi2), -1.0, 1.0))


def spherical_chord_distance(theta1, phi1, theta2, phi2):
    """Chord distance between unit directions.  (reference: geometry.cpp:42-45)"""
    inner = (
        jnp.sin(theta1) * jnp.sin(theta2) * jnp.cos(phi1 - phi2)
        + jnp.cos(theta1) * jnp.cos(theta2)
    )
    return jnp.sqrt(jnp.maximum(2.0 - 2.0 * inner, 0.0))


def rotation_z(angle):
    """Batched Z-axis rotation matrices [..., 3, 3].
    (reference: geometry.cpp:219-225)"""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero], axis=-1),
            jnp.stack([s, c, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def rotation_y(angle):
    """Batched Y-axis rotation matrices [..., 3, 3].
    (reference: geometry.cpp:227-233)"""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, zero, s], axis=-1),
            jnp.stack([zero, one, zero], axis=-1),
            jnp.stack([-s, zero, c], axis=-1),
        ],
        axis=-2,
    )


def normalize_spherical(theta, phi, theta_limit):
    """Clamp theta to [0, limit], wrap phi to [0, 2*pi).
    (reference: particle.h:24-27)"""
    return jnp.clip(theta, 0.0, theta_limit), wrap_angle(phi)


def _edge_adjust(theta, spread):
    """FoV-edge handling shared by all probe generators: when the current
    direction is within ``spread`` of the horizon the reference both backs
    off the rotation angle and nudges the particle's own theta inward by
    ``spread/2`` (geometry.cpp:159-165); callers apply the returned
    adjusted theta."""
    near_edge = theta + spread > PI_HALF
    rotate_theta = jnp.where(near_edge, theta - spread, theta)
    adjusted_theta = jnp.where(near_edge, theta - spread / 2.0, theta)
    return rotate_theta, adjusted_theta


def _rotated_probes(base_phis_deg, theta, phi, spread):
    """Probe ring *centered on the steered direction* (theta, phi).

    Place 4 probe points at inclination ``spread`` around +Z with azimuths
    ``base_phis_deg``, rotate +Z onto the current direction with
    ``Rz(phi) @ Ry(theta)``, and read spherical angles back.

    This deliberately deviates from the reference's
    ``Spherical::quadrant``/``nearby`` (geometry.cpp:144-217), which rotates
    row-vectors by ``Ry(theta) @ Rz(phi)`` and subtracts pi from the
    read-back azimuth — netting probes centered on (theta, -phi), i.e.
    azimuth-mirrored AWAY from where the particle's beam points.  Monopulse
    gradients built on those probes only point at the source near phi = 0;
    the self-consistent version here converges everywhere.  The
    reference-exact construction is kept as
    :func:`quadrant_probes_reference` and pinned by a parity test.

    Returns (probe_theta[..., 4], probe_phi[..., 4], adjusted_theta[...]).
    """
    theta = jnp.asarray(theta, jnp.float32)
    phi = jnp.asarray(phi, jnp.float32)
    spread = jnp.asarray(spread, jnp.float32)   # scalar or [...] per particle
    base_phi = jnp.deg2rad(jnp.asarray(base_phis_deg, jnp.float32))
    # [..., 4, 3]; [4, 3] for scalar spread
    base = spherical_to_cartesian(
        spread[..., None] * jnp.ones_like(base_phi), base_phi
    )

    rotate_theta, adjusted_theta = _edge_adjust(theta, spread)
    rot = jnp.matmul(
        rotation_z(phi), rotation_y(rotate_theta),
        precision=jax.lax.Precision.HIGHEST,
    )                                                         # [..., 3, 3]
    rotated = jnp.einsum(
        "...ij,...pj->...pi", rot, base, precision=jax.lax.Precision.HIGHEST
    )
    probe_theta = jnp.arccos(jnp.clip(rotated[..., 2], -1.0, 1.0))
    probe_phi = jnp.arctan2(rotated[..., 1], rotated[..., 0])
    return probe_theta, probe_phi, adjusted_theta


def quadrant_probes(theta, phi, spread):
    """4 diagonal monopulse probes (q1..q4 at 45/315/225/135 degrees),
    centered on the steered direction (see :func:`_rotated_probes` for the
    deliberate deviation from geometry.cpp:181-217)."""
    return _rotated_probes((45.0, 315.0, 225.0, 135.0), theta, phi, spread)


def nearby_probes(theta, phi, spread):
    """N/E/S/W monopulse probes (geometry.cpp:144-179, re-centered)."""
    return _rotated_probes((0.0, 90.0, 180.0, 270.0), theta, phi, spread)


def quadrant_probes_reference(theta, phi, spread):
    """Bit-faithful port of ``Spherical::quadrant`` (geometry.cpp:181-217),
    including its azimuth mirror — kept for parity testing against the
    reference; the framework's dynamics use :func:`quadrant_probes`."""
    theta = jnp.asarray(theta, jnp.float32)
    phi = jnp.asarray(phi, jnp.float32)
    base_phi = jnp.deg2rad(jnp.asarray((45.0, 315.0, 225.0, 135.0), jnp.float32))
    base = spherical_to_cartesian(jnp.full_like(base_phi, spread), base_phi)

    rotate_theta, adjusted_theta = _edge_adjust(theta, spread)
    rot = jnp.matmul(
        rotation_y(rotate_theta), rotation_z(phi),
        precision=jax.lax.Precision.HIGHEST,
    )
    rotated = jnp.einsum(                                     # row-vector product
        "pi,...ij->...pj", base, rot, precision=jax.lax.Precision.HIGHEST
    )
    probe_theta = jnp.arccos(jnp.clip(rotated[..., 2], -1.0, 1.0))
    probe_phi = jnp.arctan2(rotated[..., 1], rotated[..., 0]) - np.pi
    return probe_theta, probe_phi, adjusted_theta
