"""Array model: element positions, steering vectors, dome grids.

Mirrors the semantics of the reference's ``src/geometry/antenna.{h,cpp}``
(physics convention, theta in [0, pi/2] from the +Z boresight), but computes
steering delays for arbitrarily large *batches* of directions in a single
matmul instead of rotating the point cloud per direction: for direction
(theta, phi) the reference rotates the points with ``Ry(-theta) @ Rz(phi)``
and takes the z row (antenna.cpp:99-107); the z row of that rotation is the
vector ``u = [sin(t)cos(p), -sin(t)sin(p), cos(t)]``, so delays for D
directions are simply ``(U[D, 3] @ points[3, N]) * fs/c``, min-subtracted per
direction (antenna.cpp:89-97).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.ops.geometry import horizontal_to_spherical

# Quadrant sector element indices of an 8x8 array for 4-sector monopulse
# (reference: antenna.h:32-50).  Kept as boolean masks over the 64 elements.
_SECTOR_LISTS = {
    0: [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23, 28, 29, 30, 31],
    1: [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 24, 25, 26, 27],
    2: [32, 33, 34, 35, 40, 41, 42, 43, 48, 49, 50, 51, 56, 57, 58, 59],
    3: [36, 37, 38, 39, 44, 45, 46, 47, 52, 53, 54, 55, 60, 61, 62, 63],
}


def sector_masks(elements: int = 64) -> np.ndarray:
    """[4, elements] boolean masks of the four quadrant sectors."""
    masks = np.zeros((4, elements), dtype=bool)
    for s, idx in _SECTOR_LISTS.items():
        masks[s, idx] = True
    return masks


def create_antenna_grid(
    columns: int = 8, rows: int = 8, distance: float = 0.02
) -> np.ndarray:
    """Planar grid element positions, shape [3, rows*columns], z = 0.

    Element id = r * columns + c, matching the reference's layout
    (antenna.cpp:60-87) including its centering convention (x centered with
    ``rows``, y with ``columns`` — identical for square arrays).
    """
    half = distance / 2.0
    c = np.arange(columns, dtype=np.float32)
    r = np.arange(rows, dtype=np.float32)
    x = c * distance - rows * half + half
    y = r * distance - columns * half + half
    xx, yy = np.meshgrid(x, y)  # [rows, columns]
    pts = np.stack(
        [xx.reshape(-1), yy.reshape(-1), np.zeros(rows * columns, np.float32)]
    )
    return pts.astype(np.float32)


def combine_arrays(grids, offsets) -> np.ndarray:
    """Concatenate several element grids placed at given xyz offsets.

    Extension: the reference only ever steers one 64-element
    array at a time (one ``Antenna`` per 64 sensors,
    aw_processing_unit.cpp:58-65); here multiple arrays can be fused into a
    single coherent aperture simply by concatenating channels.
    """
    placed = [
        np.asarray(g) + np.asarray(o, np.float32).reshape(3, 1)
        for g, o in zip(grids, offsets)
    ]
    return np.concatenate(placed, axis=1)


def multi_array_cluster(
    n_mics: int, columns: int = 8, rows: int = 8, distance: float = 0.02
) -> np.ndarray:
    """A compact near-square cluster of 8x8 arrays totalling ``n_mics``
    channels, side by side at array pitch — the coherent multi-array
    aperture (the reference only ever beamforms each 64-mic array
    separately, aw_processing_unit.cpp:58-65; this fuses them).  Keeps the aperture compact so min-subtracted steering delays
    stay small (the DAS shift span grows with aperture)."""
    g = create_antenna_grid(columns, rows, distance)
    e = columns * rows
    if n_mics % e:
        raise ValueError(f"{n_mics} not a multiple of {e}")
    n_arrays = n_mics // e
    if n_arrays == 1:
        return g
    side = int(np.ceil(np.sqrt(n_arrays)))
    pitch_x = columns * distance
    pitch_y = rows * distance
    offsets = [
        ((i % side) * pitch_x, (i // side) * pitch_y, 0.0)
        for i in range(n_arrays)
    ]
    return combine_arrays([g] * n_arrays, offsets)


def steer_points(points, theta, phi):
    """Rotate the element cloud into the steered frame:
    ``Ry(-theta) @ Rz(phi) @ points`` (reference: antenna.cpp:99-107).

    points [3, N]; theta/phi broadcastable -> result [..., 3, N].
    """
    theta = jnp.asarray(theta)
    phi = jnp.asarray(phi)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    zero = jnp.zeros_like(st)
    # Ry(-t) @ Rz(p) expanded analytically.
    rot = jnp.stack(
        [
            jnp.stack([ct * cp, -ct * sp, -st], axis=-1),
            jnp.stack([sp, cp, zero], axis=-1),
            jnp.stack([st * cp, -st * sp, ct], axis=-1),
        ],
        axis=-2,
    )
    return jnp.matmul(
        rot, jnp.asarray(points), precision=jax.lax.Precision.HIGHEST
    )


def steering_delays(points, theta, phi, samples_per_meter, axis_name=None):
    """Steering delays in samples for a batch of directions.

    points [3, N]; theta/phi [...] -> delays [..., N], min-subtracted per
    direction so the element nearest the source has zero delay
    (reference: antenna.cpp:89-97 + 126-134).

    ``axis_name``: when the channel axis N is sharded over a mesh axis
    (inside ``shard_map``), the min must be global — it is reduced with
    ``lax.pmin`` so every shard subtracts the same reference delay.
    """
    theta = jnp.asarray(theta, jnp.float32)
    phi = jnp.asarray(phi, jnp.float32)
    st = jnp.sin(theta)
    u = jnp.stack([st * jnp.cos(phi), -st * jnp.sin(phi), jnp.cos(theta)], axis=-1)
    # HIGHEST: a TF32 product would put ~1e-3 relative error on delays of
    # tens of samples.
    z = jnp.matmul(
        u, jnp.asarray(points, jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )  # [..., N]
    delays = z * jnp.float32(samples_per_meter)
    mins = jnp.min(delays, axis=-1, keepdims=True)
    if axis_name is not None:
        mins = jax.lax.pmin(mins, axis_name)
    return delays - mins


def steering_delays_np(points, theta, phi, samples_per_meter) -> np.ndarray:
    """Host-side (numpy) twin of :func:`steering_delays` for large static
    direction grids — avoids per-op device round trips at LUT build time."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    st = np.sin(theta)
    u = np.stack([st * np.cos(phi), -st * np.sin(phi), np.cos(theta)], axis=-1)
    z = u @ np.asarray(points, np.float64)
    delays = z * float(samples_per_meter)
    return (delays - delays.min(axis=-1, keepdims=True)).astype(np.float32)


def steering_delays_horizontal(points, azimuth, elevation, samples_per_meter):
    """Steering via (azimuth, elevation) angles (reference: antenna.cpp:109-117)."""
    theta, phi = horizontal_to_spherical(azimuth, elevation)
    return steering_delays(points, theta, phi, samples_per_meter)


def steering_delays_cartesian(points, xyz, samples_per_meter):
    """Steering toward unit-sphere points [..., 3]
    (reference: antenna.cpp:119-124)."""
    xyz = jnp.asarray(xyz)
    azimuth = jnp.arctan2(xyz[..., 1], xyz[..., 0])
    elevation = np.pi / 2.0 - jnp.arcsin(jnp.clip(xyz[..., 2], -1.0, 1.0))
    return steering_delays_horizontal(points, azimuth, elevation, samples_per_meter)


def generate_unit_dome(n: int) -> np.ndarray:
    """Fibonacci-spiral hemisphere of n unit vectors, shape [n, 3]
    (reference: antenna.cpp:136-153)."""
    i = np.arange(n, dtype=np.float64)
    incl = np.arccos(1.0 - i / n)          # reference calls this "phi"
    azim = i * (2.0 * np.pi / 1.618033988749)
    return np.stack(
        [np.cos(azim) * np.sin(incl), np.sin(azim) * np.sin(incl), np.cos(incl)],
        axis=-1,
    ).astype(np.float32)


def generate_dome_lookup(dome: np.ndarray) -> np.ndarray:
    """[90, 360] table mapping integer (inclination_deg, azimuth_deg) to the
    nearest dome index (reference: antenna.cpp:155-178, vectorized — the
    reference's O(90*360*n) scalar loop becomes one argmin over a distance
    matrix)."""
    incl = np.deg2rad(np.arange(90, dtype=np.float64))[:, None]
    azim = np.deg2rad(np.arange(360, dtype=np.float64))[None, :]
    x = np.cos(azim) * np.sin(incl)
    y = np.sin(azim) * np.sin(incl)
    z = np.broadcast_to(np.cos(incl), x.shape)
    grid = np.stack([x, y, z], axis=-1).reshape(-1, 3)          # [90*360, 3]
    d2 = ((grid[:, None, :] - dome[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.argmin(d2, axis=1).reshape(90, 360).astype(np.int32)


def dome_lookup_max_error(dome: np.ndarray, table: np.ndarray) -> float:
    """Worst chord distance from any table cell to its dome point — the
    vectorized, exhaustive version of the reference's random self-test
    (antenna.cpp:180-211, 0.2 max allowed distance)."""
    incl = np.deg2rad(np.arange(90, dtype=np.float64))[:, None]
    azim = np.deg2rad(np.arange(360, dtype=np.float64))[None, :]
    x = np.cos(azim) * np.sin(incl)
    y = np.sin(azim) * np.sin(incl)
    z = np.broadcast_to(np.cos(incl), x.shape)
    grid = np.stack([x, y, z], axis=-1)
    picked = dome[table]
    return float(np.sqrt(((grid - picked) ** 2).sum(-1)).max())
