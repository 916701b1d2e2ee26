"""Mesh construction helpers.

Axis conventions (see package docstring): ``ch`` (mic channels, psum),
``dir`` (directions, no comm), ``t`` (time, halo exchange).  The reference
has no equivalent — its parallelism is one thread per worker sharing mmap
ring buffers (``src/fpga/pipeline.cpp:210-238``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

CH_AXIS = "ch"
DIR_AXIS = "dir"
TIME_AXIS = "t"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (CH_AXIS, DIR_AXIS),
    devices=None,
) -> Mesh:
    """Build a mesh over available devices.

    With no ``shape``, all devices are split as-square-as-possible over the
    first two axis names (remaining axes get size 1).  Devices that reach
    each other all to all (NVLink) impose no layout, so pass the shape the
    algorithm wants — e.g. ``(n, 1)`` when the direction count does not
    divide by ``n``.
    """
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            a, b = _factor2(n)
            shape = (a, b) + (1,) * (len(axis_names) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def single_device_mesh(axis_names: Sequence[str] = (CH_AXIS, DIR_AXIS)) -> Mesh:
    """A 1x1 mesh — lets the sharded code paths run on one chip unchanged."""
    dev = np.array(jax.devices()[:1]).reshape((1,) * len(axis_names))
    return Mesh(dev, tuple(axis_names))
