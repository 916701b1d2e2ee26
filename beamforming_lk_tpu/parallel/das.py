"""Sharded delay-and-sum: the multi-chip data path.

The reference beamforms at most 2 FPGAs' arrays on one CPU with AVX2
(``README.md:10``, ``src/dsp/mimo.cpp:121-151``); scaling means more
processes.  Here one ``shard_map`` program scales the same math across a
device mesh:

- **channel sharding** (``ch``): each device holds ``C/n_ch`` mic channels
  of the window and the matching stencil slice; partial beams are summed
  with ``lax.psum`` — the analog of the reference's accumulate-over-mics
  inner loop (``src/dsp/delay.cpp:16-26``), accumulated across devices.
- **direction sharding** (``dir``): the heatmap grid / probe batch splits
  freely with no communication.
- **time sharding** (``t``): a block's time axis splits into contiguous
  chunks; each chunk needs the ``S`` preceding samples (the DAS shift span),
  exchanged from the left neighbor with ``lax.ppermute`` — the halo/overlap-
  save scheme the reference gets implicitly from its mirrored-mmap ring
  (``src/fpga/streams.hpp:152-182``, SURVEY §5 "long-context").
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.parallel.mesh import CH_AXIS, DIR_AXIS, TIME_AXIS


def shard_window(window, mesh: Mesh):
    """Place a [C, T+S] window with channels sharded over ``ch``."""
    spec = P(CH_AXIS, None) if CH_AXIS in mesh.axis_names else P(None, None)
    return jax.device_put(window, NamedSharding(mesh, spec))


def shard_weights(weights, mesh: Mesh):
    """Place a [D, C, S] stencil sharded over (``dir``, ``ch``)."""
    d = DIR_AXIS if DIR_AXIS in mesh.axis_names else None
    c = CH_AXIS if CH_AXIS in mesh.axis_names else None
    return jax.device_put(weights, NamedSharding(mesh, P(d, c, None)))


def make_sharded_das_power(
    mesh: Mesh,
    *,
    use_bandpass: bool = True,
    n_active: float | None = None,
):
    """Build the sharded heatmap kernel: (window, weights) -> powers [D].

    ``window`` [C, T+S] sharded ``P(ch, None)``; ``weights`` [D, C, S]
    sharded ``P(dir, ch, None)``; output [D] sharded ``P(dir)``.  C must
    divide by the ``ch`` mesh size and D by the ``dir`` size.

    The beam is psum-reduced over channel shards *before* squaring — power
    is a nonlinear function of the full-array beam, so the reduction order
    mirrors the reference's sum-over-all-mics-then-square
    (``src/dsp/mimo.cpp:124-137``).
    """
    has_ch = CH_AXIS in mesh.axis_names
    ch = CH_AXIS if has_ch else None
    d = DIR_AXIS if DIR_AXIS in mesh.axis_names else None

    def _power(window, weights):
        beam = dl.das_beam(window, weights)          # [D_loc, T] partial
        if has_ch:
            beam = lax.psum(beam, CH_AXIS)           # full-array beam
        t = beam.shape[-1]
        count = weights.shape[-2] * (
            lax.psum(1, CH_AXIS) if has_ch else 1
        ) if n_active is None else n_active
        return dl.das_power(beam, use_bandpass=use_bandpass, divisor=t * count)

    sharded = jax.shard_map(
        _power,
        mesh=mesh,
        in_specs=(P(ch, None), P(d, ch, None)),
        out_specs=P(d),
    )
    return jax.jit(sharded)


def halo_exchange_time(block, history_tail, halo: int, axis_name: str = TIME_AXIS):
    """Left-halo exchange for a time-sharded block (call inside shard_map).

    ``block`` [C, T_loc] is this device's contiguous time chunk;
    ``history_tail`` [C, halo] is the S samples preceding the *global* block
    (replicated).  Returns [C, halo + T_loc]: each device receives its left
    neighbor's last ``halo`` samples; the first device uses the history tail.
    Requires ``T_loc >= halo``.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    tail = block[..., -halo:]
    if n > 1:
        recv = lax.ppermute(
            tail, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
        )
    else:
        recv = tail
    left = jnp.where(idx == 0, history_tail, recv)
    return jnp.concatenate([left, block], axis=-1)


def make_time_sharded_beam(mesh: Mesh):
    """Build the sequence-parallel beamformer:
    (block, history_tail, weights) -> beam [D, T].

    ``block`` [C, T] time-sharded ``P(None, t)``; ``history_tail`` [C, S]
    replicated; ``weights`` [D, C, S] sharded over ``dir``.  Output [D, T]
    sharded ``P(dir, t)``.  T must divide by the ``t`` mesh size and each
    chunk must be >= S.
    """
    d = DIR_AXIS if DIR_AXIS in mesh.axis_names else None
    t_ax = TIME_AXIS if TIME_AXIS in mesh.axis_names else None

    def _beam(block, history_tail, weights):
        s = weights.shape[-1]
        if t_ax is not None:
            window = halo_exchange_time(block, history_tail, s, t_ax)
        else:
            window = jnp.concatenate([history_tail, block], axis=-1)
        return dl.das_beam(window, weights)

    sharded = jax.shard_map(
        _beam,
        mesh=mesh,
        in_specs=(P(None, t_ax), P(None, None), P(d, None, None)),
        out_specs=P(d, t_ax),
    )
    return jax.jit(sharded)


def make_sharded_mimo_step(
    mesh: Mesh,
    *,
    block_size: int,
    shift_range: int,
    taps: int,
    use_bandpass: bool = True,
):
    """Fused streaming step: (history, block, weights) -> (history', powers).

    The full per-block device program: push the new [C, T] block into the
    [C, H] ring history (both channel-sharded), slice the DAS window, psum
    partial beams over ``ch``, return heatmap powers sharded over ``dir``.
    This is the multi-chip analog of producer->barrier->MIMOWorker::update
    (``src/fpga/pipeline.cpp:243-255`` + ``src/dsp/mimo.cpp:97-151``) as ONE
    jitted SPMD program.
    """
    from beamforming_lk_tpu.io import ring as rg

    has_ch = CH_AXIS in mesh.axis_names
    ch = CH_AXIS if has_ch else None
    d = DIR_AXIS if DIR_AXIS in mesh.axis_names else None

    def _step(history, block, weights):
        history = rg.ring_push(history, block)
        window = rg.ring_window(history, block_size, shift_range, taps)
        beam = dl.das_beam(window, weights)
        if has_ch:
            beam = lax.psum(beam, CH_AXIS)
        t = beam.shape[-1]
        count = weights.shape[-2] * (lax.psum(1, CH_AXIS) if has_ch else 1)
        powers = dl.das_power(beam, use_bandpass=use_bandpass, divisor=t * count)
        return history, powers

    sharded = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(ch, None), P(ch, None), P(d, ch, None)),
        out_specs=(P(ch, None), P(d)),
    )
    return jax.jit(sharded, donate_argnums=(0,))
