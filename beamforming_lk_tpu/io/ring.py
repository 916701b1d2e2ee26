"""Functional device-side ring history.

The reference keeps per-mic mirrored-mmap ring buffers that producer and
worker threads race on (``src/fpga/streams.hpp:54-183``; the race tolerance
is by construction, SURVEY §5).  The replacement here is an immutable
``[channels, history]`` array carried through the jitted step: pushing a
block is a shift-and-append, which XLA lowers to cheap fused slices, and
every consumer of a step sees one consistent snapshot — the whole class of
ring races disappears.
"""

from __future__ import annotations

import jax.numpy as jnp

# A ring state is just the [C, H] history array (newest samples at the end).
RingState = jnp.ndarray

#: Samples of lookahead kept past the beamformed block so interpolation taps
#: (up to 8 for the FIR bank) never read off the end of history.  The
#: reference handles this implicitly by beamforming two blocks behind the
#: write position (offset = N_SAMPLES - int(delay) into a 1024 snapshot,
#: mimo.cpp:50); a fixed 8-sample guard gives ~0.16 ms latency instead of
#: ~10.5 ms.
LOOKAHEAD_GUARD = 8


def ring_init(channels: int, history: int, dtype=jnp.float32) -> RingState:
    return jnp.zeros((channels, history), dtype)


def ring_push(history: RingState, block) -> RingState:
    """Append a [C, T] block, dropping the oldest T samples."""
    t = block.shape[-1]
    return jnp.concatenate([history[..., t:], block.astype(history.dtype)], axis=-1)


def block_start(history_len: int, block_size: int) -> int:
    """History index where the beamformed block begins."""
    return history_len - block_size - LOOKAHEAD_GUARD


def ring_window(
    history: RingState, block_size: int, shift_range: int, taps: int
) -> jnp.ndarray:
    """Extract the [C, T + S] window the DAS kernel consumes.

    Window start is ``block_start - (S - taps)`` so that kernel index
    ``t + shift + j`` (shift = S - taps - int(delay)) lands on history index
    ``block_start + t - int(delay) + j`` — the reference's read pattern
    (particle.cpp:44, mimo.cpp:50).
    """
    h = history.shape[-1]
    b = block_start(h, block_size)
    w0 = b - (shift_range - taps)
    if w0 < 0:
        raise ValueError(
            f"history {h} too short for block {block_size} + shifts {shift_range}"
        )
    return jnp.asarray(history)[..., w0 : w0 + block_size + shift_range]


def ring_windows(
    history: RingState,
    block_size: int,
    shift_range: int,
    taps: int,
    chunk: int,
) -> jnp.ndarray:
    """[chunk, C, T + S] DAS windows for the last ``chunk`` pushed blocks.

    Window ``j`` is exactly :func:`ring_window` as it would have been after
    pushing block ``j`` of the chunk — chunked (throughput) processing of a
    recorded or paced stream computes identical per-block outputs to
    block-at-a-time streaming, with every downstream matmul batched
    ``chunk``-wide (the shape of faster-than-real-time replay).
    """
    h = history.shape[-1]
    win = block_size + shift_range
    w_last = block_start(h, block_size) - (shift_range - taps)
    w0 = w_last - (chunk - 1) * block_size
    if w0 < 0:
        raise ValueError(
            f"history {h} too short for {chunk} blocks of {block_size} "
            f"+ shifts {shift_range}"
        )
    hist = jnp.asarray(history)
    return jnp.stack(
        [hist[..., w0 + j * block_size : w0 + j * block_size + win]
         for j in range(chunk)]
    )
