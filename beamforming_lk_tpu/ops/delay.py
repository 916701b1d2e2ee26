"""Fractional-delay delay-and-sum (DAS), lowered to a dense shift-matmul.

This is the single kernel behind all three reference workloads — the MIMO
heatmap inner loop (``src/dsp/mimo.cpp:121-151``), the tracker's monopulse
probe beams (``src/dsp/particle.cpp:51-82``) and the MISO audio beam
(``src/dsp/particle.cpp:88-103``) all call the same ``delay()`` accumulate
kernel (``src/dsp/delay.cpp``).  Here that per-(direction, channel) dynamic
time-shift gather is recast as a dense contraction, which matrix units
(tensor cores) run at full rate:

    beam[d, t] = sum_c sum_k  W[d, c, k] * x[c, t + k]

with ``W`` a per-direction interpolation stencil that is zero except for
``taps`` entries per channel (2 for linear interpolation, 8 for the
polyphase FIR bank).  Unfolding ``x`` into sliding windows turns the whole
thing into one ``[D, C*S] @ [C*S, T]`` matmul.  The shift span S is small
(max steering delay for an 8x8 array at 2 cm pitch is ~29 samples) so the
unfolded window is tiny (C*S*T floats ~ 4 MB) and W streams at HBM speed.

Index-level parity with the reference's active (AVX2) delay variant
(``delay.cpp:16-26``): that kernel computes
``out[t] += x[a+1] + frac * (x[a] - x[a+1])`` at ``a = (256 - int(tau)) + t``,
i.e. weight ``frac`` on ``x[a]`` and ``1 - frac`` on ``x[a+1]`` — the exact
stencil built here (shifted by the constant ``S - 2 - 256``, which is uniform
across channels and directions and therefore beamform-invariant).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

LINEAR_TAPS = 2

#: Integer sample delay of the polyphase FIR bank's center tap (the
#: default ``center`` of :func:`fractional_delay_fir_bank`).
FIR_DEFAULT_CENTER = 4.0


def probe_span(
    points,
    samples_per_meter: float,
    taps: int = LINEAR_TAPS,
    shift_range: int | None = None,
    multiple: int = 8,
) -> int:
    """Tightest stencil span (in samples) covering every steering delay of
    this aperture.

    Min-subtracted steering delays are bounded by the point cloud's spatial
    diameter (the z-spread of the rotated points, antenna.cpp:89-97), so a
    stencil of ``ceil(diameter * fs/c) + taps`` samples — rounded up to a
    sublane-friendly multiple — represents every physical delay.  For a
    single 8x8 array at 2 cm pitch that is 32 instead of the default
    ``shift_range`` of 64: slicing the DAS window to the last ``span + T``
    samples and building weights with this span halves the contraction with
    bit-identical beams (the integer shift base moves by the same constant
    the window start does).
    """
    pts = np.asarray(points, np.float64)
    diameter = float(np.linalg.norm(pts.max(axis=1) - pts.min(axis=1)))
    span = int(math.ceil(diameter * samples_per_meter)) + taps
    span = ((span + multiple - 1) // multiple) * multiple
    if shift_range is not None:
        span = min(span, shift_range)
    return span


def fractional_delay_fir_bank(
    phases: int = 101, taps: int = 8, center: float = FIR_DEFAULT_CENTER
) -> np.ndarray:
    """Windowed-sinc fractional-delay filter bank, shape [phases, taps].

    Phase p reconstructs ``x(n + center - p/(phases-1))`` from taps
    ``x[n..n+taps-1]`` — i.e. each successive phase delays by one more
    fractional step, matching the *sign convention of the reference's active
    linear-interp path* (see module docstring).  Method follows the
    reference's offline designer (``math_toolbox/filter_produce.m``:
    blackman-windowed sinc, peak-gain normalized); the reference's shipped
    bank (``src/dsp/filter.h``) uses the opposite fraction sign, which
    disagrees with its own AVX2 path — we keep the self-consistent sign.
    """
    fracs = np.arange(phases, dtype=np.float64) / (phases - 1)
    j = np.arange(taps, dtype=np.float64)[None, :]
    d = (center - fracs)[:, None]
    h = np.sinc(j - d) * np.blackman(taps)[None, :]
    # Normalize to unit DC gain so a constant passes through unchanged.
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(np.float32)


def delay_lut(delays, shift_range: int, taps: int):
    """Split delays-in-samples into (integer shift, fraction).

    ``shift = (S - taps) - floor(tau)`` places larger delays earlier in the
    window (reading further into the past), mirroring the reference's
    ``offset = N_SAMPLES - int(delay)`` split (mimo.cpp:44-53,
    particle.cpp:37-49).  Requires ``0 <= tau <= S - taps``.
    """
    delays = jnp.asarray(delays, jnp.float32)
    # Clamp into the representable span: a delay outside [0, S - taps] would
    # otherwise produce an out-of-window shift whose one-hot stencil is all
    # zeros, silently muting the channel.  Callers size shift_range from
    # ArrayConfig.max_delay_samples so the clamp is a no-op in normal use.
    delays = jnp.clip(delays, 0.0, float(shift_range - taps))
    whole = jnp.floor(delays)
    frac = delays - whole
    shift = (shift_range - taps) - whole.astype(jnp.int32)
    return shift, frac


def interp_weights(fractions, mode: str = "linear", fir_bank=None):
    """Per-delay interpolation stencil [..., taps] for a given fraction.

    linear: ``[f, 1-f]``       (delay.cpp:16-26 semantics)
    fir:    8-tap row of the polyphase bank, selected by quantized fraction
            (delay.cpp:31-40 semantics, self-consistent sign).
    """
    f = jnp.asarray(fractions, jnp.float32)
    if mode == "linear":
        return jnp.stack([f, 1.0 - f], axis=-1)
    if mode == "fir":
        bank = jnp.asarray(fir_bank)
        phases = bank.shape[0]
        idx = jnp.round(f * (phases - 1)).astype(jnp.int32)
        return bank[idx]
    raise ValueError(f"unknown interp mode: {mode}")


def das_weights(delays, shift_range: int, mode: str = "linear", fir_bank=None):
    """Dense DAS stencil W[..., C, S] from delays [..., C].

    ``W[..., c, shift + j] = w_j`` — built from iota so it traces cleanly
    under jit (directions may change every step, e.g. the tracker's probe
    beams).

    For linear interpolation the two-tap stencil ``[f at shift, 1-f at
    shift+1]`` is exactly a unit triangle hat centered at ``shift + 1 - f``,
    so it is built closed-form in 3 elementwise ops on ``[..., C, S]``
    (subtract / abs / relu) with no ``[..., C, taps, S]`` intermediate —
    this build runs once per sequential monopulse dispatch in the tracker
    swarm chain and is its elementwise bottleneck, not the matmul.
    """
    if mode == "linear":
        shift, frac = delay_lut(delays, shift_range, LINEAR_TAPS)
        k = jnp.arange(shift_range, dtype=jnp.float32)      # [S]
        # delta = k - shift is an exact small float; subtracting (1 - f)
        # in that space keeps the taps bit-equal to [f, 1-f] (subtracting
        # from a pre-added center would round at ulp(shift)).
        delta = k - shift.astype(jnp.float32)[..., None]    # [..., C, S]
        return jnp.maximum(0.0, 1.0 - jnp.abs(delta - (1.0 - frac[..., None])))
    taps = int(np.shape(fir_bank)[-1])
    shift, frac = delay_lut(delays, shift_range, taps)
    w = interp_weights(frac, mode, fir_bank)  # [..., C, taps]
    k = jnp.arange(shift_range, dtype=jnp.int32)  # [S]
    # one-hot accumulate over taps: sum_j w_j * [k == shift + j]
    shift_e = shift[..., None, None]                    # [..., C, 1, 1]
    j = jnp.arange(taps, dtype=jnp.int32)[:, None]      # [taps, 1]
    onehot = (k[None, None, :] == shift_e + j).astype(w.dtype)  # [..., C, taps, S]
    return jnp.einsum(
        "...ct,...cts->...cs", w, onehot, precision=jax.lax.Precision.HIGHEST
    )


def das_weights_np(delays, shift_range: int, mode: str = "linear", fir_bank=None):
    """Host-side (numpy) builder of the same stencil as :func:`das_weights`.

    For large STATIC direction grids (the MIMO heatmap LUT) the traced
    one-hot construction is wasteful at build time, one eager dispatch per
    op.  This scatters the
    taps directly and does not touch the device at all; callers
    ``device_put`` the result once.
    """
    taps = LINEAR_TAPS if mode == "linear" else int(np.shape(fir_bank)[-1])
    delays = np.clip(np.asarray(delays, np.float64), 0.0, float(shift_range - taps))
    whole = np.floor(delays)
    frac = (delays - whole).astype(np.float32)
    shift = (shift_range - taps) - whole.astype(np.int64)
    if mode == "linear":
        w = np.stack([frac, 1.0 - frac], axis=-1)
    elif mode == "fir":
        bank = np.asarray(fir_bank, np.float32)
        idx = np.round(frac * (bank.shape[0] - 1)).astype(np.int64)
        w = bank[idx]
    else:
        raise ValueError(f"unknown interp mode: {mode}")
    out = np.zeros(delays.shape + (shift_range,), np.float32)
    tap_idx = shift[..., None] + np.arange(taps)     # distinct per tap
    np.put_along_axis(out, tap_idx, w, axis=-1)
    return out


def unfold_window(window, shift_range: int, block_size: int):
    """x[C, T + S] -> sliding windows X[C, S, T] with X[c, k, t] = x[c, t+k].

    S static and small, so this lowers to S cheap slices that XLA fuses into
    the consuming matmul.
    """
    slices = [
        jax.lax.slice_in_dim(window, k, k + block_size, axis=-1)
        for k in range(shift_range)
    ]
    return jnp.stack(slices, axis=-2)


def das_beam(window, weights, *, precision=jax.lax.Precision.HIGHEST,
             axis_name=None):
    """beam[..., D, T] = W[..., D, C, S] contracted with unfolded window.

    window: [C, T + S]; weights: [..., D, C, S].
    One [D, C*S] @ [C*S, T] matmul.

    ``axis_name``: when C is a shard of the channel axis (inside
    ``shard_map``), the partial beams are ``psum``-reduced over that mesh
    axis so the result is the full-array beam on every shard.
    """
    c, tw = window.shape[-2], window.shape[-1]
    s = weights.shape[-1]
    t = tw - s
    unf = unfold_window(window, s, t)                   # [C, S, T]
    return das_beam_unfolded(
        unf, weights, precision=precision, axis_name=axis_name
    )


def das_beam_unfolded(unf, weights, *, precision=jax.lax.Precision.HIGHEST,
                      axis_name=None):
    """:func:`das_beam` on a pre-unfolded window ``unf[C, S, T]``.

    The unfold is loop-invariant across the tracker swarm's sequential
    monopulse chain (the window doesn't change within a block), so hoisting
    it out of the ``lax.scan`` body and reusing it across every probe
    dispatch removes S slices + a stack (and the bf16 cast) per step.
    """
    # Accumulate in float32 regardless of input dtype (bf16 inputs run the
    # matrix units at full rate; bf16 accumulation over C*S terms would
    # not be OK).
    beam = jnp.einsum(
        "...dcs,cst->...dt", weights, unf, precision=precision,
        preferred_element_type=jnp.float32,
    )
    if axis_name is not None:
        beam = jax.lax.psum(beam, axis_name)
    return beam


def bandpass_ma(beam):
    """3-tap moving-average bandpass over the time axis:
    ``0.5*y[t] - 0.25*(y[t-1] + y[t+1])`` on interior samples
    (reference: mimo.cpp:131-137, particle.cpp:68-72).

    beam [..., T] -> [..., T-2].
    """
    return 0.5 * beam[..., 1:-1] - 0.25 * (beam[..., 2:] + beam[..., :-2])


def das_power(beam, *, use_bandpass: bool = True, divisor=None):
    """Mean beam power, optionally band-passed first.

    The reference divides by ``N_SAMPLES * count`` in the MIMO worker
    (mimo.cpp:137) but by ``N_SAMPLES`` alone in the particle beam
    (particle.cpp:79); ``divisor`` parameterizes that choice (defaults to T).
    """
    t = beam.shape[-1]
    if divisor is None:
        divisor = t
    if use_bandpass:
        sq = jnp.sum(jnp.square(bandpass_ma(beam)), axis=-1)
    else:
        sq = jnp.sum(jnp.square(beam), axis=-1)
    return sq / jnp.asarray(divisor, beam.dtype)


@functools.partial(jax.jit, static_argnames=("shift_range", "mode", "use_bandpass"))
def das_power_from_delays(
    window,
    delays,
    *,
    shift_range: int,
    mode: str = "linear",
    fir_bank=None,
    channel_mask=None,
    use_bandpass: bool = True,
):
    """Fused convenience path: delays [..., D, C] -> powers [..., D].

    ``channel_mask`` [C] zeroes out dead/hot channels from calibration
    (the reference instead compacts an index list, aw_processing_unit.cpp:193-199;
    masking keeps shapes static for XLA).  Power is normalized by
    ``T * n_active`` as in the MIMO worker.
    """
    w = das_weights(delays, shift_range, mode, fir_bank)
    if channel_mask is not None:
        w = w * jnp.asarray(channel_mask, w.dtype)[..., :, None]
        count = jnp.sum(channel_mask).astype(window.dtype)
    else:
        count = jnp.asarray(w.shape[-2], window.dtype)
    beam = das_beam(window, w)
    t = beam.shape[-1]
    return das_power(beam, use_bandpass=use_bandpass, divisor=t * count)
