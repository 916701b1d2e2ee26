"""Plain-NumPy truth implementations of the reference math.

These are deliberately written as direct, loopy ports of the C++ semantics
(cited per function) and serve as the "NumPy truth" the reference's own
stale tests intended to compare against (tests/test_antenna.py:127-148 in
the reference tree).  The framework's vectorized/jitted ops are asserted
against these.
"""

from __future__ import annotations

import math

import numpy as np


def rotate_z(angle):
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotate_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def steering_delays_ref(points, theta, phi, samples_per_meter):
    """Port of steer() + compute_delays() (antenna.cpp:89-107)."""
    rotated = rotate_y(-theta) @ rotate_z(phi) @ np.asarray(points, np.float64)
    delays = rotated[2] * samples_per_meter
    return delays - delays.min()


def delay_ref(out, signal, fraction, n_samples):
    """Port of the active AVX2 linear-interp delay (delay.cpp:16-26)."""
    for i in range(n_samples):
        out[i] += signal[i + 1] + fraction * (signal[i] - signal[i + 1])
    return out


def das_ref(history, delays, block_start, n_samples):
    """Delay-and-sum a block: for each channel split the delay into integer
    and fractional parts as the reference does (particle.cpp:37-49) and
    accumulate the linearly-interpolated, shifted signal."""
    out = np.zeros(n_samples, np.float64)
    for c in range(history.shape[0]):
        whole = int(delays[c])  # trunc, delays >= 0
        frac = float(delays[c]) - whole
        off = block_start - whole
        delay_ref(out, history[c, off : off + n_samples + 1], frac, n_samples)
    return out


def das_fir_ref(history, delays, block_start, n_samples, bank):
    """Delay-and-sum a block through a polyphase fractional-delay FIR bank
    (delay.cpp:31-40 semantics): per channel, the bank row of the
    quantized fraction filters the signal starting ``int(delay)`` samples
    before the block."""
    bank = np.asarray(bank, np.float64)
    phases, taps = bank.shape
    out = np.zeros(n_samples, np.float64)
    for c in range(history.shape[0]):
        whole = int(np.floor(delays[c]))
        h = bank[int(round((float(delays[c]) - whole) * (phases - 1)))]
        off = block_start - whole
        for j in range(taps):
            out += h[j] * history[c, off + j: off + j + n_samples]
    return out


def monopulse_probes_ref(theta, phi, spread, layout="quadrant"):
    """The four monopulse probe directions around (theta, phi): the
    reference's ring at inclination ``spread`` (diagonals for "quadrant",
    N/E/S/W for "horizontal"; geometry.cpp:144-217) with its FoV-edge
    pull-in, rotated onto the particle by ``Rz(phi) @ Ry(theta)`` — the
    re-centred construction ops/geometry.py documents, i.e. without the
    reference's azimuth mirror.  Returns (probes [(theta, phi)] x 4,
    adjusted_theta)."""
    azimuths = (45.0, 315.0, 225.0, 135.0) if layout == "quadrant" else (
        0.0, 90.0, 180.0, 270.0)
    rotate_theta, adjusted = theta, theta
    if theta + spread > math.pi / 2.0:
        rotate_theta = theta - spread
        adjusted = theta - spread / 2.0
    rot = rotate_z(phi) @ rotate_y(rotate_theta)
    probes = []
    for a in azimuths:
        a = math.radians(a)
        k = rot @ np.array([math.sin(spread) * math.cos(a),
                            math.sin(spread) * math.sin(a),
                            math.cos(spread)])
        probes.append((math.acos(np.clip(k[2], -1.0, 1.0)),
                       math.atan2(k[1], k[0])))
    return probes, adjusted


def bandpass_power_ref(out, n_samples, divisor):
    """Port of the 3-tap MA bandpass power (mimo.cpp:131-137)."""
    acc = 0.0
    for i in range(1, n_samples - 1):
        ma = out[i] * 0.5 - 0.25 * (out[i + 1] + out[i - 1])
        acc += ma * ma
    return acc / divisor


def mimo_grid_ref(rows, columns, fov_degrees):
    """Port of the heatmap direction grid (mimo.cpp:20-59): pixel -> (x, y)
    on the sin-projected FoV disc -> (theta, phi)."""
    fov = math.radians(fov_degrees)
    sep_r = math.sin(fov / 2.0) / (rows / 2.0)
    sep_c = math.sin(fov / 2.0) / (columns / 2.0)
    thetas = np.zeros((rows, columns))
    phis = np.zeros((rows, columns))
    for r in range(rows):
        for c in range(columns):
            y = r * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
            x = c * sep_c - columns * sep_c / 2.0 + sep_c / 2.0
            norm = math.hypot(x, y)
            xn, yn = x / norm, y / norm
            theta = math.asin(min(norm, 1.0))
            phi = math.atan2(yn, xn)
            thetas[r, c] = theta
            phis[r, c] = phi
    return thetas, phis


def quadrant_ref(theta, phi, spread):
    """Port of Spherical::quadrant (geometry.cpp:181-217).

    Returns (probes list of (theta, phi), adjusted_theta)."""

    def to_cart(t, p):
        return np.array(
            [math.sin(t) * math.cos(p), math.sin(t) * math.sin(p), math.cos(t)]
        )

    base = np.stack(
        [to_cart(spread, math.radians(a)) for a in (45.0, 315.0, 225.0, 135.0)]
    )
    rotate_theta = theta
    adjusted = theta
    if rotate_theta + spread > math.pi / 2.0:
        rotate_theta -= spread
        adjusted = theta - spread / 2.0
    rot = rotate_y(rotate_theta) @ rotate_z(phi)
    rotated = base @ rot
    probes = []
    for k in rotated:
        new_theta = math.acos(np.clip(k[2], -1, 1))
        new_phi = math.atan2(k[1], k[0]) - math.pi
        probes.append((new_theta, new_phi))
    return probes, adjusted


def kalman_ref_matrices(dt):
    """Port of KalmanFilter3D's model matrices (kf.h:34-83)."""
    dt2, dt3, dt4, dt5, dt6 = dt**2, dt**3, dt**4, dt**5, dt**6
    a = np.eye(9)
    for i in range(3):
        a[i, i + 3] = dt
        a[i, i + 6] = dt2 / 2.0
        a[i + 3, i + 6] = dt
    q = np.zeros((9, 9))
    for i in range(3):
        q[i, i] = dt6 / 36
        q[i, i + 3] = q[i + 3, i] = dt5 / 12
        q[i, i + 6] = q[i + 6, i] = dt4 / 6
        q[i + 3, i + 3] = dt4 / 4
        q[i + 3, i + 6] = q[i + 6, i + 3] = dt3 / 2
        q[i + 6, i + 6] = dt2
    h = np.zeros((3, 9))
    h[:3, :3] = np.eye(3)
    r = np.eye(3)
    return a, q, h, r


def triangulate_ref(o1, d1, o2, d2, distance_threshold):
    """Port of triangulatePoint (triangulate.cpp:10-41)."""
    o1, d1, o2, d2 = (np.asarray(v, np.float64) for v in (o1, d1, o2, d2))
    n = np.cross(d1, d2)
    t1 = np.dot(np.cross(d2, n), o2 - o1) / np.dot(n, n)
    t2 = np.dot(np.cross(d1, n), o2 - o1) / np.dot(n, n)
    p1 = o1 + d1 * t1
    p2 = o2 + d2 * t2
    mid = (p1 + p2) / 2.0
    if (
        np.linalg.norm(p1 - p2) > distance_threshold
        or np.linalg.norm(mid) > 20.0
        or (p1 + p2)[2] < 0.0
        or mid[2] < 1.0
    ):
        return np.zeros(3)
    return mid


def fft_das_power_ref(windows, delays, shift_range, block_size, taps=2,
                      mask=None, use_bandpass=True):
    """Frequency-domain delay-and-sum power, one (direction, channel) phase
    at a time in complex float64 — the exact band-limited semantics of the
    separable heatmap (ops/fft_das.py), without its factorization.

    windows [..., C, S + T]; delays [D, C] in samples.  The alignment
    offset ``(S - taps) + 1`` matches the dense linear-interp kernel's
    window convention, including the reference's backwards-interp
    one-sample quirk (delay.cpp:24).  Returns powers [..., D].
    """
    windows = np.asarray(windows, np.float64)
    delays = np.asarray(delays, np.float64)
    s, t = shift_range, block_size
    n_fft = s + t
    f = np.arange(n_fft // 2 + 1)
    x = np.fft.rfft(windows, n=n_fft, axis=-1)             # [..., C, F]
    if mask is not None:
        x = x * np.asarray(mask, np.float64)[:, None]
    shift = (s - taps) + 1 - delays                         # [D, C]
    phase = np.exp(2j * np.pi * f[None, None, :] * shift[..., None] / n_fft)
    spec = np.einsum("dcf,...cf->...df", phase, x)
    beam = np.fft.irfft(spec, n=n_fft, axis=-1)[..., :t]
    if use_bandpass:
        beam = 0.5 * beam[..., 1:-1] - 0.25 * (beam[..., 2:] + beam[..., :-2])
    n_act = delays.shape[1] if mask is None else float(np.sum(mask))
    return (beam ** 2).sum(axis=-1) / (t * n_act)


def _stft_covariance_ref(blocks, frame_size, hop, bins, ema_alpha):
    """EMA over blocks of the per-bin sample covariance ``X X^H / M`` of
    Hann-windowed frames (complex128, [F, C, C])."""
    win = np.hanning(frame_size)
    cov = None
    for block in blocks:
        block = np.asarray(block, np.float64)
        starts = range(0, block.shape[-1] - frame_size + 1, hop)
        frames = np.stack([block[:, s:s + frame_size] for s in starts])
        x = np.fft.rfft(frames * win, axis=-1)[..., bins]   # [M, C, F]
        r = np.einsum("mcf,mdf->fcd", x, x.conj()) / frames.shape[0]
        cov = r if cov is None else (1.0 - ema_alpha) * cov + ema_alpha * r
    return cov


def _adaptive_setup(points, theta, phi, samples_per_meter, sample_rate,
                    frame_size, f_low, f_high):
    freqs = np.fft.rfftfreq(frame_size, 1.0 / sample_rate)
    bins = np.nonzero((freqs >= f_low) & (freqs <= f_high))[0]
    bins = bins[(bins > 0) & (bins < frame_size // 2)]
    delays = np.stack([
        steering_delays_ref(points, t, p, samples_per_meter)
        for t, p in zip(np.ravel(theta), np.ravel(phi))
    ])                                                      # [D, C]
    v = np.exp(2j * np.pi * freqs[bins][:, None, None] * delays[None]
               / sample_rate)                               # [F, D, C]
    return bins, v


def capon_ref(blocks, points, theta, phi, samples_per_meter, sample_rate,
              frame_size=64, hop=32, f_low=550.0, f_high=9000.0,
              ema_alpha=0.1, diagonal_loading=1e-3):
    """Wideband Capon (MVDR) power ``sum_f 1 / (v^H R^-1 v)`` in complex
    float64, with the covariance EMA and trace-scaled diagonal loading of
    models/mvdr.py."""
    bins, v = _adaptive_setup(points, theta, phi, samples_per_meter,
                              sample_rate, frame_size, f_low, f_high)
    cov = _stft_covariance_ref(blocks, frame_size, hop, bins, ema_alpha)
    c = cov.shape[-1]
    powers = np.zeros(v.shape[1])
    for f in range(len(bins)):
        load = diagonal_loading * np.trace(cov[f]).real / c + 1e-12
        r = cov[f] + load * np.eye(c)
        sol = np.linalg.solve(r, v[f].T)                    # [C, D]
        powers += 1.0 / np.einsum("dc,cd->d", v[f].conj(), sol).real
    return powers


def music_ref(blocks, points, theta, phi, samples_per_meter, sample_rate,
              n_sources=3, frame_size=64, hop=32, f_low=550.0, f_high=9000.0,
              ema_alpha=0.1):
    """Incoherent wideband MUSIC ``sum_f w_f / ||En^H v||^2`` in complex
    float64 (exact eigendecomposition per bin), with the SNR bin weights
    of models/music.py."""
    bins, v = _adaptive_setup(points, theta, phi, samples_per_meter,
                              sample_rate, frame_size, f_low, f_high)
    cov = _stft_covariance_ref(blocks, frame_size, hop, bins, ema_alpha)
    c, k = cov.shape[-1], n_sources
    sig = np.zeros(len(bins))
    denom = np.zeros((len(bins), v.shape[1]))
    for f in range(len(bins)):
        vals, vecs = np.linalg.eigh(cov[f])                 # ascending
        en = vecs[:, :c - k]
        sig[f] = max(vals[c - k:].sum() - k * vals[:c - k].mean(), 0.0)
        denom[f] = (np.abs(v[f].conj() @ en) ** 2).sum(axis=-1)
    w = sig / max(sig.sum(), 1e-30)
    return (w[:, None] / np.maximum(denom, 1e-12)).sum(axis=0)
