"""Wideband frequency-domain MVDR (Capon) beamforming — complex-free.

BASELINE.json's stretch config: the reference is time-domain DAS only; an
adaptive beamformer suppresses interferers that DAS smears across the map.
Fully batched over (bins, directions) and — like the fft heatmap
(ops/fft_das.py) — free of complex dtypes; whether complex64 Cholesky is
faster on the GPU is an open question:

  1. Split each [C, T] block into overlapping frames; per selected STFT bin
     take re/im snapshot planes with two small cos/sin matmuls (the Hann
     window is folded into the tables) — no rfft, no gather.
  2. Per-bin spatial covariance EMA kept as (re, im) planes of the
     Hermitian ``R``:  ``re`` symmetric, ``im`` antisymmetric.
  3. Steering: re/im planes of ``v[F, D, C] = exp(+2 pi i f tau_c / fs)``
     from the SAME min-subtracted steering delays the DAS kernel uses.
  4. Capon power ``P[d] = sum_f 1 / (v^H R^-1 v)`` via the standard 2x2
     real block embedding: the Hermitian-positive-definite ``R = Re + i Im``
     maps to the real SPD ``M = [[Re, -Im], [Im, Re]]`` (size 2C), and
     ``v^H R^-1 v = v_emb^T M^-1 v_emb`` with ``v_emb = [vr | vi]`` — one
     batched real Cholesky + triangular solve over F bins.

Every step is batched real linear algebra (Cholesky over [F, 2C, 2C],
einsum over [F, D, 2C]); bins are embarrassingly parallel, so on
a mesh they shard over the ``dir`` axis with no communication (the "STFT
bins sharded across the pod" story).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.config import ArrayConfig
from beamforming_lk_tpu.ops import antenna as ant


class MvdrState(NamedTuple):
    cov_re: jnp.ndarray  # [F, C, C] float32, symmetric plane of R
    cov_im: jnp.ndarray  # [F, C, C] float32, antisymmetric plane of R
    count: jnp.ndarray   # [] int32 blocks folded in
    # [D] last refreshed Capon powers, carried between refreshes when
    # ``weight_refresh > 1`` (None — an empty pytree leaf — otherwise, so
    # every-block MVDR keeps its exact original state shape).
    powers: Optional[jnp.ndarray] = None


def mvdr_init(
    n_bins: int, channels: int, n_directions: Optional[int] = None
) -> MvdrState:
    """``n_directions`` sizes the carried spectrum — required when the step
    was built with ``weight_refresh > 1``."""
    eye = jnp.eye(channels, dtype=jnp.float32)
    return MvdrState(
        cov_re=jnp.broadcast_to(eye, (n_bins, channels, channels)).astype(
            jnp.float32
        ),
        cov_im=jnp.zeros((n_bins, channels, channels), jnp.float32),
        count=jnp.zeros((), jnp.int32),
        powers=(
            None if n_directions is None
            else jnp.zeros((n_directions,), jnp.float32)
        ),
    )


def select_bins(
    frame_size: int,
    sample_rate: float,
    f_low: float = 550.0,
    f_high: float = 9000.0,
) -> np.ndarray:
    """rfft bin indices inside the band of interest (the reference's band
    envelope, filter_produce.m: 550-9000 Hz)."""
    freqs = np.fft.rfftfreq(frame_size, 1.0 / sample_rate)
    idx = np.where((freqs >= f_low) & (freqs <= f_high))[0]
    # Skip DC/nyquist edges even for wide bands.
    return idx[(idx > 0) & (idx < frame_size // 2)]


def dft_tables(frame_size: int, bins, window=None) -> np.ndarray:
    """Windowed-DFT analysis tables, stacked [2, frame, F] (cos, sin).

    ``X_k = sum_n w_n x_n e^{-2 pi i k n / N}`` becomes
    ``re = x @ tab[0]``, ``im = -(x @ tab[1])`` — two skinny matmuls
    instead of an rfft + bin gather (complex-free).
    """
    if window is None:
        window = np.hanning(frame_size)
    n = np.arange(frame_size, dtype=np.float64)[:, None]
    k = np.asarray(bins, np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / frame_size
    w = np.asarray(window, np.float64)[:, None]
    return np.stack([np.cos(ang) * w, np.sin(ang) * w]).astype(np.float32)


def steering_matrix(
    points,
    theta,
    phi,
    freqs_hz,
    array_cfg: ArrayConfig = ArrayConfig(),
) -> np.ndarray:
    """Re/im planes, stacked [2, F, D, C], of
    ``v = exp(+2 pi i f tau / fs)`` from the DAS delay model.

    Sign convention: the DAS kernel reads channel c at ``t - tau_c`` (larger
    min-subtracted delay = further into the past), i.e. a plane wave from
    the steered direction satisfies ``x_c(n) = s(n + tau_c)`` — in the
    frequency domain ``X_c = S e^{+2 pi i f tau_c / fs}``, so the matched
    steering phasor carries the SAME positive sign (phase-consistent with
    ops/delay.py and io/synthetic.py).
    """
    delays = ant.steering_delays_np(
        np.asarray(points), np.asarray(theta), np.asarray(phi),
        array_cfg.samples_per_meter,
    )  # [D, C] in samples
    phase = (
        2.0
        * np.pi
        * np.asarray(freqs_hz)[:, None, None]
        * delays[None, :, :]
        / array_cfg.sample_rate
    )
    return np.stack([np.cos(phase), np.sin(phase)]).astype(np.float32)


def hermitian_embed(re, im):
    """[..., C, C] (re, im) planes of a Hermitian matrix -> the real
    symmetric 2x2 block embedding ``[[re, -im], [im, re]]`` [..., 2C, 2C].

    HPD complex matrices map to SPD real ones; matvecs/solves commute with
    the embedding of vectors ``z -> [z_re | z_im]``.
    """
    top = jnp.concatenate([re, -im], axis=-1)
    bot = jnp.concatenate([im, re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _stft_snapshots(block, dft_t, frame_size, hop, mask):
    """block [C, T] -> (re, im) snapshot planes [F, C, M]."""
    t = block.shape[-1]
    n_frames = (t - frame_size) // hop + 1
    starts = jnp.arange(n_frames) * hop
    frames = jax.vmap(
        lambda s: jax.lax.dynamic_slice_in_dim(block, s, frame_size, axis=1)
    )(starts)                                    # [M, C, frame]
    if mask is not None:
        frames = frames * mask[None, :, None]
    hi = jax.lax.Precision.HIGHEST
    re = jnp.einsum("mcn,nf->fcm", frames, dft_t[0], precision=hi)
    im = -jnp.einsum("mcn,nf->fcm", frames, dft_t[1], precision=hi)
    return re, im, n_frames


def _snapshot_covariance(xr, xi, n_frames):
    """(re, im) planes [F, C, C] of the sample covariance ``X X^H / M``
    from snapshot planes [F, C, M]."""

    def mm(a, b):
        return jnp.einsum(
            "fcm,fdm->fcd", a, b, precision=jax.lax.Precision.HIGHEST
        )

    r_re = (mm(xr, xr) + mm(xi, xi)) / n_frames
    r_im = (mm(xi, xr) - mm(xr, xi)) / n_frames
    return r_re, r_im


def _make_mvdr_impl(frame_size, hop, mask, ema_alpha, diagonal_loading,
                    axis_name=None, weight_refresh: int = 1):
    """Core per-block update over a (possibly sharded) bin subset.

    ``v_local`` [2, F_loc, D, C] steering planes, ``dft_local``
    [2, frame, F_loc] analysis tables, ``binw_local`` [F_loc] per-bin
    weights (0 for padding bins).  With ``axis_name`` the bins are a mesh
    shard: each shard STFTs the (tiny, replicated) block, solves only its
    own bins' Cholesky systems, and the Capon powers psum across shards —
    bins are embarrassingly parallel, so this scales the heaviest MVDR cost
    (F Cholesky factorizations) linearly.

    ``weight_refresh`` > 1 decimates the SOLVE stage (Cholesky + the
    D-direction triangular solve — the dominant per-block cost, ~96 % at
    C=256): the covariance EMA still folds in every block, but the Capon
    spectrum is recomputed only every k-th block and carried in
    ``state.powers`` in between — exactly the display-rate decimation the
    fused step applies to the DAS heatmap (``MimoConfig.heatmap_every``).
    The EMA moves O(alpha) per block by construction, so a spectrum a few
    blocks stale is within EMA noise (bounded by
    ``tests/test_mvdr.py::test_weight_refresh_staleness_bound``); refresh
    blocks are bit-identical to the undecimated path.
    """

    def impl(state: MvdrState, block, v_local, dft_local, binw_local):
        c = block.shape[0]
        xr, xi, n_frames = _stft_snapshots(block, dft_local, frame_size, hop, mask)
        # Per-bin sample covariance planes of this block: R = X X^H / M.
        r_re, r_im = _snapshot_covariance(xr, xi, n_frames)
        warm = state.count > 0
        alpha = jnp.where(warm, ema_alpha, 1.0).astype(jnp.float32)
        cov_re = (1.0 - alpha) * state.cov_re + alpha * r_re
        cov_im = (1.0 - alpha) * state.cov_im + alpha * r_im

        def solve(_):
            # Diagonal loading scaled to the average channel power per bin.
            tr = jnp.trace(cov_re, axis1=-2, axis2=-1)[:, None]  # [F, 1]
            load = (diagonal_loading * tr / c + 1e-12).astype(jnp.float32)
            eye = jnp.eye(c, dtype=cov_re.dtype)
            r_loaded = cov_re + load[..., None] * eye

            # Capon spectrum via the real block embedding:
            # P = 1 / (v^H R^-1 v) = 1 / || L^-1 v_emb ||^2 with M = L L^T.
            m = hermitian_embed(r_loaded, cov_im)                # [F, 2C, 2C]
            chol = jax.lax.linalg.cholesky(m)
            v_emb = jnp.concatenate(
                [v_local[0], v_local[1]], axis=-1
            )                                                    # [F, D, 2C]
            y = jax.lax.linalg.triangular_solve(
                chol, jnp.transpose(v_emb, (0, 2, 1)),
                left_side=True, lower=True,
            )                                                    # [F, 2C, D]
            denom = jnp.sum(y * y, axis=1)                       # [F, D]
            per_bin = binw_local[:, None] / jnp.maximum(denom, 1e-20)
            powers = jnp.sum(per_bin, axis=0)                    # [D]
            if axis_name is not None:
                powers = jax.lax.psum(powers, axis_name)
            return powers

        if weight_refresh <= 1:
            powers = solve(None)
            carried = None
        else:
            # The predicate is replicated under shard_map, so every shard
            # takes the same branch and the in-branch psum stays uniform.
            powers = jax.lax.cond(
                jnp.mod(state.count, weight_refresh) == 0,
                solve,
                lambda _: state.powers,
                None,
            )
            carried = powers
        new_state = MvdrState(cov_re=cov_re, cov_im=cov_im,
                              count=state.count + 1, powers=carried)
        return new_state, powers

    return impl


def make_mvdr_step(
    points,
    theta,
    phi,
    array_cfg: ArrayConfig = ArrayConfig(),
    frame_size: int = 64,
    hop: int = 32,
    f_low: float = 550.0,
    f_high: float = 9000.0,
    ema_alpha: float = 0.1,
    diagonal_loading: float = 1e-3,
    channel_mask=None,
    weight_refresh: int = 1,
):
    """Build the jitted per-block MVDR update.

    Returns ``(step, n_bins)`` with ``step(state, block[C, T]) ->
    (state, powers[D])``.  Runs on the default device (complex-free
    throughout).

    ``weight_refresh`` k > 1 recomputes the Capon solve only every k-th
    block (the EMA covariance still updates every block) — see
    ``_make_mvdr_impl``.  State must then come from ``step.init()`` (it
    carries the [D] spectrum between refreshes).
    """
    bins = select_bins(frame_size, array_cfg.sample_rate, f_low, f_high)
    freqs = np.fft.rfftfreq(frame_size, 1.0 / array_cfg.sample_rate)[bins]
    v = jnp.asarray(steering_matrix(points, theta, phi, freqs, array_cfg))
    dft_t = jnp.asarray(dft_tables(frame_size, bins))
    mask = (
        None if channel_mask is None else jnp.asarray(channel_mask, jnp.float32)
    )

    impl = _make_mvdr_impl(
        frame_size, hop, mask, ema_alpha, diagonal_loading,
        weight_refresh=int(weight_refresh),
    )
    binw = jnp.ones((len(bins),), jnp.float32)

    # Model operands stay explicit jit arguments: a closed-over device
    # array would be embedded into the compiled program as a literal
    # constant.
    jitted = jax.jit(impl)

    def step(state: MvdrState, block):
        return jitted(state, jnp.asarray(block, jnp.float32), v, dft_t, binw)

    step.scan = _attach_scan(impl, (v, dft_t, binw))
    c = int(np.asarray(points).shape[1])
    d = int(np.asarray(theta).size)
    step.init = lambda: mvdr_init(
        len(bins), c, d if weight_refresh > 1 else None
    )
    return step, len(bins)


def _attach_scan(impl, operands):
    """``scan(state, blocks[, n]) -> (state, powers[n, D])`` for a per-block
    impl — the whole sequence as ONE device program (no per-block host
    round-trips).  ``n`` beyond ``blocks.shape[0]``
    cycles the pool (benchmark shape)."""

    @functools.partial(jax.jit, static_argnums=(2,))
    def scan_n(state, blocks, n, *ops):
        k = blocks.shape[0]

        def body(carry, i):
            carry, p = impl(carry, blocks[i % k], *ops)
            return carry, p

        return jax.lax.scan(body, state, jnp.arange(n))

    def scan(state, blocks, n: int | None = None):
        blocks = jnp.asarray(blocks, jnp.float32)
        n = int(blocks.shape[0]) if n is None else n
        return scan_n(state, blocks, n, *operands)

    return scan


def make_sharded_mvdr_step(
    points,
    theta,
    phi,
    mesh,
    axis_name: str = "dir",
    array_cfg: ArrayConfig = ArrayConfig(),
    frame_size: int = 64,
    hop: int = 32,
    f_low: float = 550.0,
    f_high: float = 9000.0,
    ema_alpha: float = 0.1,
    diagonal_loading: float = 1e-3,
    channel_mask=None,
    weight_refresh: int = 1,
):
    """Bin-sharded MVDR (the "STFT bins across the pod" stretch config).

    Returns ``(step, state)``: bins pad up to the shard count (padding bins
    carry zero weight), the per-bin covariance EMA lives sharded on its
    shard, and only the [D] Capon powers cross the mesh (one psum).
    ``weight_refresh`` decimates the solve stage exactly as in
    :func:`make_mvdr_step` (the carried spectrum is replicated).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = dict(zip(mesh.axis_names, mesh.devices.shape))[axis_name]
    bins = select_bins(frame_size, array_cfg.sample_rate, f_low, f_high)
    pad = (-len(bins)) % n_shards
    bins_p = np.concatenate([bins, np.repeat(bins[-1:], pad)])
    binw_p = np.concatenate(
        [np.ones(len(bins), np.float32), np.zeros(pad, np.float32)]
    )
    freqs = np.fft.rfftfreq(frame_size, 1.0 / array_cfg.sample_rate)[bins_p]
    v = steering_matrix(points, theta, phi, freqs, array_cfg)
    dft_np = dft_tables(frame_size, bins_p)
    mask = None if channel_mask is None else jnp.asarray(channel_mask, jnp.float32)

    weight_refresh = int(weight_refresh)
    impl = _make_mvdr_impl(
        frame_size, hop, mask, ema_alpha, diagonal_loading,
        axis_name=axis_name, weight_refresh=weight_refresh,
    )
    f_pad = len(bins_p)
    c = np.asarray(points).shape[1]
    d = int(np.asarray(theta).size)
    powers_spec = P() if weight_refresh > 1 else None

    state_spec = MvdrState(
        cov_re=P(axis_name, None, None),
        cov_im=P(axis_name, None, None),
        count=P(),
        powers=powers_spec,
    )
    sharded = jax.shard_map(
        impl,
        mesh=mesh,
        in_specs=(state_spec, P(None, None), P(None, axis_name, None, None),
                  P(None, None, axis_name), P(axis_name)),
        out_specs=(state_spec, P()),
    )
    v_dev = jax.device_put(
        jnp.asarray(v), NamedSharding(mesh, P(None, axis_name, None, None))
    )
    dft_dev = jax.device_put(
        jnp.asarray(dft_np), NamedSharding(mesh, P(None, None, axis_name))
    )
    binw_dev = jax.device_put(
        jnp.asarray(binw_p), NamedSharding(mesh, P(axis_name))
    )
    jitted = jax.jit(sharded)

    def step(state, block):
        return jitted(state, block, v_dev, dft_dev, binw_dev)

    step._jitted = jitted
    step._operands = (v_dev, dft_dev, binw_dev)

    cov_shard = NamedSharding(mesh, P(axis_name, None, None))
    state = MvdrState(
        cov_re=jax.device_put(
            jnp.broadcast_to(jnp.eye(c, dtype=jnp.float32), (f_pad, c, c)),
            cov_shard,
        ),
        cov_im=jax.device_put(jnp.zeros((f_pad, c, c), jnp.float32), cov_shard),
        count=jnp.zeros((), jnp.int32),
        powers=(
            None if weight_refresh <= 1
            else jax.device_put(
                jnp.zeros((d,), jnp.float32), NamedSharding(mesh, P())
            )
        ),
    )
    return step, state
