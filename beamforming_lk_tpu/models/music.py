"""Wideband (incoherent) MUSIC direction-of-arrival estimation — complex-free.

Third beamforming family beyond the reference's time-domain DAS (and this
framework's MVDR/Capon): subspace DOA.  Per frequency bin, the EMA spatial
covariance (same re/im-plane state machinery as :mod:`models.mvdr`) is
eigendecomposed; the noise subspace — orthogonal to the K source steering
vectors — makes the pseudo-spectrum

    P[d] = sum_f  1 / || En[f]^H v[f, d] ||^2

spike sharply at source directions, with resolution far beyond the
aperture's beamwidth (super-resolution).  Incoherent wideband combining:
bins are averaged after the per-bin pseudo-spectrum, the standard
incoherent-MUSIC recipe.

Complex-free: the Hermitian covariance
``R = Re + i Im`` is embedded as the real symmetric ``M = [[Re, -Im],
[Im, Re]]`` whose eigenvalues are R's, each doubled, and whose eigenspaces
are the embeddings of R's — so the noise projector of ``M`` (the 2(C-K)
weakest eigenvectors) computes exactly the complex noise-projection norm:
``||En^H v||^2 = || Ên^T v_emb ||^2``.

Two solvers:

- ``solver="subspace"`` (default, the streaming design): instead of a
  full batched ``eigh`` of the [F, 2C, 2C] embedding per block — QR
  iterations XLA serializes — track only the
  2K-dimensional SIGNAL subspace with warm-started orthogonal iteration:
  the state carries last block's orthonormal basis, and because the EMA
  covariance moves slowly per block, 2 multiply+QR rounds/block keep it
  converged (a cold start gets extra rounds).  The noise-projection norm
  uses the complement identity ``||En^T a||^2 = ||a||^2 - ||Es^T a||^2``,
  so the per-direction projection stage also shrinks from 2(C-K) to 2K
  columns (~20x fewer MACs at K=3, C=64).
- ``solver="eigh"``: the exact full eigendecomposition (used as truth in
  tests; tests/test_music.py pins subspace-vs-eigh spectrum parity).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.config import ArrayConfig
from beamforming_lk_tpu.models.mvdr import (
    _attach_scan,
    _snapshot_covariance,
    _stft_snapshots,
    dft_tables,
    hermitian_embed,
    select_bins,
    steering_matrix,
)


class MusicState(NamedTuple):
    cov_re: jnp.ndarray  # [F, C, C] float32, symmetric plane of R
    cov_im: jnp.ndarray  # [F, C, C] float32, antisymmetric plane of R
    count: jnp.ndarray   # [] int32 blocks folded in
    basis: jnp.ndarray   # [F, 2C, 2K] warm-started signal-subspace basis
    #                      (carried untouched by the eigh solver)


def music_init(
    n_bins: int, channels: int, n_sources: int = 3
) -> MusicState:
    """``n_sources`` must match ``make_music_step``'s K when the (default)
    subspace solver is used — it sizes the carried basis."""
    eye = jnp.eye(channels, dtype=jnp.float32)
    basis0 = jnp.eye(2 * channels, dtype=jnp.float32)[:, : 2 * n_sources]
    return MusicState(
        cov_re=jnp.broadcast_to(eye, (n_bins, channels, channels)).astype(
            jnp.float32
        ),
        cov_im=jnp.zeros((n_bins, channels, channels), jnp.float32),
        count=jnp.zeros((), jnp.int32),
        basis=jnp.broadcast_to(
            basis0, (n_bins, 2 * channels, 2 * n_sources)
        ).astype(jnp.float32),
    )


def make_music_step(
    points,
    theta,
    phi,
    array_cfg: ArrayConfig = ArrayConfig(),
    n_sources: int = 3,
    frame_size: int = 64,
    hop: int = 32,
    f_low: float = 550.0,
    f_high: float = 9000.0,
    ema_alpha: float = 0.1,
    channel_mask=None,
    solver: str = "subspace",
    subspace_iters: int = 2,
):
    """Build the jitted per-block MUSIC update.

    Returns ``(step, n_bins)`` with ``step(state, block[C, T]) ->
    (state, pseudo[D])``.  ``n_sources`` is the assumed model order K (the
    noise subspace spans the C−K weakest eigenvectors; overestimating K a
    little is benign, underestimating merges nearby sources).

    ``solver``: "subspace" (default — warm-started orthogonal iteration on
    the carried signal basis, ``subspace_iters`` rounds/block; see module
    docstring) or "eigh" (exact full eigendecomposition).
    """
    bins = select_bins(frame_size, array_cfg.sample_rate, f_low, f_high)
    freqs = np.fft.rfftfreq(frame_size, 1.0 / array_cfg.sample_rate)[bins]
    v = jnp.asarray(steering_matrix(points, theta, phi, freqs, array_cfg))
    dft_t = jnp.asarray(dft_tables(frame_size, bins))
    mask = (
        None if channel_mask is None else jnp.asarray(channel_mask, jnp.float32)
    )
    c = int(np.asarray(points).shape[1])
    k = int(n_sources)
    if not 0 < k < c:
        raise ValueError(f"n_sources must be in (0, {c}), got {k}")
    if solver not in ("subspace", "eigh"):
        raise ValueError(f"solver must be 'subspace' or 'eigh', got {solver!r}")

    impl = _make_music_impl(
        frame_size, hop, mask, ema_alpha, c, k, solver, subspace_iters
    )
    jitted = jax.jit(impl)

    def step(state: MusicState, block):
        return jitted(state, jnp.asarray(block, jnp.float32), v, dft_t)

    step.scan = _attach_scan(impl, (v, dft_t))
    # Matching initial state (the carried basis is sized by K — init with
    # a different n_sources than the step is a model-order mismatch).
    step.init = lambda: music_init(len(bins), c, k)
    return step, len(bins)


def _make_music_impl(
    frame_size, hop, mask, ema_alpha, c, k, solver="subspace",
    subspace_iters=2, axis_name=None,
):
    """Per-block MUSIC update with operands (steering planes, DFT tables)
    as explicit arguments — shared by :func:`make_music_step` and the
    estimator benchmark (which builds the 95 MB steering planes on device).

    ``axis_name`` marks the bin axis as a mesh shard
    (:func:`make_sharded_music_step`): the SNR bin-weight normalization
    and the final pseudo-spectrum sum become psums; ``binw_local`` (an
    optional trailing operand, 0 for padding bins) keeps padded shards
    silent."""
    n_noise = 2 * (c - k)
    hi = jax.lax.Precision.HIGHEST

    def _eigh_subspaces(m, state):
        # Exact path: full ascending eigendecomposition of the embedding;
        # R's eigenvalues each appear twice, the last 2K eigenvectors span
        # (the embedding of) the signal subspace.  The noise basis En (the
        # first 2(C-K) eigenvectors) is returned too: the truth path keeps
        # the DIRECT noise-projection norm ||En^T v||^2, which retains full
        # f32 precision near spectrum peaks where the complement identity
        # ||v||^2 - ||Es^T v||^2 cancels catastrophically (||v||^2 ~ 2C, so
        # the difference floors at ~C*eps absolute).
        vals, vecs = jnp.linalg.eigh(m)              # [F, 2C], [F, 2C, 2C]
        en = vecs[..., :n_noise]                     # [F, 2C, 2(C-K)]
        sig_vals = vals[..., n_noise:]               # [F, 2K]
        noise_mean = jnp.mean(vals[..., :n_noise], axis=-1)        # [F]
        return en, sig_vals, noise_mean, state.basis

    def _tracked_subspaces(m, state):
        # Streaming path: warm-started orthogonal (subspace) iteration on
        # last block's basis.  The EMA covariance moves O(alpha) per block,
        # so a couple of multiply+QR rounds keep the 2K-dim signal basis
        # converged; a cold start (count==0, basis = identity columns)
        # gets extra rounds.
        def rounds(n):
            def body(_, q):
                z = jnp.einsum("fab,fbk->fak", m, q, precision=hi)
                q, _ = jnp.linalg.qr(z)
                return q
            return jax.lax.fori_loop(0, n, body, state.basis)

        q = jax.lax.cond(
            state.count > 0,
            lambda: rounds(subspace_iters),
            lambda: rounds(max(subspace_iters, 8)),
        )
        mq = jnp.einsum("fab,fbk->fak", m, q, precision=hi)
        sig_vals = jnp.einsum(
            "fak,fak->fk", q, mq, precision=hi
        )                                            # Rayleigh quotients
        trace = jnp.trace(m, axis1=-2, axis2=-1)     # [F]
        noise_mean = (trace - jnp.sum(sig_vals, axis=-1)) / n_noise
        return q, sig_vals, noise_mean, q

    def impl(state: MusicState, block, v_local, dft_local, binw_local=None):
        xr, xi, n_frames = _stft_snapshots(block, dft_local, frame_size, hop, mask)
        r_re, r_im = _snapshot_covariance(xr, xi, n_frames)
        warm = state.count > 0
        alpha = jnp.where(warm, ema_alpha, 1.0).astype(jnp.float32)
        cov_re = (1.0 - alpha) * state.cov_re + alpha * r_re
        cov_im = (1.0 - alpha) * state.cov_im + alpha * r_im

        m = hermitian_embed(cov_re, cov_im)          # [F, 2C, 2C]
        v_emb = jnp.concatenate([v_local[0], v_local[1]], axis=-1)  # [F, D, 2C]
        if solver == "eigh":
            # Truth path: direct noise-projection norm ||En^T v||^2 — full
            # f32 precision (no cancellation), affordable because eigh is
            # the slow exact solver anyway.
            en, sig_vals, noise_mean, basis = _eigh_subspaces(m, state)
            yn = jnp.einsum(
                "fck,fdc->fdk", en, v_emb, precision=hi
            )                                            # [F, D, 2(C-K)]
            denom = jnp.sum(yn * yn, axis=-1)
        else:
            es, sig_vals, noise_mean, basis = _tracked_subspaces(m, state)
            # Streaming path: complement identity ||En^T a||^2 =
            # ||a||^2 - ||Es^T a||^2 (equals the complex ||En^H v||^2 — the
            # projector is basis-independent per eigenspace).  2K columns
            # instead of 2(C-K): ~20x fewer MACs at K=3, C=64.  The
            # subtraction cancels catastrophically near peaks (||v||^2 ~ 2C),
            # so the floor below reflects the real f32 resolution ~C*eps
            # rather than pretending to 1e-12.
            y = jnp.einsum(
                "fck,fdc->fdk", es, v_emb, precision=hi
            )                                            # [F, D, 2K]
            denom = jnp.sum(v_emb * v_emb, axis=-1) - jnp.sum(y * y, axis=-1)
        # SNR-weighted incoherent combining: weight each bin by its signal
        # eigenvalue mass above the noise floor, so noise-only bins (whose
        # "noise subspace" is random) do not dilute narrowband sources.
        # (Doubled embedding eigenvalues cancel in the normalization.)
        sig = jnp.maximum(
            jnp.sum(sig_vals, axis=-1) - 2 * k * noise_mean, 0.0
        )
        if binw_local is not None:
            sig = sig * binw_local
        total_sig = jnp.sum(sig)
        if axis_name is not None:
            total_sig = jax.lax.psum(total_sig, axis_name)
        w = sig / jnp.maximum(total_sig, 1e-30)                    # [F]
        # Denominator floor: the eigh truth path's direct norm resolves down
        # to underflow; the subspace path's complement subtraction cannot
        # resolve below ~2C*eps_f32 absolute, so clamp there.
        floor = 1e-12 if solver == "eigh" else 2.0 * c * float(
            np.finfo(np.float32).eps
        )
        pseudo = jnp.sum(w[:, None] / jnp.maximum(denom, floor), axis=0)
        if axis_name is not None:
            pseudo = jax.lax.psum(pseudo, axis_name)
        new_state = MusicState(cov_re=cov_re, cov_im=cov_im,
                               count=state.count + 1, basis=basis)
        return new_state, pseudo

    return impl


def make_sharded_music_step(
    points,
    theta,
    phi,
    mesh,
    axis_name: str = "dir",
    array_cfg: ArrayConfig = ArrayConfig(),
    n_sources: int = 3,
    frame_size: int = 64,
    hop: int = 32,
    f_low: float = 550.0,
    f_high: float = 9000.0,
    ema_alpha: float = 0.1,
    channel_mask=None,
    solver: str = "subspace",
    subspace_iters: int = 2,
):
    """Bin-sharded wideband MUSIC (the estimator twin of
    :func:`models.mvdr.make_sharded_mvdr_step`).

    Returns ``(step, state)``: bins pad up to the shard count (padding bins
    carry zero SNR weight), the per-bin covariance EMA *and* the tracked
    signal basis live sharded on their shard, and only the [D]
    pseudo-spectrum plus the scalar SNR normalizer cross the mesh (two
    psums).  Bins are embarrassingly parallel, so this scales the per-bin
    decomposition (eigh or subspace iteration) linearly.
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
    c = int(np.asarray(points).shape[1])
    k = int(n_sources)
    if not 0 < k < c:
        raise ValueError(f"n_sources must be in (0, {c}), got {k}")
    if solver not in ("subspace", "eigh"):
        raise ValueError(f"solver must be 'subspace' or 'eigh', got {solver!r}")

    impl = _make_music_impl(
        frame_size, hop, mask, ema_alpha, c, k, solver, subspace_iters,
        axis_name=axis_name,
    )
    f_pad = len(bins_p)

    state_spec = MusicState(
        cov_re=P(axis_name, None, None),
        cov_im=P(axis_name, None, None),
        count=P(),
        basis=P(axis_name, None, None),
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

    init = music_init(f_pad, c, k)
    state = MusicState(
        cov_re=jax.device_put(
            init.cov_re, NamedSharding(mesh, P(axis_name, None, None))
        ),
        cov_im=jax.device_put(
            init.cov_im, NamedSharding(mesh, P(axis_name, None, None))
        ),
        count=init.count,
        basis=jax.device_put(
            init.basis, NamedSharding(mesh, P(axis_name, None, None))
        ),
    )
    return step, state
