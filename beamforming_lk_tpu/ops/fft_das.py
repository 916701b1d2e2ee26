"""Separable frequency-domain DAS heatmap for lattice apertures.

The dense shift-matmul heatmap (:mod:`ops.delay`) does ``D*C*S*T`` MACs per
block — a one-hot stencil wastes a factor ``S/taps`` (~32x) to run as one
dense matmul.
For the configurations that actually occur — planar *rectangular-lattice*
microphone arrays (every reference array is an 8x8 grid,
``src/geometry/antenna.cpp:60-87``; clusters at array pitch are bigger
lattices) steered over the heatmap's sin-projected *tensor* direction grid
(``src/dsp/mimo.cpp:20-59``) — the DAS sum factors exactly:

    tau[d, c] = fs/c * (u_x[dx] * x[cx]  -  u_y[dy] * y[cy])

so in the frequency domain the steering phase is a tensor product and the
beamform becomes two tiny transforms (a "2-D zoom DFT"):

    X[cy, cx, f]  = DFT_t(window)                   # [L, F] cos/sin matmul
    B1[dx, cy, f] = sum_cx Ex[f, dx, cx] X[..]      # D_x x C_x per bin
    B2[dy, dx, f] = sum_cy Ey[f, dy, cy] B1[..]     # D_y x C_y per bin
    beam[d, t]    = iDFT_f(B2)[:T]                  # [F, T] cos/sin matmul

Work drops from ``D*C*S*T`` (~7e10 at the 256-mic x 65x65 north-star
config) to ``F*(Dx*Cx*Cy + D*Cy) + D*F*T`` (~1e9) — and fractional delays
become *exact* (band-limited sinc) instead of 2-tap linear interpolation.
The min-subtraction per direction (antenna.cpp:89-97) is itself separable
(min of a separable function over a lattice splits per axis) and is folded
into ``Ex``/``Ey`` so the time alignment matches the dense kernel's window
convention exactly — including the reference's backwards-interp one-sample
quirk (delay.cpp:24).

**No complex dtypes**: the DFTs are explicit cos/sin matrices and every
spectrum is an (re, im) pair of float32 planes, so every stage is a real
matmul (bf16-capable: ``compute="bfloat16"`` runs the matmuls with bf16
inputs / f32 accumulation; float32 runs them at HIGHEST precision).
Whether complex64 with ``jnp.fft`` is faster on the GPU is an open
question.

Out-of-disc heatmap corner pixels (the reference clamps them onto the FOV
disc edge, mimo.cpp:36-43) are not on the tensor grid; they are filled from
the nearest on-disc pixel by a static gather — within one pixel pitch of
the reference's clamped direction.

Dead channels from calibration are removed by *subtracting* their rank-1
contribution (``Ex[:, :, cx0] (x) Ey[:, :, cy0] (x) X[c0]``) — exact for
binary masks; non-binary gain masks fall back to the dense kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.ops import delay as dl


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Rectangular-lattice factorization of a planar element cloud."""

    x: np.ndarray      # [Cx] sorted unique x coordinates
    y: np.ndarray      # [Cy] sorted unique y coordinates
    perm: np.ndarray   # [Cy*Cx] channel index at lattice site (iy, ix), row-major


def lattice_factorization(points, tol: float = 1e-5) -> Optional[Lattice]:
    """Detect whether ``points [3, C]`` form a complete planar rectangular
    lattice (z = const, every (x, y) pair present exactly once).

    Returns None when the cloud does not factor (then use the dense kernel).
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[0] != 3 or pts.shape[1] == 0:
        return None
    if np.ptp(pts[2]) > tol:
        return None  # not planar
    c = pts.shape[1]

    def _unique(v):
        sv = np.sort(v)
        edges = np.nonzero(np.diff(sv) > tol)[0]
        reps = np.concatenate([[sv[0]], sv[edges + 1]])
        return reps

    ux, uy = _unique(pts[0]), _unique(pts[1])
    if len(ux) * len(uy) != c:
        return None
    ix = np.argmin(np.abs(pts[0][None, :] - ux[:, None]), axis=0)
    iy = np.argmin(np.abs(pts[1][None, :] - uy[:, None]), axis=0)
    if np.max(np.abs(pts[0] - ux[ix])) > tol or np.max(np.abs(pts[1] - uy[iy])) > tol:
        return None
    site = iy * len(ux) + ix
    if len(np.unique(site)) != c:
        return None  # duplicate sites
    perm = np.empty(c, np.int64)
    perm[site] = np.arange(c)
    return Lattice(x=ux, y=uy, perm=perm)


def _grid_axes(mimo_cfg):
    """The heatmap's per-axis direction components (u_x[cols], u_y[rows]) —
    the tensor factors of make_mimo_grid's sin-projected pixel map."""
    fov = np.radians(mimo_cfg.fov_degrees)
    rows, cols = mimo_cfg.rows, mimo_cfg.columns
    sep_r = np.sin(fov / 2.0) / (rows / 2.0)
    sep_c = np.sin(fov / 2.0) / (cols / 2.0)
    uy = np.arange(rows) * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
    ux = np.arange(cols) * sep_c - cols * sep_c / 2.0 + sep_c / 2.0
    return ux, uy


def _offdisc_gather(mimo_cfg) -> Optional[np.ndarray]:
    """[D] source index map: identity on the FOV disc, nearest on-disc
    pixel for the clamped corner pixels (mimo.cpp:36-43 analog)."""
    ux, uy = _grid_axes(mimo_cfg)
    rows, cols = mimo_cfg.rows, mimo_cfg.columns
    yy, xx = np.meshgrid(uy, ux, indexing="ij")
    norm = np.hypot(xx, yy)
    src = np.arange(rows * cols, dtype=np.int64)
    out = norm.reshape(-1) > 1.0
    if not out.any():
        return None
    # Radially project the out-of-disc pixel onto the disc, then take the
    # nearest ON-disc grid pixel (a plain snap can land on another
    # out-of-disc pixel just past the rim).
    n = norm.reshape(-1)[out]
    px = xx.reshape(-1)[out] / n
    py = yy.reshape(-1)[out] / n
    in_idx = np.nonzero(~(norm.reshape(-1) > 1.0))[0]
    gx = xx.reshape(-1)[in_idx]
    gy = yy.reshape(-1)[in_idx]
    d2 = (gx[None, :] - px[:, None]) ** 2 + (gy[None, :] - py[:, None]) ** 2
    src[out] = in_idx[d2.argmin(axis=1)]
    return src


@dataclasses.dataclass(frozen=True)
class FftHeatmapModel:
    """Static operands of the separable frequency-domain heatmap.

    Spectra are (re, im) float32 plane pairs — no complex dtypes (see
    module docstring).  The forward/inverse DFTs carry re and im stacked
    along one axis so each is a single matmul, and the channel → lattice
    permutation is either folded away (identity) or applied as a one-hot
    matmul.
    """

    #: [F, Dx, 2Cx] = [cos | sin] of the x-axis steering phase — re and im
    #: pre-stacked along the contracted axis so each steering stage is ONE
    #: einsum over a doubled batch (see :func:`_steered_spectra`).
    ex_s: jax.Array
    ey_s: jax.Array             # [F, Dy, 2Cy], same layout
    dft: jax.Array              # [L, 2F] = [cos | -sin] forward DFT
    idft: jax.Array             # [2F, T] = [w cos / L ; -w sin / L] inverse
    perm_matrix: Optional[jax.Array]  # [C, C] one-hot site<-channel, or None
    src_map: Optional[jax.Array]  # [D] out-of-disc gather (None if all in)
    dead: Optional[tuple]       # (xre, xim [F,Dx,Nd], yre, yim [F,Dy,Nd], chan)
    rows: int
    columns: int
    block_size: int
    fft_len: int
    n_active: float
    use_bandpass: bool
    compute: str = "float32"    # matmul input dtype ("float32" | "bfloat16")
    phat: bool = False          # SRP-PHAT: whiten spectra to unit magnitude
    band_weight: Optional[jax.Array] = None  # [F] per-bin weight (PHAT band)
    #: [2F, T-2] power matrix — the inverse DFT restricted to the block
    #: with the 3-tap bandpass folded into its columns AND the power
    #: normalization ``1/sqrt(T * n_active)``
    #: folded into its scale, so block power is exactly
    #: ``rowsum((b2s^T @ pow_ri)^2)`` and the [D, T] beam never exists.
    #: See :func:`fft_heatmap_powers`.
    pow_ri: Optional[jax.Array] = None
    #: Which final power stage to run: "fused" (default; frequency-side
    #: power matmul + square-reduce), "beam" (materialize the [D, T] beam
    #: then ops.delay.das_power — the reference formulation, kept for
    #: debugging and for consumers that want the beams themselves).
    power_path: str = "fused"
    #: Set when the model was built with ``assume_lattice_order=True`` on a
    #: non-trivially-permuted aperture: window row ``s`` must be channel
    #: ``channel_perm[s]`` (callers reorder blocks host-side; ``None`` when
    #: channel order already IS lattice order or no promise was made).
    channel_perm: Optional[np.ndarray] = None


def make_fft_heatmap_model(
    points,
    mimo_cfg,
    dsp_cfg,
    array_cfg,
    channel_mask=None,
    compute: Optional[str] = None,
    phat_band=(550.0, 9000.0),
    power_path: str = "fused",
    assume_lattice_order: bool = False,
) -> Optional[FftHeatmapModel]:
    """Precompute the separable steering factors, or None if this
    configuration does not factor (non-lattice points / gain masks).

    ``assume_lattice_order=True`` promises that window rows arrive already
    in lattice-site order (row ``s`` = channel ``model.channel_perm[s]``) —
    the per-block permutation matmul disappears.  Ingestion can provide
    this ordering for free (a host-side row reorder of each block), which
    saves a [C, C] x [C, 2F] matmul per block on clustered apertures.
    """
    lat = lattice_factorization(points)
    if lat is None:
        return None
    mask = None
    if channel_mask is not None:
        mask = np.asarray(channel_mask, np.float64)
        binary = np.all((mask < 1e-12) | (np.abs(mask - 1.0) < 1e-6))
        if not binary:
            return None  # gain masks are not rank-1-correctable
    taps = dl.LINEAR_TAPS if dsp_cfg.interp == "linear" else dsp_cfg.fir_taps
    s, t = dsp_cfg.shift_range, dsp_cfg.block_size
    L = s + t
    spm = array_cfg.samples_per_meter
    ux, uy = _grid_axes(mimo_cfg)

    # Window convention (ops/delay.py): beam[t] reads window position
    # t + (S - taps) - tau[d, c]; tau = raw - min_d with
    # raw = spm * (ux*x - uy*y)  [steering row u = (sin t cos p,
    # -sin t sin p, cos t), antenna.cpp:99-107 — note the MINUS on y].
    # The advance Delta = (S - taps) + 1 - tau is a phase
    # exp(+2i pi f Delta / L) on rfft bins (the +1 reproduces the
    # reference's backwards-interp quirk, delay.cpp:24, which the dense
    # kernel matches); min_d = mx[dx] + my[dy] splits per axis, so fold
    # (S - taps + 1) + mx into Ex and my into Ey.
    f = np.arange(L // 2 + 1, dtype=np.float64)
    raw_x = spm * np.outer(ux, lat.x)                 # [Dx, Cx]
    raw_y = -spm * np.outer(uy, lat.y)                # [Dy, Cy]
    mx = raw_x.min(axis=1, keepdims=True)             # [Dx, 1]
    my = raw_y.min(axis=1, keepdims=True)             # [Dy, 1]
    # Alignment offset: the dense linear path effectively delays by
    # tau - 1 (the backwards-interp quirk above), the polyphase-FIR path
    # by tau - center (the bank reconstructs x(n + center - frac),
    # ops/delay.py) — match whichever interp this config uses.
    offset = 1.0 if dsp_cfg.interp == "linear" else dl.FIR_DEFAULT_CENTER
    dx_shift = (s - taps) + offset + mx - raw_x       # [Dx, Cx]
    dy_shift = my - raw_y                             # [Dy, Cy]
    ang_x = 2.0 * np.pi * f[:, None, None] * dx_shift[None] / L
    ang_y = 2.0 * np.pi * f[:, None, None] * dy_shift[None] / L

    def _stacked(a):
        # [F, D_axis, 2C_axis] = [cos | sin] along the contracted axis.
        return jnp.asarray(
            np.concatenate([np.cos(a), np.sin(a)], axis=-1), jnp.float32
        )

    ex_s, ey_s = _stacked(ang_x), _stacked(ang_y)

    # Forward DFT (rfft) as one [L, 2F] cos|-sin matrix: X_ri = x @ dft.
    n_t = np.arange(L, dtype=np.float64)[:, None]
    w_ang = 2.0 * np.pi * n_t * f[None, :] / L        # [L, F]
    dft = jnp.asarray(
        np.concatenate([np.cos(w_ang), -np.sin(w_ang)], axis=1), jnp.float32
    )
    # Weighted inverse (irfft restricted to the first T output samples):
    # beam[t] = sum_f wt_f (B_re cos(2 pi f t / L) - B_im sin(..)) / L,
    # wt = [1, 2, ..., 2, 1(if L even)] — stacked [2F, T] so the whole
    # inverse is ONE matmul against [B_re | B_im].
    wt = np.full(len(f), 2.0)
    wt[0] = 1.0
    if L % 2 == 0:
        wt[-1] = 1.0
    t_out = np.arange(t, dtype=np.float64)[None, :]
    i_ang = 2.0 * np.pi * f[:, None] * t_out / L      # [F, T]
    idft_np = np.concatenate(
        [np.cos(i_ang) * wt[:, None] / L, -np.sin(i_ang) * wt[:, None] / L],
        axis=0,
    )
    idft = jnp.asarray(idft_np, jnp.float32)
    # Power matrix: fold the 3-tap bandpass (delay.py:bandpass_ma) into the
    # inverse-DFT columns, in float64.
    if dsp_cfg.use_bandpass:
        pow_np = 0.5 * idft_np[:, 1:-1] - 0.25 * (idft_np[:, 2:] + idft_np[:, :-2])
    else:
        pow_np = idft_np

    dead = None
    n_active = float(points.shape[1])
    if mask is not None:
        dead_chan = np.nonzero(mask < 0.5)[0]
        n_active = float(points.shape[1] - len(dead_chan))
        if len(dead_chan):
            # Lattice site of each dead channel: perm[site] = channel.
            site_of_chan = np.empty_like(lat.perm)
            site_of_chan[lat.perm] = np.arange(len(lat.perm))
            sites = site_of_chan[dead_chan]
            cxs, cys = sites % len(lat.x), sites // len(lat.x)
            # Window row of each dead channel: the site row when the caller
            # pre-permutes, the raw channel row otherwise.
            dead_rows = sites if assume_lattice_order else dead_chan
            dead = (
                jnp.asarray(np.cos(ang_x[:, :, cxs]), jnp.float32),
                jnp.asarray(np.sin(ang_x[:, :, cxs]), jnp.float32),
                jnp.asarray(np.cos(ang_y[:, :, cys]), jnp.float32),
                jnp.asarray(np.sin(ang_y[:, :, cys]), jnp.float32),
                jnp.asarray(dead_rows),
            )
    # Fold the power normalization into the (f32) power matrix once —
    # powers = rowsum((b2s @ pow_ri)^2) with no epilogue divide.
    pow_ri = jnp.asarray(pow_np / np.sqrt(t * max(n_active, 1.0)), jnp.float32)
    perm_matrix = None
    channel_perm = None
    identity_perm = np.array_equal(lat.perm, np.arange(len(lat.perm)))
    if assume_lattice_order:
        channel_perm = None if identity_perm else lat.perm.copy()
    elif not identity_perm:
        pm = np.zeros((len(lat.perm), len(lat.perm)), np.float32)
        pm[np.arange(len(lat.perm)), lat.perm] = 1.0   # row site, col channel
        perm_matrix = jnp.asarray(pm)
    return FftHeatmapModel(
        ex_s=ex_s,
        ey_s=ey_s,
        dft=dft,
        idft=idft,
        perm_matrix=perm_matrix,
        src_map=(lambda m: None if m is None else jnp.asarray(m))(
            _offdisc_gather(mimo_cfg)
        ),
        dead=dead,
        rows=mimo_cfg.rows,
        columns=mimo_cfg.columns,
        block_size=t,
        fft_len=L,
        n_active=n_active,
        use_bandpass=dsp_cfg.use_bandpass,
        compute=compute or "float32",
        phat=bool(getattr(mimo_cfg, "phat", False)),
        band_weight=(
            jnp.asarray(
                (
                    (f * array_cfg.sample_rate / L >= phat_band[0])
                    & (f * array_cfg.sample_rate / L <= phat_band[1])
                ).astype(np.float32)
            )
            if getattr(mimo_cfg, "phat", False)
            else None
        ),
        pow_ri=pow_ri,
        power_path=power_path,
        channel_perm=channel_perm,
    )


def _steered_spectra(window, model: FftHeatmapModel, mm):
    """The separable steering stages.

    Returns ``(b2_re, b2_im)`` each [Dy, Dx, F] — per-direction beam
    spectra, direction-major so the final power/beam matmul contracts over
    the LHS minor axis.

    Each complex contraction runs as ONE einsum: re and im of the steering
    factor are pre-stacked along the contracted axis (``model.ex_s/ey_s``)
    and the re/im *outputs* ride a doubled batch row — same FLOPs as two
    einsums, half the dispatches.
    """
    cx = model.ex_s.shape[-1] // 2
    cy = model.ey_s.shape[-1] // 2
    f_half = model.dft.shape[-1] // 2

    # Forward DFT, re|im in one matmul; permutation (if any) as a one-hot
    # matmul on the (smaller) spectrum.
    x_ri = mm("ct,tf->cf", window, model.dft)               # [C, 2F]
    if model.perm_matrix is not None:
        x_ri = mm("sc,cf->sf", model.perm_matrix, x_ri)
    x = x_ri.reshape(cy, cx, 2, f_half)
    x_re, x_im = x[..., 0, :], x[..., 1, :]                 # [Cy, Cx, F]
    if model.phat:
        # SRP-PHAT whitening: keep only phase per (channel, bin) so the
        # steered response depends on arrival-time structure, not spectral
        # color — robust to reverberation and loud narrowband sources.
        mag = jnp.sqrt(x_re * x_re + x_im * x_im) + 1e-12
        x_re = x_re / mag
        x_im = x_im / mag
        if model.band_weight is not None:
            # Restrict to the band of interest (the reference's 550-9000 Hz
            # filter envelope) — whitened out-of-band bins carry only noise.
            x_re = x_re * model.band_weight
            x_im = x_im * model.band_weight
    # Rows [0:Cy] drive the re output, rows [Cy:2Cy] the im output.
    x_for = jnp.concatenate(
        [
            jnp.concatenate([x_re, -x_im], axis=1),         # -> b1_re
            jnp.concatenate([x_im, x_re], axis=1),          # -> b1_im
        ],
        axis=0,
    )                                                       # [2Cy, 2Cx, F]
    b1 = mm("fdc,ycf->dyf", model.ex_s, x_for)              # [Dx, 2Cy, F]
    b1_re, b1_im = b1[:, :cy], b1[:, cy:]                   # [Dx, Cy, F]
    b1_for = jnp.concatenate(
        [
            jnp.concatenate([b1_re, -b1_im], axis=1),       # -> b2_re
            jnp.concatenate([b1_im, b1_re], axis=1),        # -> b2_im
        ],
        axis=0,
    )                                                       # [2Dx, 2Cy, F]
    dx = b1.shape[0]
    b2s = mm("fdc,xcf->dxf", model.ey_s, b1_for)            # [Dy, 2Dx, F]
    b2_re, b2_im = b2s[:, :dx], b2s[:, dx:]                 # [Dy, Dx, F]
    if model.dead is not None:
        xdr, xdi, ydr, ydi, chan = model.dead
        wd = window[chan]
        s_ri = mm("nt,tf->nf", wd, model.dft)               # [Nd, 2F]
        sr, si = s_ri[:, :f_half], s_ri[:, f_half:]
        if model.phat:
            magd = jnp.sqrt(sr * sr + si * si) + 1e-12
            sr, si = sr / magd, si / magd
            if model.band_weight is not None:
                sr = sr * model.band_weight
                si = si * model.band_weight
        # t1 = ex * s (complex, elementwise over f, n) then contract n
        # against ey — avoids a [F, Dx, Dy, Nd] intermediate.
        srt = sr.T[:, None, :]                              # [F, 1, Nd]
        sit = si.T[:, None, :]
        t1_r = xdr * srt - xdi * sit                        # [F, Dx, Nd]
        t1_i = xdr * sit + xdi * srt
        b2_re = b2_re - (
            mm("fxn,fyn->yxf", t1_r, ydr) - mm("fxn,fyn->yxf", t1_i, ydi)
        )
        b2_im = b2_im - (
            mm("fxn,fyn->yxf", t1_r, ydi) + mm("fxn,fyn->yxf", t1_i, ydr)
        )
    return b2_re, b2_im


def _mm_builders(model: FftHeatmapModel):
    """(mm_mid, mm_f32) einsum helpers for this model.

    Intermediate steering stages write their outputs in the compute dtype
    (the next matmul casts there anyway — identical values, half the HBM
    traffic for the [D, F] spectra planes); PHAT whitening wants f32
    magnitudes, so f32 intermediates in that mode.  The final power/beam
    contraction always accumulates AND stores f32.
    """
    if model.compute == "bfloat16":
        dtype, prec = jnp.bfloat16, jax.lax.Precision.DEFAULT
    else:
        dtype, prec = jnp.float32, jax.lax.Precision.HIGHEST
    mid_dtype = jnp.float32 if model.phat else dtype

    def mm_mid(sub, a, b):
        return jnp.einsum(
            sub, a.astype(dtype), b.astype(dtype),
            precision=prec, preferred_element_type=mid_dtype,
        )

    def mm(sub, a, b):
        return jnp.einsum(
            sub, a.astype(dtype), b.astype(dtype),
            precision=prec, preferred_element_type=jnp.float32,
        )

    return mm_mid, mm


def fft_heatmap_powers_chunked(windows, model: FftHeatmapModel):
    """[chunk, D] heatmap powers from [chunk, C, S+T] stacked windows.

    Chunked-streaming form of :func:`fft_heatmap_powers` (fused power
    path): the separable steering stages run vmapped (their per-bin
    matmuls gain a chunk-wide batch), and the dominant power stage runs
    ONCE over all ``chunk * D`` direction rows.
    """
    mm_mid, mm = _mm_builders(model)
    b2_re, b2_im = jax.vmap(
        lambda w: _steered_spectra(w, model, mm_mid)
    )(windows)                                              # [ck, Dy, Dx, F]
    ck = windows.shape[0]
    d = model.rows * model.columns
    b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)        # [ck, Dy, Dx, 2F]
    bp = mm("byxf,ft->byxt", b2_ri, model.pow_ri)
    powers = jnp.sum(bp * bp, axis=-1).reshape(ck, d)
    if model.src_map is not None:
        powers = powers[:, model.src_map]
    return powers


def fft_heatmap_powers(window, model: FftHeatmapModel):
    """Heatmap powers [rows*columns] from a DAS window [C, S+T].

    Same semantics as the dense path (band-passed mean power over the
    beamformed block, normalized by T * active channels) with exact
    band-limited fractional delays.

    ``model.power_path`` selects the final stage.  The default "fused"
    contracts the steered spectra directly against the bandpass-folded
    restricted inverse DFT (``model.pow_ri``, which carries the
    ``1/sqrt(T * n_active)`` normalization) and square-reduces — the
    [D, T] time-domain beam is never materialized.  "beam" reproduces the
    reference-shaped formulation (inverse DFT to a [D, T] beam, then
    :func:`ops.delay.das_power`).
    """
    t = model.block_size
    mm_mid, mm = _mm_builders(model)
    b2_re, b2_im = _steered_spectra(window, model, mm_mid)  # [Dy, Dx, F] x2
    d = model.rows * model.columns
    if model.power_path == "beam":
        b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)    # [Dy, Dx, 2F]
        beam = mm("yxf,ft->yxt", b2_ri, model.idft).reshape(d, t)
        powers = dl.das_power(
            beam, use_bandpass=model.use_bandpass, divisor=t * model.n_active
        )
    else:  # "fused"
        b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)    # [Dy, Dx, 2F]
        bp = mm("yxf,ft->yxt", b2_ri, model.pow_ri)         # [Dy, Dx, Tp]
        powers = jnp.sum(bp * bp, axis=-1).reshape(d)
    if model.src_map is not None:
        powers = powers[model.src_map]
    return powers
