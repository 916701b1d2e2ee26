"""Gradient-ascent source finder/tracker swarm — batched and on-device.

Re-design of the reference's ``SphericalGradient`` worker
(``src/dsp/gradient_ascend.cpp``): 16 seekers + 10 trackers, each stepping
by 4-point quadrant amplitude monopulse.  The reference iterates particle
objects on a CPU thread, beamforming 4 probes per particle per step through
the shared ``delay()`` kernel (gradient_ascend.cpp:50-60); here the whole
swarm is a fixed-shape state pytree and every step beamforms ALL probes of
ALL particles as one batched DAS matmul.  Data-dependent control flow
(merge / jump / promote / prune, gradient_ascend.cpp:332-393) is expressed
with masks under ``lax`` so the entire per-block update jits into a single
device program — no per-step host sync.

Behavioral parity notes:
- the reference's ``while canContinue()`` loop runs a wall-clock-dependent
  number of iterations per block; we run a fixed ``cfg.iterations`` count
  (deterministic, and matching the ``iterations`` argument the reference
  accepts but ignores, aw_processing_unit.cpp:83).
- tracker merge is vectorized pairwise (older survives); the reference's
  sequential scan can differ on 3-way chains within one iteration — the
  fixed point is identical.
- promoting a converged seeker starts *all* free trackers at its direction,
  exactly as the reference does (gradient_ascend.cpp:385-393) — the next
  merge pass collapses them to the oldest one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, TrackerConfig
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops.geometry import (
    normalize_spherical,
    nearby_probes,
    quadrant_probes,
    spherical_angle,
)

EPSILON = 1e-9


class Particles(NamedTuple):
    """A batch of monopulse particles (seekers or trackers)."""

    theta: jnp.ndarray        # [P]
    phi: jnp.ndarray          # [P]
    grad_theta: jnp.ndarray   # [P] last gradient
    grad_phi: jnp.ndarray     # [P]
    radius: jnp.ndarray       # [P] mean probe power (directionGradient.radius)
    error: jnp.ndarray        # [P] gradientError


class SwarmState(NamedTuple):
    seekers: Particles
    trackers: Particles
    tracking: jnp.ndarray     # [Nt] bool, tracker active
    start: jnp.ndarray        # [Nt] float32 block index when tracking began
    jumped: jnp.ndarray       # [Ns] bool
    mean: jnp.ndarray         # scalar mean seeker power
    reset_count: jnp.ndarray  # int32 blocks since start
    key: jnp.ndarray          # PRNG key
    # Previous block's published targets (used for seeker avoidance, as the
    # reference compares seekers against the published `tracking` list,
    # gradient_ascend.cpp:362-367).
    target_theta: jnp.ndarray  # [Nt]
    target_phi: jnp.ndarray    # [Nt]
    target_valid: jnp.ndarray  # [Nt] bool


class Targets(NamedTuple):
    """Published target list (reference: Target struct, worker.h:32-61)."""

    theta: jnp.ndarray        # [Nt]
    phi: jnp.ndarray          # [Nt]
    power: jnp.ndarray        # [Nt]
    probability: jnp.ndarray  # [Nt] = 1 / gradientError
    start: jnp.ndarray        # [Nt] block index
    valid: jnp.ndarray        # [Nt] bool


def _empty_particles(n: int) -> Particles:
    z = jnp.zeros((n,), jnp.float32)
    return Particles(z, z, z, z, z, z)


def _random_directions(key, n: int, theta_limit: float):
    """Uniform placement in the search domain (particle.cpp:11-14), as one
    batched draw."""
    u = jax.random.uniform(key, (2, n), jnp.float32)
    return u[0] * theta_limit, u[1] * (2.0 * np.pi)


def swarm_init(cfg: TrackerConfig, key) -> SwarmState:
    key, sub = jax.random.split(key)
    s_theta, s_phi = _random_directions(sub, cfg.n_seekers, cfg.theta_limit)
    seekers = _empty_particles(cfg.n_seekers)._replace(theta=s_theta, phi=s_phi)
    nt = cfg.n_trackers
    return SwarmState(
        seekers=seekers,
        trackers=_empty_particles(nt),
        tracking=jnp.zeros((nt,), bool),
        start=jnp.zeros((nt,), jnp.float32),
        jumped=jnp.zeros((cfg.n_seekers,), bool),
        mean=jnp.zeros((), jnp.float32),
        reset_count=jnp.zeros((), jnp.int32),
        key=key,
        target_theta=jnp.zeros((nt,), jnp.float32),
        target_phi=jnp.zeros((nt,), jnp.float32),
        target_valid=jnp.zeros((nt,), bool),
    )


def _monopulse_step(
    particles: Particles,
    active,
    window,
    points,
    channel_mask,
    rate,
    spread,
    theta_limit: float,
    shift_range: int,
    mode: str,
    fir_bank,
    samples_per_meter: float,
    axis_name=None,
    span: int | None = None,
    compute: str = "float32",
    unfolded=None,
    probe_layout: str = "quadrant",
):
    """One batched GradientParticle::step (gradient_ascend.cpp:30-81).

    Inactive particles pass through unchanged.  With ``axis_name`` set the
    channel axis of ``points``/``channel_mask``/``window`` is a mesh shard:
    the min-subtract and the beam accumulate become collectives, and the
    monopulse powers (computed from the psum'd beam) are identical on every
    shard.

    ``span`` < ``shift_range`` shrinks the probe stencil to the aperture's
    actual delay spread (see :func:`ops.delay.probe_span`): the window is
    sliced by the same constant the shift base moves, so beams are
    identical while the contraction shrinks.  ``compute="bfloat16"`` runs
    the probe matmul with bf16 inputs / f32 accumulation.

    ``rate``/``spread`` may be scalars or per-particle ``[P]`` arrays —
    array form lets one dispatch mix particle families with different
    dynamics (trackers / seekers / the MISO listener).

    ``unfolded`` short-circuits the window handling: a pre-unfolded probe
    window ``[C, span, T]`` already in the compute dtype (the unfold is
    loop-invariant across the swarm's sequential monopulse chain, so
    callers hoist it out of the scan); ``window``/``span``/``compute``
    are then ignored.

    ``probe_layout`` selects the monopulse probe constellation — the
    reference's compile-time ``USE_HORIZONTAL`` (gradient_ascend.h:34):
    ``"quadrant"`` (default, = USE_HORIZONTAL 0) probes the four
    diagonals; ``"horizontal"`` probes N/E/S/W (``Spherical::nearby``,
    geometry.cpp:144-179) with the reference's max-normalized axis
    discriminants (gradient_ascend.cpp:41-48).
    """
    if unfolded is not None:
        span = unfolded.shape[-2]
    elif span is None or span >= shift_range:
        span = shift_range
    else:
        window = window[..., shift_range - span:]
    theta, phi = particles.theta, particles.phi
    probe_fn = quadrant_probes if probe_layout == "quadrant" else nearby_probes
    pt, pp, adj_theta = probe_fn(theta, phi, spread)
    pt, pp = normalize_spherical(pt, pp, theta_limit)      # particle.h:24-27
    theta = adj_theta  # probes nudge theta near the FoV edge

    delays = ant.steering_delays(
        points, pt, pp, samples_per_meter, axis_name=axis_name
    )  # [P,4,C]
    w = dl.das_weights(delays, span, mode, fir_bank)
    if channel_mask is not None:
        w = w * channel_mask[..., :, None]
    if unfolded is not None:
        prec = (
            jax.lax.Precision.DEFAULT
            if unfolded.dtype == jnp.bfloat16
            else jax.lax.Precision.HIGHEST
        )
        beams = dl.das_beam_unfolded(
            unfolded, w.astype(unfolded.dtype),
            precision=prec, axis_name=axis_name,
        )                                                  # [P, 4, T] (f32 acc)
    elif compute == "bfloat16":
        beams = dl.das_beam(
            window.astype(jnp.bfloat16),
            w.astype(jnp.bfloat16),
            precision=jax.lax.Precision.DEFAULT,
            axis_name=axis_name,
        )                                                  # [P, 4, T] (f32 acc)
    else:
        beams = dl.das_beam(window, w, axis_name=axis_name)    # [P, 4, T]
    t = beams.shape[-1]
    powers = dl.das_power(beams, use_bandpass=True, divisor=t)  # [P, 4]

    q1, q2, q3, q4 = powers[..., 0], powers[..., 1], powers[..., 2], powers[..., 3]
    total = jnp.maximum(q1 + q2 + q3 + q4, 1e-30)
    # Amplitude-monopulse discriminants for OUR probe orientation: after
    # Rz(phi) @ Ry(theta), local +X points toward increasing theta, so probes
    # q1 (45 deg) and q2 (315 deg) sit at larger theta, q3/q4 at smaller;
    # q1/q4 sit at larger phi.  Normalizing by the probe sum (instead of the
    # reference's raw-mic power, gradient_ascend.cpp:69-71) makes the
    # discriminant scale-invariant in [-1, 1], so step sizes proportional to
    # the probe spread converge regardless of absolute signal level.
    if probe_layout == "quadrant":
        grad_theta = ((q1 + q2) - (q3 + q4)) / total
        grad_phi = ((q1 + q4) - (q2 + q3)) / total
    else:
        # Horizontal N/E/S/W probes (gradient_ascend.cpp:41-48, sign
        # matched to OUR probe orientation: q1=N sits at larger theta,
        # q2=E at larger phi).  The reference normalizes each axis by the
        # max of its pair; both discriminants stay in [-1, 1].
        grad_theta = (q1 - q3) / jnp.maximum(jnp.maximum(q1, q3), 1e-30)
        grad_phi = (q2 - q4) / jnp.maximum(jnp.maximum(q2, q4), 1e-30)
    error = jnp.abs(grad_theta) + jnp.abs(grad_phi)
    radius = (q1 + q2 + q3 + q4) / 4.0

    # Particle::step (particle.cpp:22-27): theta first, then phi scaled by
    # 1/sin(eps + NEW theta).
    new_theta = theta + rate * grad_theta
    new_phi = phi + (rate * grad_phi) / jnp.sin(EPSILON + new_theta)
    new_theta, new_phi = normalize_spherical(new_theta, new_phi, theta_limit)

    def sel(new, old):
        return jnp.where(active, new, old)

    return Particles(
        theta=sel(new_theta, particles.theta),
        phi=sel(new_phi, particles.phi),
        grad_theta=sel(grad_theta, particles.grad_theta),
        grad_phi=sel(grad_phi, particles.grad_phi),
        radius=sel(radius, particles.radius),
        error=sel(error, particles.error),
    )


def _merge_trackers(trackers: Particles, tracking, start, closeness: float):
    """Absorb pairwise-close trackers, oldest wins
    (gradient_ascend.cpp:332-351)."""
    nt = tracking.shape[0]
    ang = spherical_angle(
        trackers.theta[:, None],
        trackers.phi[:, None],
        trackers.theta[None, :],
        trackers.phi[None, :],
    )
    both = tracking[:, None] & tracking[None, :]
    close = (ang < closeness) & both & ~jnp.eye(nt, dtype=bool)
    # For pair (m, n): the younger one stops.  m stops if it started strictly
    # later, or on a tie if m has the larger index (the reference keeps
    # trackers[m] on ties since `m > n` is false, stopping n — i.e. the
    # lower index survives).
    older = (start[:, None] > start[None, :]) | (
        (start[:, None] == start[None, :])
        & (jnp.arange(nt)[:, None] > jnp.arange(nt)[None, :])
    )
    stop = jnp.any(close & older, axis=1)
    return tracking & ~stop


def _publish(trackers: Particles, tracking, mean, reference,
             cfg: TrackerConfig):
    """Prune weak/diverged trackers before publishing
    (gradient_ascend.cpp:398-408), plus the sidelobe gate
    (TrackerConfig.min_power_fraction)."""
    weak = (
        (trackers.radius < mean)
        | (trackers.radius < reference)
        | (trackers.error > cfg.error_threshold)
    )
    tracking = tracking & ~weak
    if cfg.min_power_fraction > 0.0:
        strongest = jnp.max(jnp.where(tracking, trackers.radius, 0.0))
        tracking = tracking & (
            trackers.radius >= cfg.min_power_fraction * strongest
        )
    return tracking


def _swarm_jumps(key, n_iter: int, n_seekers: int, jump: float):
    """Pre-generate ALL iterations' seeker jump offsets as ONE batched
    uniform draw.  Returns (next_key, jt[n_iter, Ns], jp[n_iter, Ns]).

    The iteration scan indexes the arrays per iteration; one batched draw
    replaces a threefry ``split`` per iteration."""
    key, k1 = jax.random.split(key)
    u = (
        jax.random.uniform(k1, (2, n_iter, n_seekers), jnp.float32) * 2.0
        - 1.0
    ) * jump
    return key, u[0], u[1]


def make_swarm_step_impl(
    cfg: TrackerConfig,
    dsp: DspConfig,
    array_cfg: ArrayConfig,
    fir_bank=None,
    axis_name=None,
    probe_span=None,
):
    """Build the *unjitted* per-block swarm update with the array model as
    runtime operands.

    Returns ``step(state, window, block_index, points, channel_mask) ->
    (state, Targets)``.  Passing ``points``/``channel_mask``/``window`` as
    arguments (rather than closure constants) lets the same function run
    inside ``shard_map`` with the channel axis sharded over mesh axis
    ``axis_name`` — the whole swarm update is then one SPMD program whose
    only communication is the psum'd probe beams.
    """
    if dsp.interp == "fir" and fir_bank is None:
        fir_bank = dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    bank = None if dsp.interp == "linear" else jnp.asarray(fir_bank)
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    spm = array_cfg.samples_per_meter

    base_mono = functools.partial(
        _monopulse_step,
        window=None,
        theta_limit=cfg.theta_limit,
        shift_range=dsp.shift_range,
        mode=dsp.interp,
        fir_bank=bank,
        samples_per_meter=spm,
        axis_name=axis_name,
        span=probe_span,
        compute=dsp.probe_compute,
        probe_layout=cfg.probe_layout,
    )
    span_eff = (
        dsp.shift_range
        if probe_span is None
        else min(probe_span, dsp.shift_range)
    )

    t_len = dsp.block_size
    ns = cfg.n_seekers

    def step(state: SwarmState, window, block_index, points, channel_mask):
        # Hoist the probe-window unfold (and compute-dtype cast) out of the
        # iteration scan: it is loop-invariant, and every monopulse dispatch
        # below reuses it.
        pw = (
            window
            if span_eff >= dsp.shift_range
            else window[..., dsp.shift_range - span_eff:]
        )
        unf = dl.unfold_window(pw, span_eff, pw.shape[-1] - span_eff)
        if dsp.probe_compute == "bfloat16":
            unf = unf.astype(jnp.bfloat16)
        mono = functools.partial(
            base_mono, points=points, channel_mask=channel_mask, unfolded=unf
        )

        # --- Reference power: bandpass power of channel 0's raw block
        # (gradient_ascend.cpp:304-313). The beamformed block sits at window
        # offset (S - taps).  Under channel sharding, global channel 0 lives
        # on shard 0 only — select it with a masked psum.
        b0 = dsp.shift_range - taps
        raw = jax.lax.dynamic_slice_in_dim(window[0], b0, t_len)
        reference = dl.das_power(raw, use_bandpass=True, divisor=t_len - 2)
        if axis_name is not None:
            on_shard0 = (jax.lax.axis_index(axis_name) == 0).astype(reference.dtype)
            reference = jax.lax.psum(reference * on_shard0, axis_name)

        # --- Seeker reset every seeker_reset_interval blocks
        # (gradient_ascend.cpp:295-299).
        key, sub = jax.random.split(state.key)
        do_reset = jnp.mod(state.reset_count, cfg.seeker_reset_interval) == 0
        r_theta, r_phi = _random_directions(sub, cfg.n_seekers, cfg.theta_limit)
        seekers = state.seekers._replace(
            theta=jnp.where(do_reset, r_theta, state.seekers.theta),
            phi=jnp.where(do_reset, r_phi, state.seekers.phi),
        )
        trackers, tracking, start = state.trackers, state.tracking, state.start
        mean = state.mean

        # Pre-generate ALL iterations' seeker jump offsets (one batched
        # draw).
        key, jts, jps = _swarm_jumps(
            key, cfg.iterations, ns, cfg.theta_limit / 2.0
        )

        def iteration(carry, jump_i):
            seekers, trackers, tracking, start, mean = carry
            jt_i, jp_i = jump_i

            # Trackers: trackerSteps sub-steps at slowed rate
            # (gradient_ascend.cpp:323-330).
            def tracker_substep(tr, _):
                tr = mono(
                    tr,
                    tracking,
                    rate=cfg.tracker_step_gain * cfg.tracker_spread,
                    spread=cfg.tracker_spread,
                )
                return tr, None

            trackers, _ = jax.lax.scan(
                tracker_substep, trackers, None, length=cfg.tracker_steps
            )
            n_tracking = jnp.sum(tracking)

            # Merge close trackers (oldest wins).
            tracking = _merge_trackers(trackers, tracking, start, cfg.tracker_closeness)

            # Seekers: one full-rate step.
            all_on = jnp.ones((cfg.n_seekers,), bool)
            seekers = mono(
                seekers,
                all_on,
                rate=cfg.seeker_step_gain * cfg.seeker_spread,
                spread=cfg.seeker_spread,
            )

            # Jump seekers that wander into a published target's capture zone
            # (gradient_ascend.cpp:360-371; jump size thetaLimit/2,
            # gradient_ascend.cpp:89-92); offsets pre-generated per block.
            ang = spherical_angle(
                seekers.theta[:, None],
                seekers.phi[:, None],
                state.target_theta[None, :],
                state.target_phi[None, :],
            )
            too_close = jnp.any((ang < cfg.tracker_closeness) & state.target_valid, axis=1)
            j_theta, j_phi = normalize_spherical(
                seekers.theta + jt_i, seekers.phi + jp_i, cfg.theta_limit
            )
            seekers = seekers._replace(
                theta=jnp.where(too_close, j_theta, seekers.theta),
                phi=jnp.where(too_close, j_phi, seekers.phi),
            )

            # Converged-best seeker -> promote to all free trackers
            # (gradient_ascend.cpp:374-393).
            valid = ~too_close
            converged = valid & (seekers.error < cfg.error_threshold)
            power_masked = jnp.where(converged, seekers.radius, -jnp.inf)
            best = jnp.argmax(power_masked)
            better = jnp.any(converged & (seekers.radius > 0.0))
            promote = better & (n_tracking < cfg.n_trackers) & ~tracking
            trackers = trackers._replace(
                theta=jnp.where(promote, seekers.theta[best], trackers.theta),
                phi=jnp.where(promote, seekers.phi[best], trackers.phi),
            )
            start = jnp.where(promote, block_index.astype(jnp.float32), start)
            tracking = tracking | promote

            n_valid = jnp.maximum(jnp.sum(valid), 1)
            mean = jnp.sum(jnp.where(valid, seekers.radius, 0.0)) / n_valid
            return (seekers, trackers, tracking, start, mean), None

        (seekers, trackers, tracking, start, mean), _ = jax.lax.scan(
            iteration,
            (seekers, trackers, tracking, start, mean),
            (jts, jps),
        )
        tracking = _publish(trackers, tracking, mean, reference, cfg)
        targets = Targets(
            theta=trackers.theta,
            phi=trackers.phi,
            power=trackers.radius,
            probability=1.0 / jnp.maximum(trackers.error, 1e-30),
            start=start,
            valid=tracking,
        )
        new_state = SwarmState(
            seekers=seekers,
            trackers=trackers,
            tracking=tracking,
            start=start,
            jumped=state.jumped,
            mean=mean,
            reset_count=state.reset_count + 1,
            key=key,
            target_theta=trackers.theta,
            target_phi=trackers.phi,
            target_valid=tracking,
        )
        return new_state, targets

    return step


def make_fused_step_impl(
    cfg: TrackerConfig,
    dsp: DspConfig,
    array_cfg: ArrayConfig,
    fir_bank=None,
    axis_name=None,
    probe_span=None,
    miso_refine_steps: int = 3,
):
    """Fused swarm + MISO per-block update: ONE monopulse dispatch chain.

    The reference evaluates tracker sub-step probes, seeker probes and the
    MISO listener's refine probes as separate beamforming passes on separate
    worker threads (gradient_ascend.cpp:301-409, miso.cpp:25-55).  Their
    data dependencies don't require that: within one swarm iteration the
    seeker step depends only on the iteration-start seeker state (the jump
    avoidance uses the *previous block's* published targets), and the MISO
    refine chain is independent of the swarm entirely.  So all three ride
    the same batched DAS dispatch as extra matmul rows:

      - sub-step 0 of each iteration dispatches the concatenated
        [Nt trackers | Ns seekers | 1 miso] batch; sub-steps 1..refine-1
        dispatch [trackers | miso]; the rest dispatch trackers alone
      - per-particle rate/spread vectors give each family its dynamics

    The schedule processes exactly the same particle rows as the unfused
    impls (no dispatch is padded to the full combined batch with
    masked-off rows).  Group sizes are static per sub-step index, so the
    inner loop is a short unrolled Python loop rather than a ``lax.scan``;
    the dispatch count drops from
    ``iterations*(tracker_steps+1) + miso_refine_steps + 1`` to
    ``iterations*tracker_steps + 1``.  The window unfold and compute-dtype
    cast are hoisted out of the chain (loop-invariant), and the MISO audio
    beam reuses the hoisted f32 unfold.

    Per-row matmul results are independent of the other rows in the batch,
    so every particle's trajectory is identical to the unfused
    :func:`make_swarm_step_impl` / :func:`models.miso.make_miso_step_impl`
    composition (pinned by ``test_fused_step_parity``).

    Returns ``step(state, miso_particle, window, block_index, points,
    channel_mask) -> (state, Targets, miso_particle, miso_beam[T])``.
    Requires ``cfg.iterations * cfg.tracker_steps >= miso_refine_steps``.
    """
    if cfg.iterations * cfg.tracker_steps < miso_refine_steps:
        raise ValueError(
            f"fused step needs iterations*tracker_steps >= "
            f"{miso_refine_steps} slots for the MISO refine chain; got "
            f"{cfg.iterations}*{cfg.tracker_steps}"
        )
    if dsp.interp == "fir" and fir_bank is None:
        fir_bank = dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    bank = None if dsp.interp == "linear" else jnp.asarray(fir_bank)
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    spm = array_cfg.samples_per_meter
    span_eff = (
        dsp.shift_range
        if probe_span is None
        else min(probe_span, dsp.shift_range)
    )
    base_mono = functools.partial(
        _monopulse_step,
        window=None,
        theta_limit=cfg.theta_limit,
        shift_range=dsp.shift_range,
        mode=dsp.interp,
        fir_bank=bank,
        samples_per_meter=spm,
        axis_name=axis_name,
        compute=dsp.probe_compute,
        probe_layout=cfg.probe_layout,
    )

    nt, ns = cfg.n_trackers, cfg.n_seekers
    tracker_rate = cfg.tracker_step_gain * cfg.tracker_spread
    seeker_rate = cfg.seeker_step_gain * cfg.seeker_spread
    miso_rate = tracker_rate / 3.0                       # miso.cpp:39-40
    # Per-particle dynamics for the two mixed-family dispatch shapes.
    # Row layout: trackers | miso | seekers — the rows that can move on
    # sub-steps j > 0 (trackers + the miso refine budget) sit in a
    # contiguous prefix.
    rates_tsm = jnp.asarray(
        [tracker_rate] * nt + [miso_rate] + [seeker_rate] * ns, jnp.float32
    )
    spreads_tsm = jnp.asarray(
        [cfg.tracker_spread] * nt
        + [cfg.tracker_spread]
        + [cfg.seeker_spread] * ns,
        jnp.float32,
    )
    rates_tm = jnp.asarray([tracker_rate] * nt + [miso_rate], jnp.float32)
    spreads_tm = jnp.asarray(
        [cfg.tracker_spread] * (nt + 1), jnp.float32
    )
    t_len = dsp.block_size

    def concat_p(*groups: Particles) -> Particles:
        return jax.tree.map(
            lambda *leaves: jnp.concatenate(leaves), *groups
        )

    def step(
        state: SwarmState, miso_particle: Particles, window, block_index,
        points, channel_mask,
    ):
        # --- Reference power (gradient_ascend.cpp:304-313); see
        # make_swarm_step_impl for the sharded channel-0 selection.
        b0 = dsp.shift_range - taps
        raw = jax.lax.dynamic_slice_in_dim(window[0], b0, t_len)
        reference = dl.das_power(raw, use_bandpass=True, divisor=t_len - 2)
        if axis_name is not None:
            on_shard0 = (jax.lax.axis_index(axis_name) == 0).astype(reference.dtype)
            reference = jax.lax.psum(reference * on_shard0, axis_name)

        # --- Hoisted loop-invariant probe window unfold (f32 kept for the
        # audio beam; compute dtype for the probe chain).
        pw = (
            window
            if span_eff >= dsp.shift_range
            else window[..., dsp.shift_range - span_eff:]
        )
        unf_f32 = dl.unfold_window(pw, span_eff, pw.shape[-1] - span_eff)
        unf = (
            unf_f32.astype(jnp.bfloat16)
            if dsp.probe_compute == "bfloat16"
            else unf_f32
        )
        mono = functools.partial(
            base_mono, points=points, channel_mask=channel_mask, unfolded=unf
        )

        # --- Seeker reset (gradient_ascend.cpp:295-299).
        key, sub = jax.random.split(state.key)
        do_reset = jnp.mod(state.reset_count, cfg.seeker_reset_interval) == 0
        r_theta, r_phi = _random_directions(sub, cfg.n_seekers, cfg.theta_limit)
        seekers = state.seekers._replace(
            theta=jnp.where(do_reset, r_theta, state.seekers.theta),
            phi=jnp.where(do_reset, r_phi, state.seekers.phi),
        )
        tracking, start, mean = state.tracking, state.start, state.mean

        # Pre-generate ALL iterations' seeker jump offsets as one batched
        # draw.
        key, jts, jps = _swarm_jumps(
            key, cfg.iterations, ns, cfg.theta_limit / 2.0
        )

        def xla_chain(trackers, seekers, miso_p, tracking, it_idx):
            # Sub-step chain: group composition is static per sub-step
            # index, so unroll in Python — every dispatch carries exactly
            # the rows that need stepping (plus the 1 miso row, masked off
            # once its refine budget is spent).
            for j in range(cfg.tracker_steps):
                slot = it_idx * cfg.tracker_steps + j
                miso_on = jnp.broadcast_to(slot < miso_refine_steps, (1,))
                if j == 0:
                    comb = concat_p(trackers, miso_p, seekers)
                    active = jnp.concatenate([
                        tracking, miso_on, jnp.ones((ns,), bool),
                    ])
                    comb = mono(
                        comb, active, rate=rates_tsm, spread=spreads_tsm
                    )
                    trackers = jax.tree.map(lambda x: x[:nt], comb)
                    miso_p = jax.tree.map(lambda x: x[nt:nt + 1], comb)
                    seekers = jax.tree.map(lambda x: x[nt + 1:], comb)
                elif j < miso_refine_steps:
                    comb = concat_p(trackers, miso_p)
                    active = jnp.concatenate([tracking, miso_on])
                    comb = mono(
                        comb, active, rate=rates_tm, spread=spreads_tm
                    )
                    trackers = jax.tree.map(lambda x: x[:nt], comb)
                    miso_p = jax.tree.map(lambda x: x[nt:], comb)
                else:
                    trackers = mono(
                        trackers, tracking,
                        rate=tracker_rate, spread=cfg.tracker_spread,
                    )
            return trackers, seekers, miso_p

        def iteration(carry, xs):
            it_idx, jt_i, jp_i = xs
            trackers, seekers, miso_p, tracking, start, mean = carry
            trackers, seekers, miso_p = xla_chain(
                trackers, seekers, miso_p, tracking, it_idx
            )
            n_tracking = jnp.sum(tracking)

            # Merge close trackers (oldest wins).
            tracking = _merge_trackers(
                trackers, tracking, start, cfg.tracker_closeness
            )

            # Jump seekers near a published target (gradient_ascend.cpp:360-371).
            ang = spherical_angle(
                seekers.theta[:, None],
                seekers.phi[:, None],
                state.target_theta[None, :],
                state.target_phi[None, :],
            )
            too_close = jnp.any(
                (ang < cfg.tracker_closeness) & state.target_valid, axis=1
            )
            j_theta, j_phi = normalize_spherical(
                seekers.theta + jt_i, seekers.phi + jp_i, cfg.theta_limit
            )
            seekers = seekers._replace(
                theta=jnp.where(too_close, j_theta, seekers.theta),
                phi=jnp.where(too_close, j_phi, seekers.phi),
            )

            # Converged-best seeker -> promote (gradient_ascend.cpp:374-393).
            valid = ~too_close
            converged = valid & (seekers.error < cfg.error_threshold)
            power_masked = jnp.where(converged, seekers.radius, -jnp.inf)
            best = jnp.argmax(power_masked)
            better = jnp.any(converged & (seekers.radius > 0.0))
            promote = better & (n_tracking < cfg.n_trackers) & ~tracking
            trackers = trackers._replace(
                theta=jnp.where(promote, seekers.theta[best], trackers.theta),
                phi=jnp.where(promote, seekers.phi[best], trackers.phi),
            )
            start = jnp.where(promote, block_index.astype(jnp.float32), start)
            tracking = tracking | promote

            n_valid = jnp.maximum(jnp.sum(valid), 1)
            mean = jnp.sum(jnp.where(valid, seekers.radius, 0.0)) / n_valid
            return (trackers, seekers, miso_p, tracking, start, mean), None

        (trackers, seekers, miso_p, tracking, start, mean), _ = (
            jax.lax.scan(
                iteration,
                (state.trackers, seekers, miso_particle, tracking,
                 start, mean),
                (jnp.arange(cfg.iterations), jts, jps),
            )
        )
        tracking = _publish(trackers, tracking, mean, reference, cfg)
        targets = Targets(
            theta=trackers.theta,
            phi=trackers.phi,
            power=trackers.radius,
            probability=1.0 / jnp.maximum(trackers.error, 1e-30),
            start=start,
            valid=tracking,
        )
        new_state = SwarmState(
            seekers=seekers,
            trackers=trackers,
            tracking=tracking,
            start=start,
            jumped=state.jumped,
            mean=mean,
            reset_count=state.reset_count + 1,
            key=key,
            target_theta=trackers.theta,
            target_phi=trackers.phi,
            target_valid=tracking,
        )

        # --- MISO audio beam at the refined direction (miso.cpp:41-55):
        # float32, from the hoisted f32 unfold.
        delays = ant.steering_delays(
            points, miso_p.theta, miso_p.phi, spm, axis_name=axis_name
        )  # [1, C]
        w = dl.das_weights(delays, span_eff, dsp.interp, bank)
        if channel_mask is not None:
            w = w * channel_mask[..., :, None]
        miso_beam = dl.das_beam_unfolded(
            unf_f32, w, axis_name=axis_name
        )[0]
        return new_state, targets, miso_p, miso_beam

    return step


def make_swarm_step(
    points,
    cfg: TrackerConfig,
    dsp: DspConfig,
    array_cfg: ArrayConfig,
    channel_mask=None,
    fir_bank=None,
):
    """Build the jitted single-device per-block swarm update.

    Returns ``step(state, window, block_index) -> (state, Targets)`` where
    ``window`` is the DAS window from :func:`ring_window` and ``block_index``
    an int32 block counter (the clock for tracker ages / seeker resets).
    """
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    span = dl.probe_span(
        points, array_cfg.samples_per_meter, taps, dsp.shift_range
    )
    impl = make_swarm_step_impl(cfg, dsp, array_cfg, fir_bank, probe_span=span)
    points = jnp.asarray(points, jnp.float32)
    mask = None if channel_mask is None else jnp.asarray(channel_mask, jnp.float32)

    @jax.jit
    def step(state: SwarmState, window, block_index):
        return impl(state, window, block_index, points, mask)

    return step
