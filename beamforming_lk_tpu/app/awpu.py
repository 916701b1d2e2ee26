"""AWPU: the fused per-array processing step.

The reference's ``AWProcessingUnit`` (``src/aw_processing_unit/
aw_processing_unit.cpp``) spawns MIMO / MISO / GRADIENT worker threads that
each re-read the shared ring buffers per block.  All three route through the
same ``delay()`` DAS kernel (``src/dsp/mimo.cpp:128``,
``src/dsp/particle.cpp:51-82``); here they are literally one device program:

    step(state, block) ->
        heatmap powers [D]   (MIMO worker,    mimo.cpp:97-151)
        target list          (GRADIENT worker, gradient_ascend.cpp:301-409)
        audio beam [T]       (MISO worker,    miso.cpp:25-55)

and the program runs unchanged on one chip or ``shard_map``-sharded over a
``(ch, dir)`` mesh: mic channels psum partial beams, the heatmap direction
grid splits freely, tracker/MISO state stays replicated (their collectives
make every shard agree bit-for-bit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beamforming_lk_tpu.config import Config
from beamforming_lk_tpu.io import ring as rg
from beamforming_lk_tpu.models import mimo as mm
from beamforming_lk_tpu.models import miso as ms
from beamforming_lk_tpu.models import tracker as tk
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.parallel.mesh import CH_AXIS, DIR_AXIS


class AwpuState(NamedTuple):
    """Carried device state for one array's processing pipeline."""

    history: jnp.ndarray        # [C, H] ring history (sharded over ch)
    swarm: tk.SwarmState        # gradient tracker swarm (replicated)
    miso: ms.MisoState          # steered listener (replicated)
    prev_max: jnp.ndarray       # [] heatmap running-max EMA (mimo.cpp:75-76)
    block_index: jnp.ndarray    # [] int32 block counter
    powers: jnp.ndarray         # [D] last computed heatmap powers (sharded
                                # over dir; reused on decimated blocks when
                                # MimoConfig.heatmap_every > 1)


class AwpuOutputs(NamedTuple):
    powers: jnp.ndarray         # [D] heatmap powers (sharded over dir)
    targets: tk.Targets         # published tracker targets
    miso_beam: jnp.ndarray      # [T] beamformed audio block
    prev_max: jnp.ndarray       # [] EMA'd heatmap max (for rendering)


def make_awpu_step(
    points,
    cfg: Config,
    channel_mask=None,
    mesh: Optional[Mesh] = None,
    enable_mimo: bool = True,
    enable_tracker: bool = True,
    enable_miso: bool = True,
):
    """Build the fused jitted per-block step: (state, block) -> (state, out).

    ``mesh`` None runs single-device.  With a mesh, the step is shard_mapped:
    ``history``/``block`` sharded ``P(ch, None)``, heatmap weights
    ``P(dir, ch, None)``, powers out ``P(dir)``; everything else replicated.
    C must divide the ``ch`` mesh size and D the ``dir`` size.
    """
    points_np = np.asarray(points, np.float32)
    c = points_np.shape[1]
    mask_np = (
        None if channel_mask is None else np.asarray(channel_mask, np.float32)
    )
    n_active = float(mask_np.sum()) if mask_np is not None else float(c)

    dsp, arr = cfg.dsp, cfg.array
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    fir_bank = (
        None
        if dsp.interp == "linear"
        else dl.fractional_delay_fir_bank(dsp.fir_phases, dsp.fir_taps)
    )

    # Heatmap stencil (the computeDelayLUT analog) — built WITHOUT the mask
    # folded in so the mask can stay a sharded runtime operand.  Host-side
    # numpy build: one device_put instead of per-op round trips.
    theta, phi = mm.make_mimo_grid(cfg.mimo)
    delays = ant.steering_delays_np(points_np, theta, phi, arr.samples_per_meter)
    span_needed = float(delays.max()) + taps
    if span_needed > dsp.shift_range:
        raise ValueError(
            f"aperture needs a shift span of {span_needed:.0f} samples "
            f"(max steering delay + {taps} taps) but DspConfig.shift_range "
            f"is {dsp.shift_range}; raise it (and history if needed)"
        )
    # Separable frequency-domain heatmap (ops/fft_das.py): exact, ~20x
    # fewer FLOPs; available for planar-lattice arrays + binary masks.
    # Under a mesh the kernel is so cheap that the optimal SPMD form is
    # full replication: every shard computes all D directions (needs the
    # full channel axis, so the ch mesh axis must be size 1) and slices
    # its own direction chunk — zero communication.  None -> dense path.
    fft_model = None
    mesh_ch_is_full = mesh is None or (
        CH_AXIS not in mesh.axis_names
        or dict(zip(mesh.axis_names, mesh.devices.shape)).get(CH_AXIS, 1) == 1
    )
    if cfg.mimo.backend == "fft" and enable_mimo:
        from beamforming_lk_tpu.ops import fft_das as fd

        if mesh_ch_is_full:
            fft_model = fd.make_fft_heatmap_model(
                points_np, cfg.mimo, dsp, arr, channel_mask=mask_np,
                compute=dsp.compute,
            )
        if fft_model is None:
            import sys

            print(
                "mimo backend 'fft' unavailable for this "
                "geometry/mask/mesh; using dense",
                file=sys.stderr,
            )

    if fft_model is None:
        mimo_weights = dl.das_weights_np(
            delays, dsp.shift_range, dsp.interp, fir_bank
        )
    else:
        # Placeholder so the disabled/zeros branch and shard specs keep
        # their shapes without materializing the unused dense stencil.
        mimo_weights = np.zeros((cfg.mimo.n_directions, 1, 1), np.float32)

    axis_name = CH_AXIS if (mesh is not None and CH_AXIS in mesh.axis_names) else None
    # Probe stencil span sized from the FULL aperture (points_np before any
    # channel sharding — min-subtraction is global under the mesh).
    span = dl.probe_span(points_np, arr.samples_per_meter, taps, dsp.shift_range)
    # Tracker + MISO both on at a real-time cadence -> fuse their probe
    # evaluations into one monopulse dispatch chain (seekers and the MISO
    # refine steps ride the tracker sub-step matmuls as extra rows; see
    # make_fused_step_impl).  At the deployment cadence (iterations <= 4)
    # the saved seeker/MISO dispatches are a large fraction of the chain;
    # at the 10-iteration parity profile the mixed-family rows in every
    # iteration's sub-step 0 outweigh them — so gate on the cadence.
    use_fused = (
        enable_tracker
        and enable_miso
        and cfg.tracker.iterations <= 4
        and cfg.tracker.iterations * cfg.tracker.tracker_steps >= 3
    )
    fused_impl = swarm_impl = miso_impl = None
    if use_fused:
        fused_impl = tk.make_fused_step_impl(
            cfg.tracker, dsp, arr, fir_bank, axis_name=axis_name,
            probe_span=span,
        )
    else:
        if enable_tracker:
            swarm_impl = tk.make_swarm_step_impl(
                cfg.tracker, dsp, arr, fir_bank, axis_name=axis_name,
                probe_span=span,
            )
        if enable_miso:
            miso_impl = ms.make_miso_step_impl(
                cfg.tracker, dsp, arr, fir_bank, axis_name=axis_name,
                probe_span=span,
            )

    d_total = cfg.mimo.n_directions
    t_len = dsp.block_size
    nt = cfg.tracker.n_trackers

    def _step(state: AwpuState, block, pts, mask, mimo_w):
        history = rg.ring_push(state.history, block)
        window = rg.ring_window(history, t_len, dsp.shift_range, taps)

        # --- MIMO heatmap worker (mimo.cpp:97-151)
        def _heatmap(_):
            if fft_model is not None:
                from beamforming_lk_tpu.ops import fft_das as fd

                powers = fd.fft_heatmap_powers(window, fft_model)
                if axis_name is not None:
                    # The ch mesh axis is size 1 here (fft needs all
                    # channels); this identity psum just tells shard_map's
                    # replication checker the powers are uniform across it.
                    powers = jax.lax.psum(powers, axis_name)
                prev_max = (
                    jnp.max(powers) * cfg.mimo.ema_alpha
                    + (1.0 - cfg.mimo.ema_alpha) * state.prev_max
                )
                if mesh is not None and DIR_AXIS in mesh.axis_names:
                    # Replicated compute -> slice this shard's direction
                    # chunk (out spec P(dir)); the EMA max is already global.
                    n_dir = dict(
                        zip(mesh.axis_names, mesh.devices.shape)
                    )[DIR_AXIS]
                    d_local = d_total // n_dir
                    powers = jax.lax.dynamic_slice_in_dim(
                        powers, jax.lax.axis_index(DIR_AXIS) * d_local,
                        d_local,
                    )
                return powers, prev_max
            w = mimo_w if mask is None else mimo_w * mask[:, None]
            if dsp.compute == "bfloat16":
                beam = dl.das_beam(
                    window.astype(jnp.bfloat16),
                    w.astype(jnp.bfloat16),
                    precision=jax.lax.Precision.DEFAULT,
                    axis_name=axis_name,
                )
            else:
                beam = dl.das_beam(window, w, axis_name=axis_name)
            tb = beam.shape[-1]
            powers = dl.das_power(
                beam, use_bandpass=dsp.use_bandpass, divisor=tb * n_active
            )
            local_max = jnp.max(powers)
            if axis_name is not None and mesh is not None and DIR_AXIS in mesh.axis_names:
                global_max = jax.lax.pmax(local_max, DIR_AXIS)
            else:
                global_max = local_max
            prev_max = (
                global_max * cfg.mimo.ema_alpha
                + (1.0 - cfg.mimo.ema_alpha) * state.prev_max
            )
            return powers, prev_max

        if not enable_mimo:
            powers = jnp.zeros((state.powers.shape[0],), jnp.float32)
            prev_max = state.prev_max
        elif cfg.mimo.heatmap_every > 1:
            # Display-rate decimation (MimoConfig.heatmap_every): recompute
            # the heatmap on every k-th block, carry it in between.  The
            # predicate is replicated, so every shard takes the same branch
            # and the in-branch collectives stay uniform.
            powers, prev_max = jax.lax.cond(
                jnp.mod(state.block_index, cfg.mimo.heatmap_every) == 0,
                _heatmap,
                lambda _: (state.powers, state.prev_max),
                None,
            )
        else:
            powers, prev_max = _heatmap(None)

        # --- GRADIENT tracker + MISO listener workers, fused into one
        # monopulse dispatch chain when both are on
        # (gradient_ascend.cpp:301-409, miso.cpp:25-55).
        if use_fused:
            swarm, targets, miso_p, miso_beam = fused_impl(
                state.swarm, state.miso.particle, window,
                state.block_index, pts, mask,
            )
            miso = state.miso._replace(particle=miso_p)
        else:
            if enable_tracker:
                swarm, targets = swarm_impl(
                    state.swarm, window, state.block_index, pts, mask
                )
            else:
                swarm = state.swarm
                z = jnp.zeros((nt,), jnp.float32)
                targets = tk.Targets(z, z, z, z, z, jnp.zeros((nt,), bool))

            if enable_miso:
                miso, miso_beam = miso_impl(state.miso, window, pts, mask)
            else:
                miso = state.miso
                miso_beam = jnp.zeros((t_len,), jnp.float32)

        new_state = AwpuState(
            history=history,
            swarm=swarm,
            miso=miso,
            prev_max=prev_max,
            block_index=state.block_index + 1,
            powers=powers,
        )
        return new_state, AwpuOutputs(powers, targets, miso_beam, prev_max)

    def _scan(state, blocks, pts, mask, mimo_w):
        """Drive M stacked blocks [M, C, T] through _step on device —
        one dispatch per M blocks instead of per block, amortizing host
        round-trip latency (outputs stack along the leading axis)."""

        def body(st, blk):
            return _step(st, blk, pts, mask, mimo_w)

        return jax.lax.scan(body, state, blocks)

    # Heatmap-only pipelines have no cross-block state besides the ring and
    # the EMA max, so chunked streaming applies: each scan step pushes
    # ``chunk`` blocks at once and beamforms all their windows as ONE
    # batched dispatch (bit-identical per-block powers, matmuls chunk-x
    # bigger).  The EMA max recurrence is
    # linear, so the per-block EMA is reconstructed exactly from the chunk's
    # block maxima by a tiny associative_scan.
    heatmap_chunk = (
        cfg.mimo.heatmap_chunk
        if (enable_mimo and not enable_tracker and not enable_miso)
        else 0
    )

    def _ema_chain(maxes, prev_max, ck):
        """All ck EMA states of m_j = a*max_j + (1-a)*m_{j-1} in closed
        form (the recurrence is linear)."""
        a = cfg.mimo.ema_alpha
        decay = (1.0 - a) ** jnp.arange(ck, dtype=maxes.dtype)
        contrib = jnp.cumsum(a * maxes / decay) * decay
        return contrib + prev_max * (1.0 - a) ** jnp.arange(
            1, ck + 1, dtype=maxes.dtype
        )

    def _chunk_scan(state, blocks, pts, mask, mimo_w):
        """[M, C, T] blocks, M a multiple of ``heatmap_chunk``."""
        ck = heatmap_chunk
        m = blocks.shape[0]
        c_rows = blocks.shape[1]
        hist_len = ck * t_len + dsp.shift_range + rg.LOOKAHEAD_GUARD
        # Carry a chunk-sized ring seeded from the step-sized one (zeros
        # before it, exactly like a freshly warmed stream).
        hist0 = jnp.zeros((c_rows, hist_len), blocks.dtype)
        hist0 = rg.ring_push(hist0, state.history[..., -min(hist_len, state.history.shape[-1]):])
        big = jnp.swapaxes(blocks, 0, 1).reshape(c_rows, m * t_len)

        def body(carry, i):
            hist, prev_max = carry
            hist = rg.ring_push(
                hist, jax.lax.dynamic_slice_in_dim(big, i * ck * t_len, ck * t_len, axis=1)
            )
            windows = rg.ring_windows(hist, t_len, dsp.shift_range, taps, ck)
            if fft_model is not None:
                from beamforming_lk_tpu.ops import fft_das as fd

                powers = fd.fft_heatmap_powers_chunked(
                    windows, fft_model
                )                                             # [ck, D]
            else:
                w = mimo_w if mask is None else mimo_w * mask[:, None]
                if dsp.compute == "bfloat16":
                    beams = jax.vmap(
                        lambda win: dl.das_beam(
                            win.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                            precision=jax.lax.Precision.DEFAULT,
                        )
                    )(windows)
                else:
                    beams = jax.vmap(lambda win: dl.das_beam(win, w))(windows)
                powers = dl.das_power(
                    beams, use_bandpass=dsp.use_bandpass,
                    divisor=beams.shape[-1] * n_active,
                )
            emas = _ema_chain(jnp.max(powers, axis=-1), prev_max, ck)
            return (hist, emas[-1]), (powers, emas)

        (hist, prev_max), (powers, emas) = jax.lax.scan(
            body, (hist0, state.prev_max), jnp.arange(m // ck)
        )
        powers = powers.reshape(m, -1)
        emas = emas.reshape(m)
        new_state = state._replace(
            history=rg.ring_push(state.history, big[..., -min(state.history.shape[-1], m * t_len):]),
            prev_max=prev_max,
            block_index=state.block_index + m,
            powers=powers[-1],
        )
        z = jnp.zeros((m, nt), jnp.float32)
        targets = tk.Targets(z, z, z, z, z, jnp.zeros((m, nt), bool))
        outs = AwpuOutputs(
            powers=powers,
            targets=targets,
            miso_beam=jnp.zeros((m, t_len), jnp.float32),
            prev_max=emas,
        )
        return new_state, outs

    if mesh is None:
        pts_dev = jnp.asarray(points_np)
        mask_dev = None if mask_np is None else jnp.asarray(mask_np)
        w_dev = jax.device_put(mimo_weights)
        # The heatmap stencil is large (D*C*S floats); it must be a runtime
        # argument — a closed-over concrete array would be baked into the
        # compiled program as a literal constant.
        # (No donation: state pytrees can alias leaves — e.g. zero-filled
        # particle fields share a buffer — and donating aliased leaves is an
        # error.  The ring history is small, so the copy is negligible.)
        jitted = jax.jit(_step)
        jitted_scan = jax.jit(_scan)
        jitted_chunk = (
            jax.jit(_chunk_scan) if heatmap_chunk and heatmap_chunk > 1 else None
        )

        def step(state, block):
            return jitted(state, block, pts_dev, mask_dev, w_dev)

        def scan_step(state, blocks):
            if jitted_chunk is not None and blocks.shape[0] % heatmap_chunk == 0:
                return jitted_chunk(state, blocks, pts_dev, mask_dev, w_dev)
            return jitted_scan(state, blocks, pts_dev, mask_dev, w_dev)

        step.scan = scan_step
        # AOT handles for profiling/cost analysis (benchmarks/scaling.py
        # lowers these to read per-device compiled FLOPs).
        step._jitted = jitted
        step._jitted_scan = jitted_scan
        step._operands = (pts_dev, mask_dev, w_dev)
        return step

    # --- Sharded build: the array model becomes shard_map operands.
    ch = CH_AXIS if CH_AXIS in mesh.axis_names else None
    dr = DIR_AXIS if DIR_AXIS in mesh.axis_names else None
    state_specs = AwpuState(
        history=P(ch, None),
        swarm=jax.tree.map(lambda _: P(), tk.swarm_init(cfg.tracker, jax.random.PRNGKey(0))),
        miso=jax.tree.map(lambda _: P(), ms.miso_init()),
        prev_max=P(),
        block_index=P(),
        powers=P(dr),
    )
    out_specs = AwpuOutputs(
        powers=P(dr),
        targets=jax.tree.map(
            lambda _: P(),
            tk.Targets(*([0] * 6)),
        ),
        miso_beam=P(),
        prev_max=P(),
    )
    mask_spec = () if mask_np is None else (P(ch),)
    mask_args = () if mask_np is None else (
        jax.device_put(jnp.asarray(mask_np), NamedSharding(mesh, P(ch))),
    )

    def _sharded(state, block, pts, mimo_w, *mask_arg):
        m = mask_arg[0] if mask_arg else None
        return _step(state, block, pts, m, mimo_w)

    def _sharded_scan(state, blocks, pts, mimo_w, *mask_arg):
        m = mask_arg[0] if mask_arg else None
        return _scan(state, blocks, pts, m, mimo_w)

    # Stacked outputs gain a leading (unsharded) M axis.
    scan_out_specs = jax.tree.map(
        lambda s: P(*((None,) + tuple(s))), out_specs
    )
    sharded = jax.shard_map(
        _sharded,
        mesh=mesh,
        in_specs=(state_specs, P(ch, None), P(None, ch), P(dr, ch, None))
        + mask_spec,
        out_specs=(state_specs, out_specs),
    )
    sharded_scan = jax.shard_map(
        _sharded_scan,
        mesh=mesh,
        in_specs=(state_specs, P(None, ch, None), P(None, ch), P(dr, ch, None))
        + mask_spec,
        out_specs=(state_specs, scan_out_specs),
    )
    pts_dev = jax.device_put(
        jnp.asarray(points_np), NamedSharding(mesh, P(None, ch))
    )
    w_dev = jax.device_put(
        jnp.asarray(mimo_weights), NamedSharding(mesh, P(dr, ch, None))
    )
    jitted = jax.jit(sharded)
    jitted_scan = jax.jit(sharded_scan)

    def step(state, block):
        return jitted(state, block, pts_dev, w_dev, *mask_args)

    def scan_step(state, blocks):
        return jitted_scan(state, blocks, pts_dev, w_dev, *mask_args)

    step.scan = scan_step
    step._jitted = jitted
    step._jitted_scan = jitted_scan
    step._operands = (pts_dev, w_dev) + mask_args
    return step


def awpu_init(
    cfg: Config,
    channels: int,
    mesh: Optional[Mesh] = None,
    seed: int = 0,
) -> AwpuState:
    """Fresh carried state (ring empty, swarm randomized, MISO at boresight)."""
    history = rg.ring_init(channels, cfg.dsp.history)
    if mesh is not None:
        ch = CH_AXIS if CH_AXIS in mesh.axis_names else None
        history = jax.device_put(history, NamedSharding(mesh, P(ch, None)))
    powers = jnp.zeros((cfg.mimo.n_directions,), jnp.float32)
    if mesh is not None:
        dr = DIR_AXIS if DIR_AXIS in mesh.axis_names else None
        powers = jax.device_put(powers, NamedSharding(mesh, P(dr)))
    return AwpuState(
        history=history,
        swarm=tk.swarm_init(cfg.tracker, jax.random.PRNGKey(seed)),
        miso=ms.miso_init(),
        prev_max=jnp.zeros((), jnp.float32),
        block_index=jnp.zeros((), jnp.int32),
        powers=powers,
    )


class AwpuPipeline:
    """Host-side orchestrator for one array link — the ``AWProcessingUnit``
    equivalent (``src/aw_processing_unit/aw_processing_unit.h:26-151``).

    Owns the fused step, carried state, and block feeding; exposes the same
    surface: ``process_block``, ``steer``, ``targets``, ``heatmap``.
    """

    def __init__(
        self,
        cfg: Config,
        points=None,
        channel_mask=None,
        mesh: Optional[Mesh] = None,
        seed: int = 0,
        enable_mimo: bool = True,
        enable_tracker: bool = True,
        enable_miso: bool = True,
        heatmap_mode: str = "das",
        channels: Optional[int] = None,
        music_solver: str = "subspace",
        music_sources: int = 3,
        mvdr_refresh: int = 1,
    ):
        self.cfg = cfg
        if points is None:
            if channels is None:
                channels = cfg.array.elements
            points = ant.multi_array_cluster(
                channels, cfg.array.columns, cfg.array.rows, cfg.array.distance
            )
        self.points = np.asarray(points, np.float32)
        self.mesh = mesh
        self.channel_mask = channel_mask
        self.heatmap_mode = heatmap_mode
        self._enable_mimo = enable_mimo and heatmap_mode == "das"
        self._enable_tracker = enable_tracker
        self._enable_miso = enable_miso
        self.step = make_awpu_step(
            self.points,
            cfg,
            channel_mask=channel_mask,
            mesh=mesh,
            enable_mimo=enable_mimo and heatmap_mode == "das",
            enable_tracker=enable_tracker,
            enable_miso=enable_miso,
        )
        self.state = awpu_init(cfg, self.points.shape[1], mesh=mesh, seed=seed)
        self.last: Optional[AwpuOutputs] = None
        # Adaptive (MVDR/Capon) heatmap as an alternative to DAS power —
        # a capability the reference does not have (models/mvdr.py).
        self._mvdr_step = None
        if heatmap_mode == "mvdr":
            from beamforming_lk_tpu.models import mvdr as mv

            theta, phi = mm.make_mimo_grid(cfg.mimo)
            self._mvdr_step, n_bins = mv.make_mvdr_step(
                self.points, theta, phi, cfg.array, channel_mask=channel_mask,
                weight_refresh=mvdr_refresh,
            )
            self._mvdr_state = self._mvdr_step.init()
            self._mvdr_powers = None
            self._mvdr_prev = jnp.zeros((), jnp.float32)
        elif heatmap_mode == "music":
            # Subspace DOA pseudo-spectrum (models/music.py) rendered
            # through the same heatmap path as MVDR.
            from beamforming_lk_tpu.models import music as mu

            theta, phi = mm.make_mimo_grid(cfg.mimo)
            self._mvdr_step, n_bins = mu.make_music_step(
                self.points, theta, phi, cfg.array, channel_mask=channel_mask,
                solver=music_solver, n_sources=music_sources,
            )
            self._mvdr_state = self._mvdr_step.init()
            self._mvdr_powers = None
            self._mvdr_prev = jnp.zeros((), jnp.float32)
        if mesh is not None:
            ch = CH_AXIS if CH_AXIS in mesh.axis_names else None
            self._block_sharding = NamedSharding(mesh, P(ch, None))
        else:
            self._block_sharding = None

    def process_block(self, block) -> AwpuOutputs:
        """Feed one [C, T] sample block through the fused step."""
        block = jnp.asarray(block, jnp.float32)
        if self._block_sharding is not None:
            block = jax.device_put(block, self._block_sharding)
        if self._mvdr_step is not None:
            self._mvdr_state, self._mvdr_powers = self._mvdr_step(
                self._mvdr_state, block
            )
        self.state, self.last = self.step(self.state, block)
        return self.last

    def process_blocks(self, blocks) -> AwpuOutputs:
        """Drive M stacked blocks [M, C, T] in ONE device dispatch (on-device
        lax.scan) — amortizes host/dispatch latency for offline replay and
        batch processing.  Outputs stack on the leading axis; ``self.last``
        keeps the final block's outputs for heatmap()/targets()."""
        blocks = jnp.asarray(blocks, jnp.float32)
        if self._block_sharding is not None:
            from jax.sharding import NamedSharding as NS, PartitionSpec as PS

            ch = self._block_sharding.spec[0]
            blocks = jax.device_put(
                blocks, NS(self.mesh, PS(None, ch, None))
            )
        if self._mvdr_step is not None:
            # Whole batch as one on-device lax.scan (models/mvdr.py
            # _attach_scan) — no per-block host round trip.
            self._mvdr_state, stacked_p = self._mvdr_step.scan(
                self._mvdr_state, blocks
            )
            self._mvdr_powers = stacked_p[-1]
        self.state, stacked = self.step.scan(self.state, blocks)
        self.last = jax.tree.map(lambda x: x[-1], stacked)
        return stacked

    def calibrate(self, blocks=None, apply_gains: bool = False) -> "object":
        """Auto-calibrate from sample blocks and rebuild the step with the
        resulting channel mask (AWProcessingUnit::calibrate,
        aw_processing_unit.cpp:102-212: the reference waits for a full ring
        — 4 barriers — snapshots it, and masks dead/hot mics).

        ``blocks``: iterable of [C, T] blocks to fill the ring with (defaults
        to whatever history is already carried).  ``apply_gains`` folds the
        per-channel power-correction gains into the mask (the reference
        computes them but never applies them).  Returns the
        CalibrationResult.
        """
        from beamforming_lk_tpu.models.calibration import calibrate as _cal

        if blocks is not None:
            for b in blocks:
                self.process_block(b)
        result = _cal(np.asarray(self.state.history))
        mask = np.asarray(result.mask, np.float32)
        if apply_gains:
            # gains are power corrections; beam amplitudes scale by sqrt.
            mask = mask * np.sqrt(np.asarray(result.gains, np.float32))
        self.channel_mask = mask
        self.step = make_awpu_step(
            self.points,
            self.cfg,
            channel_mask=mask,
            mesh=self.mesh,
            enable_mimo=self._enable_mimo,
            enable_tracker=self._enable_tracker,
            enable_miso=self._enable_miso,
        )
        return result

    def steer(self, theta: float, phi: float) -> None:
        """Pin the MISO listener (click-to-steer; aw_processing_unit.cpp:261-265)."""
        self.state = self.state._replace(
            miso=ms.miso_steer(self.state.miso, theta, phi)
        )

    def targets(self):
        """Last published target list as host values
        (worker.h:136-142 snapshot semantics)."""
        if self.last is None:
            return []
        from beamforming_lk_tpu.models.targets import targets_to_list

        return targets_to_list(self.last.targets)

    def save(self, path: str) -> None:
        """Checkpoint the carried state (ring history, swarm, MISO, EMA).

        The reference's ``save_pipeline`` is a dead stub
        (pipeline.cpp:300-315); this is a working resume path.
        """
        from beamforming_lk_tpu.io.checkpoint import save_state

        save_state(path, jax.tree.map(np.asarray, self.state))

    def restore(self, path: str) -> None:
        from beamforming_lk_tpu.io.checkpoint import load_state

        loaded = load_state(path, self.state)
        if self.mesh is not None:
            ch = CH_AXIS if CH_AXIS in self.mesh.axis_names else None
            hist = jax.device_put(
                loaded.history, NamedSharding(self.mesh, P(ch, None))
            )
            loaded = loaded._replace(history=hist)
        self.state = jax.tree.map(jnp.asarray, loaded)

    def heatmap(self):
        """Render the last powers to a uint8 [rows, cols] image."""
        if self._mvdr_step is not None and self._mvdr_powers is not None:
            img, self._mvdr_prev = mm.render_heatmap(
                self._mvdr_powers,
                self.cfg.mimo.rows,
                self.cfg.mimo.columns,
                self._mvdr_prev,
                ema_alpha=self.cfg.mimo.ema_alpha,
                use_db=self.cfg.mimo.use_db,
            )
            return np.asarray(img)
        if self.last is None:
            return np.zeros((self.cfg.mimo.rows, self.cfg.mimo.columns), np.uint8)
        img, _ = mm.render_heatmap(
            self.last.powers,
            self.cfg.mimo.rows,
            self.cfg.mimo.columns,
            self.state.prev_max,
            ema_alpha=1.0,  # prev_max already EMA'd inside the step
            use_db=self.cfg.mimo.use_db,
        )
        return np.asarray(img)
