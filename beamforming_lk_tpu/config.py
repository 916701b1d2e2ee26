"""Typed configuration for the whole framework.

The reference scatters its configuration across compile-time ``#define``s
(array geometry ``src/geometry/antenna.h:16-21``, buffer sizes
``src/fpga/streams.hpp:28-34``, tracker hyperparameters
``src/dsp/gradient_ascend.h:22-35``) and an argparse CLI
(``src/main.cpp:19-97``).  Here everything lives in frozen dataclasses so a
single config object pins down a reproducible, jit-stable setup (all fields
are static from XLA's point of view).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Physical microphone-array model (reference: src/geometry/antenna.h:16-21)."""

    columns: int = 8
    rows: int = 8
    distance: float = 0.02          # mic pitch [m]
    sample_rate: float = 48828.0    # [Hz]
    propagation_speed: float = 340.0  # [m/s]

    @property
    def elements(self) -> int:
        return self.columns * self.rows

    @property
    def samples_per_meter(self) -> float:
        return self.sample_rate / self.propagation_speed

    @property
    def max_delay_samples(self) -> float:
        """Upper bound on steering delay spread across one array.

        The min-subtracted steering delays are bounded by the array's spatial
        extent along any axis: aperture diagonal x fs/c.
        """
        dx = (self.columns - 1) * self.distance
        dy = (self.rows - 1) * self.distance
        return math.hypot(dx, dy) * self.samples_per_meter


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Block/buffer/interp parameters (reference: src/fpga/streams.hpp:28-34,
    src/dsp/delay.cpp)."""

    block_size: int = 256        # N_SAMPLES: samples per processing block
    history: int = 1024          # N_ITEMS_BUFFER: ring history per channel
    shift_range: int = 64        # S: integer-shift span of the DAS kernel;
                                 # must exceed max integer delay + filter taps
    interp: str = "linear"       # "linear" | "fir" fractional-delay interp
    fir_taps: int = 8            # taps of the polyphase FIR bank
    fir_phases: int = 101        # fractional-delay quantization (0.01 steps)
    use_bandpass: bool = True    # 3-tap MA bandpass before power
    normalization: float = float(2 ** 23)  # int24 -> float scale (pipeline.h:25)
    # Matmul input dtype for the MIMO heatmap contraction: "float32"
    # (full-precision parity path, run at HIGHEST precision so no TF32
    # rounding creeps in) or "bfloat16" (bf16 inputs, f32 accumulation;
    # <=~5e-3 relative error on heatmap powers — well inside the
    # reference's own -Ofast float32 envelope).
    compute: str = "float32"
    # Matmul input dtype for the tracker/MISO monopulse PROBE beams (the
    # sequential swarm scan that dominates the fused step).  Probe powers
    # only feed the monopulse discriminants — normalized power differences
    # — so "bfloat16" keeps tracking accuracy (validated by
    # benchmarks/tracking_accuracy.py).  The MISO *audio* beam stays
    # float32 either way.
    probe_compute: str = "float32"

    @property
    def block_seconds(self) -> float:
        return self.block_size / 48828.0


@dataclasses.dataclass(frozen=True)
class MimoConfig:
    """Heatmap grid (reference: src/dsp/mimo.cpp:20-59, src/main.cpp:38-41)."""

    rows: int = 64
    columns: int = 64
    fov_degrees: float = 180.0
    ema_alpha: float = 0.2       # running-max EMA (mimo.cpp:75-76)
    use_db: bool = False
    # Heatmap compute backend: "dense" (shift-matmul stencil, any geometry /
    # mask / mesh) or "fft" (separable frequency-domain transform — ~20x
    # fewer FLOPs and exact fractional delays, for planar-lattice arrays
    # with binary channel masks on a single device; falls back to dense
    # when those conditions do not hold).
    backend: str = "dense"
    # SRP-PHAT: whiten each channel's spectrum to unit magnitude before
    # beamforming (steered-response power with phase transform) — the
    # standard robust localization weighting for reverberant/colored
    # environments.  Capability beyond the reference; fft backend only.
    phat: bool = False
    # Heatmap cadence divider for the REAL-TIME fused step: compute the
    # heatmap only every k-th block (lax.cond; carried powers are reused
    # in between).  The reference computes a heatmap per block but its UI
    # consumes ~60 fps (aw_control_unit.cpp:189) — every 3rd block at the
    # 190.7 block/s cadence — so 3 is display-rate-faithful and skips 2 of
    # every 3 heatmap computations.  1 = every block (reference worker
    # behavior).  Ignored by the chunked heatmap-only replay path
    # (chunking already amortizes it).
    heatmap_every: int = 1
    # Chunked streaming for heatmap-only pipelines (tracker and MISO off):
    # AwpuPipeline.process_blocks beamforms this many blocks' windows per
    # dispatch — bit-identical per-block powers, matmuls chunk-x bigger
    # (the faster-than-real-time replay shape).  <= 1 disables.
    heatmap_chunk: int = 0

    @property
    def n_directions(self) -> int:
        return self.rows * self.columns


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Gradient-ascent swarm hyperparameters
    (reference: src/dsp/gradient_ascend.h:22-35)."""

    n_seekers: int = 16
    n_trackers: int = 10
    seeker_reset_interval: int = 128
    seeker_spread: float = math.radians(7.0)
    tracker_spread: float = math.radians(2.0)
    tracker_steps: int = 5
    tracker_slowdown: float = 0.1
    tracker_closeness: float = math.radians(5.0)
    error_threshold: float = 1.0
    # Monopulse step scaling: step = gain * spread * discriminant (the
    # discriminant is scale-invariant in [-1, 1]; the reference's
    # PARTICLE_RATE 5e-4 with raw-power-relative gradients is signal-level
    # dependent — see models/tracker.py).
    seeker_step_gain: float = 2.0
    tracker_step_gain: float = 1.0
    # Monopulse probe constellation — the reference's compile-time
    # USE_HORIZONTAL (gradient_ascend.h:34): "quadrant" (= 0, default)
    # probes the diagonals, "horizontal" probes N/E/S/W
    # (Spherical::nearby, geometry.cpp:144-179).
    probe_layout: str = "quadrant"
    fov_degrees: float = 180.0
    iterations: int = 10         # swarm update iterations per block
    # Stop trackers weaker than this fraction of the strongest active one.
    # The monopulse error is ~0 on SIDELOBE peaks too (first sidelobe of an
    # 8x8 rectangular aperture is -13 dB ~= 5% power), so the reference's
    # mean-seeker-power prune (gradient_ascend.cpp:398-408) lets sidelobe
    # trackers through; 0.1 cuts them while keeping real sources within
    # 10 dB.  Set 0.0 for exact reference behavior.
    min_power_fraction: float = 0.1

    @property
    def theta_limit(self) -> float:
        """Half field-of-view in radians (gradient_ascend.cpp:117)."""
        return math.radians(self.fov_degrees / 2.0)


@dataclasses.dataclass(frozen=True)
class TriangulationConfig:
    """Multi-array fusion (reference: src/target_handler/triangulate.cpp:32-36,
    target_handler.cpp:91-128)."""

    distance_threshold: float = 1.0   # max closest-approach between rays [m]
    # Grow the per-track merge box with log(hits) (the reference computes
    # this, CalculateDistanceThreshold target_handler.cpp:116-121, but its
    # CheckTracksForTarget never calls it — default False matches that
    # behavior; True actually applies it).
    adaptive_merge: bool = False
    max_range: float = 20.0           # targets beyond this are rejected [m]
    min_z: float = 0.0                # targets behind the arrays rejected
    near_z: float = 1.0               # closer than this = static noise
    norm_limit: float = 50.0          # sanity cap on intersection norm
    track_merge_distance: float = 1.0  # per-axis merge box [m]
    track_duplicate_eps: float = 1e-15
    track_timeout: float = 0.5        # seconds without a hit -> invalid
    max_tracks: int = 64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Ingest configuration (reference: src/fpga/receiver.h, pipeline.cpp)."""

    address: str = "10.0.0.1"
    ports: tuple = (21844,)
    max_sensors_per_fpga: int = 256   # MAX_N_SENSORS (receiver.h:17)
    column_flip: bool = True          # daisy-chain demux (pipeline.cpp:277-291)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level framework configuration."""

    array: ArrayConfig = dataclasses.field(default_factory=ArrayConfig)
    dsp: DspConfig = dataclasses.field(default_factory=DspConfig)
    mimo: MimoConfig = dataclasses.field(default_factory=MimoConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    triangulation: TriangulationConfig = dataclasses.field(
        default_factory=TriangulationConfig
    )
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)

    def realtime(self) -> "Config":
        """The deployment profile: bf16 compute, separable-fft heatmap,
        display-rate heatmap decimation (recompute every 3rd block — the
        reference UI consumes ~every 3rd map at 60 fps,
        aw_control_unit.cpp:189), and the reference's real until-next-block
        tracker cadence (~2 iterations, gradient_ascend.cpp:315), with
        tracking quality validated by benchmarks/tracking_accuracy.py.
        Defaults stay on the f32/dense/10-iteration parity profile."""
        return dataclasses.replace(
            self,
            dsp=dataclasses.replace(
                self.dsp, compute="bfloat16", probe_compute="bfloat16"
            ),
            mimo=dataclasses.replace(
                self.mimo, backend="fft", heatmap_every=3
            ),
            tracker=dataclasses.replace(self.tracker, iterations=2),
        )
