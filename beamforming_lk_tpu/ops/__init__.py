"""Device compute ops: geometry, steering, delay-and-sum kernels."""

from beamforming_lk_tpu.ops.geometry import (
    cartesian_to_spherical,
    horizontal_to_spherical,
    nearby_probes,
    normalize_spherical,
    quadrant_probes,
    rotation_y,
    rotation_z,
    spherical_angle,
    spherical_chord_distance,
    spherical_to_cartesian,
    smallest_angle,
    wrap_angle,
)
from beamforming_lk_tpu.ops.antenna import (
    create_antenna_grid,
    generate_unit_dome,
    generate_dome_lookup,
    steer_points,
    steering_delays,
    steering_delays_cartesian,
    steering_delays_horizontal,
)
from beamforming_lk_tpu.ops.delay import (
    delay_lut,
    fractional_delay_fir_bank,
    das_beam,
    das_power,
    das_weights,
    unfold_window,
)
from beamforming_lk_tpu.ops.antenna import (  # noqa: F811
    multi_array_cluster,
    sector_masks,
    steering_delays_np,
)
from beamforming_lk_tpu.ops.delay import das_weights_np, bandpass_ma, probe_span
from beamforming_lk_tpu.ops.fft_das import (
    fft_heatmap_powers,
    lattice_factorization,
    make_fft_heatmap_model,
)
from beamforming_lk_tpu.ops.filters import (
    REFERENCE_BANDS,
    bandpass_fractional_bank,
    reference_band_banks,
    windowed_sinc_delay,
)
