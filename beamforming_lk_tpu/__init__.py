"""beamforming_lk_tpu — an acoustic-array beamforming framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``acoustic-warfare/beamforming-lk`` (a real-time C++ delay-and-sum
beamformer for 8x8 MEMS microphone arrays):

- ``ops``      : steering geometry, fractional-delay DAS kernels (jnp)
- ``models``   : MIMO heatmap, gradient-ascent tracker swarm, MISO listener,
                 Kalman filter, calibration, triangulation/track fusion
- ``io``       : block pipeline, synthetic sources, pcap/UDP ingest, WAV out
- ``parallel`` : device meshes, sharded DAS (psum over channels, halo over time)
- ``app``      : CLI + orchestration (AWPU equivalent)

Design stance (vs the reference's threads + mmap ring buffers): each
256-sample block is one step through jitted functions over arrays shaped
``[channels, time] -> [directions]``; the heatmap, the tracker's monopulse
probes and the MISO beam all route through ONE delay-and-sum kernel, lowered
to a dense shift-matmul.
"""

__version__ = "0.1.0"

from beamforming_lk_tpu.config import (
    ArrayConfig,
    DspConfig,
    MimoConfig,
    TrackerConfig,
)
