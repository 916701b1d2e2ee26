"""Device-mesh parallelism for the beamforming data path.

The reference scales by threads within one process plus "run more AWPUs"
(SURVEY §2.3); it has no distributed backend at all.  Here scaling is a
first-class mesh story over XLA collectives:

==========  =============================  ===========================
mesh axis   shards                          communication
==========  =============================  ===========================
``ch``      microphone channels             ``psum`` of partial beams
                                            (tensor-parallel analog)
``dir``     direction grid / probe batch    none (embarrassingly
                                            parallel, data-parallel
                                            analog)
``t``       time axis within a block        ``ppermute`` halo of the
                                            DAS shift span (sequence-
                                            parallel analog)
==========  =============================  ===========================

Multi-host: each host ingests its own FPGA links (channel shards live where
their UDP packets land), `jax.make_array_from_process_local_data` assembles
the global window, and the same ``shard_map`` program runs unchanged.
"""

from beamforming_lk_tpu.parallel.mesh import (
    CH_AXIS,
    DIR_AXIS,
    TIME_AXIS,
    make_mesh,
)
from beamforming_lk_tpu.parallel.das import (
    halo_exchange_time,
    make_sharded_das_power,
    make_time_sharded_beam,
    shard_window,
    shard_weights,
)
