"""Multi-host assembly: per-host FPGA links -> one global sharded window.

The reference scales across machines only by running more independent
processes (SURVEY §2.3).  Here each host ingests its own FPGA links (the
channel shard lives where its UDP packets land), and
``jax.make_array_from_process_local_data`` assembles the logical [C, T]
block without any cross-host copy of sample data; the fused shard_mapped
step then runs unchanged, with psum/ppermute across hosts.

Single-process this degenerates to a device_put — which is how it's tested;
multi-process needs only ``initialize()`` at startup.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beamforming_lk_tpu.parallel.mesh import CH_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """jax.distributed bootstrap (no-op for a single process).

    Returns this process's index.  Call before any jax computation on every
    host; afterwards ``jax.devices()`` spans the slice and meshes built from
    it are global.
    """
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def global_block_from_local(local_block: np.ndarray, mesh: Mesh):
    """Assemble the global [C_global, T] block from this host's channels.

    ``local_block`` [C_local, T] holds the channels whose FPGA links this
    host receives; the global array is sharded ``P(ch, None)`` with each
    shard backed by the contributing host's data (no host-to-host sample
    traffic — beam partials meet later via psum).
    """
    sharding = NamedSharding(mesh, P(CH_AXIS, None))
    return jax.make_array_from_process_local_data(sharding, local_block)
