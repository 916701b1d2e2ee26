"""Application layer: per-array orchestration (AWPU), CLI, rendering.

Re-design of the reference's ``src/aw_processing_unit`` +
``src/aw_control_unit``: instead of one thread per worker sharing mmap ring
buffers behind a condvar barrier (``src/dsp/worker.h:212-224``,
``src/fpga/pipeline.cpp:210-238``), each 256-sample block is ONE step
through ONE jitted (optionally ``shard_map``-sharded) device program that
produces the heatmap powers, the tracker target list and the MISO audio
beam together from a single consistent window snapshot.
"""

from beamforming_lk_tpu.app.awpu import (
    AwpuOutputs,
    AwpuPipeline,
    AwpuState,
    awpu_init,
    make_awpu_step,
)
