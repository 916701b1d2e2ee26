"""Chunk-size sweep of the chunked-streaming fft heatmap on the device.

Times the bench.py fft_bf16 chunked variant at several blocks-per-dispatch
sizes to pick the deployment CHUNK (same scan-differencing methodology).

Run:  PYTHONUNBUFFERED=1 python scripts/sweep_chunk.py [chunks...]
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

import bench
from beamforming_lk_tpu.io import ring as rg
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops import fft_das as fd
from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig


def main():
    power_path = "fused"
    args = []
    for a in sys.argv[1:]:
        if a.isdigit():
            args.append(int(a))
        else:
            power_path = a
    chunks = args or [1, 4, 8, 16, 32]
    arr = ArrayConfig()
    dsp = DspConfig(block_size=bench.BLOCK, shift_range=bench.SHIFT_RANGE)
    mimo = MimoConfig(rows=bench.GRID, columns=bench.GRID)
    from beamforming_lk_tpu.ops import antenna as ant

    points = ant.multi_array_cluster(bench.N_MICS, arr.columns, arr.rows, arr.distance)
    c = points.shape[1]
    model = fd.make_fft_heatmap_model(
        np.asarray(points), mimo, dsp, arr, compute="bfloat16",
        assume_lattice_order=True, power_path=power_path,
    )
    print(f"power_path={power_path}", flush=True)
    rng = np.random.default_rng(0)
    blocks_np = rng.standard_normal((8, c, bench.BLOCK)).astype(np.float32)
    perm = model.channel_perm
    if perm is not None:
        blocks_np = blocks_np[:, perm]

    fn = lambda w: fd.fft_heatmap_powers(w, model)
    for ck in chunks:
        if ck == 1:
            scan_n = bench.make_scan(fn, dl.LINEAR_TAPS)
            hist = jnp.zeros((c, dsp.history), jnp.float32)
            blk = jax.device_put(jnp.asarray(blocks_np))
        else:
            scan_n = bench.make_scan_chunked(fn, dl.LINEAR_TAPS, ck)
            hist = jnp.zeros(
                (c, ck * bench.BLOCK + bench.SHIFT_RANGE + rg.LOOKAHEAD_GUARD),
                jnp.float32,
            )
            reps = -(-ck // 8)
            tiled = np.tile(blocks_np, (reps, 1, 1))[:ck]
            blk = jax.device_put(
                jnp.asarray(tiled.transpose(1, 0, 2).reshape(c, -1))
            )
        base = max(8 * ck, 64)
        rate = bench.timed_rate(scan_n, hist, blk, (), n_small=base,
                                n_large=9 * base)
        print(
            f"chunk={ck:3d}: {rate:9.1f} blocks/s "
            f"({rate * bench.BLOCK / bench.SAMPLE_RATE:7.1f}x realtime, "
            f"{1e6 / rate:6.1f} us/block)",
            flush=True,
        )


if __name__ == "__main__":
    main()
