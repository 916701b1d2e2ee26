"""Ablation profile of the separable fft heatmap path on the device.

Times cumulative prefixes of the fft_das pipeline (same scan-differencing
methodology as bench.py) to find where the per-block time goes:

    v0  ring_push + window slice only
    v1  + forward DFT (+ perm matmul)
    v2  + b1 (Dx x Cx per-bin contraction)
    v3  + b2 (Dy x Cy per-bin contraction)
    v4  + concat + iDFT beam materialization
    v5  + bandpass power (the full production path)

Each prefix returns a scalar-ish reduction of its last intermediate so XLA
cannot dead-code-eliminate the stages under test.

Run:  PYTHONUNBUFFERED=1 python scripts/profile_fft.py [f32|bf16]
"""

from __future__ import annotations

import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig
from beamforming_lk_tpu.io import ring as rg
from beamforming_lk_tpu.models import mimo as mm
from beamforming_lk_tpu.ops import antenna as ant
from beamforming_lk_tpu.ops import delay as dl
from beamforming_lk_tpu.ops import fft_das as fd

N_MICS, GRID, BLOCK, SHIFT = 256, 65, 256, 64
SAMPLE_RATE = 48828.0


def timed_rate(step_scan, history, blocks, n_small=8, target_dt=0.7):
    h, p = step_scan(history, blocks, n_small)
    np.asarray(p)

    def run(n):
        t0 = time.perf_counter()
        _, p = step_scan(history, blocks, n)
        np.asarray(p)
        return time.perf_counter() - t0

    t_small = min(run(n_small) for _ in range(2))
    # estimate then grow to ~target_dt of device time
    t_probe = min(run(n_small + 64) for _ in range(2))
    rate = min(64 / max(t_probe - t_small, 1e-9), 3e5)
    n_big = n_small + max(64, int(np.ceil(rate * target_dt / 8.0)) * 8)
    t_big = min(run(n_big) for _ in range(3))
    dt = max(t_big - t_small, 1e-9)
    return (n_big - n_small) / dt


CHUNK = int(os.environ.get("PROFILE_CHUNK", "0"))


def make_scan(step_fn):
    if CHUNK > 1:
        # Chunked-streaming shape (bench.py make_scan_chunked): batched
        # windows, vmapped stage — n still counts blocks.
        @functools.partial(jax.jit, static_argnums=(2,))
        def scan_chunked(history, big_blocks, n):
            def body(carry, i):
                hist = rg.ring_push(carry, big_blocks)
                wins = rg.ring_windows(hist, BLOCK, SHIFT, dl.LINEAR_TAPS, CHUNK)
                out = jax.vmap(step_fn)(wins)
                return hist, jax.tree.map(lambda x: x[-1], out)

            return jax.lax.scan(body, history, jnp.arange(n // CHUNK))

        return scan_chunked

    @functools.partial(jax.jit, static_argnums=(2,))
    def scan_n(history, blocks, n):
        k = blocks.shape[0]

        def body(carry, i):
            history = rg.ring_push(carry, blocks[i % k])
            window = rg.ring_window(history, BLOCK, SHIFT, dl.LINEAR_TAPS)
            return history, step_fn(window)

        return jax.lax.scan(body, history, jnp.arange(n))

    return scan_n


def main():
    compute = sys.argv[1] if len(sys.argv) > 1 else "bf16"
    arr = ArrayConfig()
    dsp = DspConfig(block_size=BLOCK, shift_range=SHIFT)
    mimo = MimoConfig(rows=GRID, columns=GRID)
    points = ant.multi_array_cluster(N_MICS, arr.columns, arr.rows, arr.distance)
    model = fd.make_fft_heatmap_model(
        np.asarray(points), mimo, dsp, arr,
        compute="bfloat16" if compute == "bf16" else "float32",
    )
    assert model is not None
    c = points.shape[1]
    rng = np.random.default_rng(0)
    blocks_np = rng.standard_normal((8, c, BLOCK)).astype(np.float32)
    if CHUNK > 1:
        reps = -(-CHUNK // 8)
        tiled = np.tile(blocks_np, (reps, 1, 1))[:CHUNK]
        blocks = jax.device_put(
            jnp.asarray(tiled.transpose(1, 0, 2).reshape(c, -1))
        )
        history = jnp.zeros(
            (c, CHUNK * BLOCK + SHIFT + rg.LOOKAHEAD_GUARD), jnp.float32
        )
        print(f"chunked mode: CHUNK={CHUNK}", flush=True)
    else:
        blocks = jax.device_put(jnp.asarray(blocks_np))
        history = jnp.zeros((c, dsp.history), jnp.float32)

    if model.compute == "bfloat16":
        dtype, prec = jnp.bfloat16, jax.lax.Precision.DEFAULT
    else:
        dtype, prec = jnp.float32, jax.lax.Precision.HIGHEST

    def mm_(sub, a, b):
        return jnp.einsum(sub, a.astype(dtype), b.astype(dtype),
                          precision=prec, preferred_element_type=jnp.float32)

    cx = model.ex_s.shape[-1] // 2
    cy = model.ey_s.shape[-1] // 2
    f_half = model.dft.shape[-1] // 2

    def stage_x(window):
        x_ri = mm_("ct,tf->cf", window, model.dft)
        if model.perm_matrix is not None:
            x_ri = mm_("sc,cf->sf", model.perm_matrix, x_ri)
        x = x_ri.reshape(cy, cx, 2, f_half)
        return x[..., 0, :], x[..., 1, :]

    def stage_b1(window):
        x_re, x_im = stage_x(window)
        x_for = jnp.concatenate(
            [jnp.concatenate([x_re, -x_im], axis=1),
             jnp.concatenate([x_im, x_re], axis=1)], axis=0)
        b1 = mm_("fdc,ycf->dyf", model.ex_s, x_for)
        return b1[:, :cy], b1[:, cy:]

    def stage_b2(window):
        b1_re, b1_im = stage_b1(window)
        b1_for = jnp.concatenate(
            [jnp.concatenate([b1_re, -b1_im], axis=1),
             jnp.concatenate([b1_im, b1_re], axis=1)], axis=0)
        dx = b1_re.shape[0]
        b2s = mm_("fdc,xcf->dxf", model.ey_s, b1_for)
        return b2s[:, :dx], b2s[:, dx:]

    def stage_beam(window):
        b2_re, b2_im = stage_b2(window)
        b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)
        beam = mm_("yxf,ft->yxt", b2_ri, model.idft)
        return beam.reshape(model.rows * model.columns, model.block_size)

    import dataclasses as dc

    m_beam = dc.replace(model, power_path="beam")
    m_fused = dc.replace(model, power_path="fused")
    f_half = model.dft.shape[-1] // 2
    d_total = model.rows * model.columns

    def stage_b2s(w):
        b2_re, b2_im = fd._steered_spectra(w, model, mm_model())
        return b2_re, b2_im

    def mm_model():
        def mm(sub, a, b):
            return jnp.einsum(sub, a.astype(dtype), b.astype(dtype),
                              precision=prec, preferred_element_type=jnp.float32)
        return mm

    def w1_bp_only(w):
        b2_re, b2_im = stage_b2s(w)
        mm = mm_model()
        b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)
        bp = mm("yxf,ft->yxt", b2_ri, model.pow_ri)
        return jnp.sum(bp, axis=(0, 1))[:4]

    def w2_bp_sq(w):
        b2_re, b2_im = stage_b2s(w)
        mm = mm_model()
        b2_ri = jnp.concatenate([b2_re, b2_im], axis=-1)
        bp = mm("yxf,ft->yxt", b2_ri, model.pow_ri)
        return jnp.sum(bp * bp, axis=-1).reshape(-1)[:4]

    def w4_pow_concat2d(w):
        # fused power via ONE 2D matmul on the concatenated [M, 2F] planes.
        b2_re, b2_im = stage_b2s(w)
        mm = mm_model()
        m2 = b2_re.shape[0] * b2_re.shape[1]
        b2_ri = jnp.concatenate(
            [b2_re.reshape(m2, f_half), b2_im.reshape(m2, f_half)], axis=1)
        bp = mm("mf,ft->mt", b2_ri, model.pow_ri)
        return jnp.sum(bp * bp, axis=-1)[:4]

    def w5_pow_split(w):
        # fused power WITHOUT the re|im concat: two matmuls, add, square.
        b2_re, b2_im = stage_b2s(w)
        mm = mm_model()
        m2 = b2_re.shape[0] * b2_re.shape[1]
        bp = mm("mf,ft->mt", b2_re.reshape(m2, f_half),
                model.pow_ri[:f_half]) + mm(
            "mf,ft->mt", b2_im.reshape(m2, f_half), model.pow_ri[f_half:])
        return jnp.sum(bp * bp, axis=-1)[:4]

    variants = {
        "v0_window": lambda w: jnp.sum(w[:, -4:], axis=0),
        "v1_dft": lambda w: sum(jnp.sum(p, axis=(0, 1))[:4] for p in stage_x(w)),
        "v2_b1": lambda w: sum(jnp.sum(p, axis=(0, 1))[:4] for p in stage_b1(w)),
        "v3_b2": lambda w: sum(jnp.sum(p, axis=(0, 1))[:4] for p in stage_b2(w)),
        "v4_beam": lambda w: jnp.sum(stage_beam(w), axis=0)[:4],
        "v5_beam_power": lambda w: fd.fft_heatmap_powers(w, m_beam)[:4],
        "v6_fused_power": lambda w: fd.fft_heatmap_powers(w, m_fused)[:4],
        "w1_bp_only": w1_bp_only,
        "w2_bp_sq": w2_bp_sq,
        "w4_pow_concat2d": w4_pow_concat2d,
        "w5_pow_split": w5_pow_split,
    }
    only = os.environ.get("PROFILE_ONLY")
    if only:
        keys = only.split(",")
        variants = {k: variants[k] for k in keys}
    for name, fn in variants.items():
        rate = timed_rate(make_scan(fn), history, blocks)
        print(f"{name}: {rate:9.1f} blocks/s  ({1e6 / rate:8.1f} us/block)",
              flush=True)


if __name__ == "__main__":
    main()
