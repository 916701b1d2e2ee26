"""Measured multi-device scaling on the virtual CPU mesh.

An analytic communication budget cannot catch SPMD pathologies —
accidental replication, a psum that materializes the full array.  This
benchmark *measures* relative throughput of the real sharded
programs at 1/2/4/8 host devices (``--xla_force_host_platform_device_count``,
the same mechanism the test suite pins) with the GLOBAL problem size held
fixed (strong scaling):

  heatmap_dense_ch  dense DAS heatmap, mic channels sharded (psum beams)
                    over mesh (ch=n, dir=1)   — parallel/das.py story
  fused             the flagship fused step (heatmap + tracker + MISO)
                    over the most-square (ch, dir) mesh
  mvdr_bins         bin-sharded MVDR (models/mvdr.py
                    make_sharded_mvdr_step), covariance EMA sharded over
                    STFT bins, one [D] psum per block
  music_bins        bin-sharded MUSIC (models/music.py
                    make_sharded_music_step, tracked-subspace solver),
                    covariance EMA + signal basis sharded over bins, the
                    [D] pseudo-spectrum + SNR normalizer psum'd
  beam_time         time-sharded DAS beam (parallel/das.py
                    make_time_sharded_beam): each device beamforms its
                    contiguous time chunk after a ppermute left-halo
                    exchange of the S-sample span — the SP/CP story

Each device count runs in its own subprocess (the device count is fixed at
JAX init).  Two measurements per program and device count:

  flops/device   XLA's compiled per-device FLOP count (cost_analysis of the
                 SPMD-partitioned module).  This is the load-bearing
                 replication check and it is DETERMINISTIC: a secretly
                 replicated "sharding" keeps per-device FLOPs flat, a real
                 one divides them by ~n.  The verdict key `sharding_ok`
                 requires per-device FLOPs at the largest mesh <= 45 % of
                 the 1-device count for every program.
  blocks/s       wall-clock throughput, normalized to 1 device.  CPU
                 caveat: all virtual devices share one host thread pool, so
                 the timing curve only rises while spare cores exist (this
                 box has very few); it is reported for context, the FLOP
                 curve carries the claim.  Recorded in docs/multihost.md
                 next to the analytic budget's prediction.

Run:  python benchmarks/scaling.py            (prints a table + JSON line)
      python benchmarks/scaling.py --worker 4 (one device count, JSON only)

Reference analog: the 2-FPGA concurrent-beamforming capability claim
(/root/reference/README.md:10) — scaling evidence the reference never
published.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_COUNTS = (1, 2, 4, 8)
N_BLOCKS = 8
REPS = 3


def _rate(fn, sync, n_items):
    """Best-of-REPS throughput of fn() in items/s (CPU-local: perf_counter
    around a synced call)."""
    fn_out = fn()
    sync(fn_out)  # compile + warm
    best = 0.0
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        best = max(best, n_items / (time.perf_counter() - t0))
    return best


def worker(n: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import (
        Config,
        MimoConfig,
        TrackerConfig,
    )
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.models import mvdr as mv
    from beamforming_lk_tpu.ops import antenna as ant
    from beamforming_lk_tpu.parallel import mesh as pm

    assert len(jax.devices()) >= n, "device split failed"
    rng = np.random.default_rng(0)

    def flops_per_device(jitted, *args):
        """Per-device FLOPs of the compiled SPMD module (the partitioned
        HLO is the per-device program)."""
        cost = jitted.lower(*args).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost.get("flops", float("nan")))

    def emit(bench, blocks_per_s, flops):
        print(json.dumps({
            "bench": bench, "devices": n,
            "blocks_per_s": round(float(blocks_per_s), 3),
            "flops_per_device": flops,
        }))
        sys.stdout.flush()

    # --- 1) dense channel-sharded heatmap: 256 mics, 32x32 dirs ----------
    cfg = Config(mimo=MimoConfig(rows=32, columns=32))
    points = ant.multi_array_cluster(256, 8, 8, 0.02)
    mesh = pm.make_mesh((n, 1))
    step = make_awpu_step(
        points, cfg, mesh=mesh, enable_tracker=False, enable_miso=False
    )
    state = awpu_init(cfg, 256, mesh=mesh)
    blocks = jnp.asarray(
        rng.standard_normal((N_BLOCKS, 256, cfg.dsp.block_size)), jnp.float32
    )
    emit(
        "heatmap_dense_ch",
        _rate(
            lambda: step.scan(state, blocks),
            lambda out: np.asarray(out[1].prev_max), N_BLOCKS,
        ),
        flops_per_device(step._jitted_scan, state, blocks, *step._operands),
    )

    # --- 2) fused step over the most-square (ch, dir) mesh ---------------
    import math

    a = int(math.isqrt(n))
    while n % a or 64 % a:
        a -= 1
    n_ch, n_dir = a, n // a
    cfg_f = Config(
        mimo=MimoConfig(rows=16, columns=16),
        tracker=TrackerConfig(iterations=2),
    )
    pts64 = ant.create_antenna_grid(8, 8, 0.02)
    mesh_f = pm.make_mesh((n_ch, n_dir))
    step_f = make_awpu_step(pts64, cfg_f, mesh=mesh_f)
    state_f = awpu_init(cfg_f, 64, mesh=mesh_f)
    blocks_f = jnp.asarray(
        rng.standard_normal((N_BLOCKS, 64, cfg_f.dsp.block_size)), jnp.float32
    )
    emit(
        "fused",
        _rate(
            lambda: step_f.scan(state_f, blocks_f),
            lambda out: np.asarray(out[1].prev_max), N_BLOCKS,
        ),
        flops_per_device(
            step_f._jitted_scan, state_f, blocks_f, *step_f._operands
        ),
    )

    # --- 3) bin-sharded MVDR (STFT bins across the mesh) ------------------
    theta, phi = mm.make_mimo_grid(MimoConfig(rows=32, columns=32))
    mesh_b = pm.make_mesh((1, n))
    mv_step, mv_state = mv.make_sharded_mvdr_step(
        pts64, theta, phi, mesh_b, axis_name=pm.DIR_AXIS
    )
    blk = jnp.asarray(
        rng.standard_normal((64, cfg.dsp.block_size)), jnp.float32
    )

    def mvdr_many():
        st = mv_state
        p = None
        for _ in range(N_BLOCKS):
            st, p = mv_step(st, blk)
        return p

    emit(
        "mvdr_bins",
        _rate(mvdr_many, lambda p: np.asarray(p), N_BLOCKS),
        flops_per_device(mv_step._jitted, mv_state, blk, *mv_step._operands),
    )

    # --- 4) bin-sharded MUSIC (tracked-subspace solver) -------------------
    from beamforming_lk_tpu.models import music as mu

    mu_step, mu_state = mu.make_sharded_music_step(
        pts64, theta, phi, mesh_b, axis_name=pm.DIR_AXIS, n_sources=3
    )

    def music_many():
        st = mu_state
        p = None
        for _ in range(N_BLOCKS):
            st, p = mu_step(st, blk)
        return p

    emit(
        "music_bins",
        _rate(music_many, lambda p: np.asarray(p), N_BLOCKS),
        flops_per_device(mu_step._jitted, mu_state, blk, *mu_step._operands),
    )

    # --- 5) time-sharded DAS beam (ppermute halo exchange) ----------------
    from jax.sharding import NamedSharding, PartitionSpec as P

    from beamforming_lk_tpu.ops import delay as dl
    from beamforming_lk_tpu.parallel import das as pd

    mesh_t = pm.make_mesh((1, n), axis_names=(pm.DIR_AXIS, pm.TIME_AXIS))
    delays = ant.steering_delays_np(
        pts64, *mm.make_mimo_grid(MimoConfig(rows=16, columns=16)),
        cfg.array.samples_per_meter,
    )
    weights_t = jax.device_put(
        jnp.asarray(dl.das_weights_np(delays, cfg.dsp.shift_range, "linear")),
        NamedSharding(mesh_t, P(pm.DIR_AXIS, None, None)),
    )
    t_total = N_BLOCKS * cfg.dsp.block_size          # >= S per chunk at n=8
    block_t = jax.device_put(
        jnp.asarray(rng.standard_normal((64, t_total)), jnp.float32),
        NamedSharding(mesh_t, P(None, pm.TIME_AXIS)),
    )
    tail_t = jnp.asarray(
        rng.standard_normal((64, cfg.dsp.shift_range)), jnp.float32
    )
    beam_fn = pd.make_time_sharded_beam(mesh_t)
    emit(
        "beam_time",
        _rate(
            lambda: beam_fn(block_t, tail_t, weights_t),
            lambda out: np.asarray(out[:1, :1]), N_BLOCKS,
        ),
        flops_per_device(beam_fn, block_t, tail_t, weights_t),
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args()
    if args.worker:
        from beamforming_lk_tpu.utils.compile_cache import use_compile_cache

        use_compile_cache()
        worker(args.worker)
        return 0

    rows = []
    for n in DEVICE_COUNTS:
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", str(n)],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=3600,
        )
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"worker {n} failed")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))

    base = {r["bench"]: r for r in rows if r["devices"] == 1}
    print(
        f"{'bench':<18}{'devices':>8}{'blocks/s':>12}{'speedup':>9}"
        f"{'GFLOP/dev':>11}{'flop frac':>11}"
    )
    table = []
    for r in rows:
        rel = r["blocks_per_s"] / base[r["bench"]]["blocks_per_s"]
        frac = r["flops_per_device"] / base[r["bench"]]["flops_per_device"]
        table.append({**r, "speedup": round(rel, 3),
                      "flop_fraction": round(frac, 4)})
        print(
            f"{r['bench']:<18}{r['devices']:>8}{r['blocks_per_s']:>12.2f}"
            f"{rel:>9.2f}{r['flops_per_device'] / 1e9:>11.3f}{frac:>11.3f}"
        )
    # Replication check (deterministic): the per-device compiled FLOPs at
    # the largest mesh must be a real fraction of the 1-device program —
    # a replicated "sharding" stays ~1.0.
    nmax = DEVICE_COUNTS[-1]
    verdict = all(
        next(t["flop_fraction"] for t in table
             if t["bench"] == b and t["devices"] == nmax) <= 0.45
        for b in base
    )
    result = {"rows": table, "sharding_ok": bool(verdict)}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if verdict else 1


if __name__ == "__main__":
    sys.exit(main())
