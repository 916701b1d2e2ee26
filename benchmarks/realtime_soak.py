"""Real-time soak: native ingest at full FPGA wire rate on loopback.

The reference's entire design contract is "hold the 5.24 ms block deadline
forever" (``src/fpga/streams.hpp:28``, ``pipeline.cpp:243-296``): one
1032-byte UDP packet per sample at 48 828 pkt/s.  This benchmark drives
that exact wire load for a sustained window and reports the health
counters the contract cares about:

  - sender: a separate *process* builds FPGA wire packets (sequential
    header counters) and paces them at real time in 64-packet chunks
    (~1.3 ms cadence — uniform, not per-block bursts)
  - receiver: the native ingest (csrc/ingest.c recvmmsg thread -> complete
    -block ring) pulls [C, T] blocks
  - consumer (optional): the fused AWPU step per block (heatmap + tracker
    + MISO) with BlockMetrics deadline accounting

Reported per phase: packets sent/received, ingest drops (ring overruns),
header counter gaps, block latency percentiles vs the 5.24 ms deadline.

Consumers:
  none — pure ingest: measures that the packet path itself holds the rate
  cpu    — fused step jitted on host CPU (deployment cadence, iterations=2)
  device — fused step (deployment profile) on the default accelerator,
           dispatched in CHUNK-block scans (one scan amortizes dispatch
           overhead); the per-chunk deadline is chunk * 5.24 ms

Each phase runs in its own process, and the sender in another that never
initialises a JAX backend, so only the device phase's process opens the
card.

Usage: python benchmarks/realtime_soak.py [--seconds 10]
           [--consumers none,cpu,device] [--chunk 16]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SAMPLE_RATE = 48828.0
BLOCK = 256
CHUNK = 64           # packets per paced send chunk (~1.31 ms)
POOL_BLOCKS = 64     # pre-built wire pool, counters patched per cycle


def _build_pool(n_sensors: int) -> np.ndarray:
    """Pre-built wire packets for POOL_BLOCKS noise blocks -> [P, 1032] u8."""
    from beamforming_lk_tpu.io import packets as pk

    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((POOL_BLOCKS, n_sensors, BLOCK)).astype(
        np.float32
    ) * 1e-2
    wire = b"".join(
        bytes(pk.build_packets(b, start_counter=i * BLOCK))
        for i, b in enumerate(blocks)
    )
    arr = np.frombuffer(wire, np.uint8).reshape(-1, pk.PACKET_SIZE).copy()
    return arr


def _sender(port: int, n_sensors: int, seconds: float, q) -> None:
    """Paced wire-rate sender (runs in its own process)."""
    import socket

    # The packet builder imports the package; keep this process off the
    # accelerator, which belongs to the consumer.
    os.environ["JAX_PLATFORMS"] = "cpu"

    pool = _build_pool(n_sensors)
    n_pool = pool.shape[0]
    # Header counter lives at byte offset 4..8; PACKET_SIZE = 1032 = 258*4,
    # so a u32 view exposes it as column 1.
    counters = pool.view(np.uint32).reshape(n_pool, -1)[:, 1]

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8 * 1024 * 1024)
    addr = ("127.0.0.1", port)
    n_total = int(seconds * SAMPLE_RATE)
    chunk_period = CHUNK / SAMPLE_RATE

    sent = 0
    late_chunks = 0
    packets = [bytes(pool[i]) for i in range(n_pool)]
    q.put("ready")  # spawn + imports done; consumer may start its clock
    t0 = time.perf_counter()
    while sent < n_total:
        idx = sent % n_pool
        if idx == 0 and sent > 0:
            # Re-stamp the pool's counters for the next cycle (sequential
            # across the whole soak so gap accounting is meaningful).
            counters += np.uint32(n_pool)
            packets = [bytes(pool[i]) for i in range(n_pool)]
        pkt = packets[idx]
        if sent % CHUNK == 0:
            target = t0 + (sent // CHUNK) * chunk_period
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            elif now - target > chunk_period:
                late_chunks += 1
        sock.sendto(pkt, addr)
        sent += 1
    elapsed = time.perf_counter() - t0
    sock.close()
    q.put({
        "packets_sent": sent,
        "send_rate_pkt_s": sent / elapsed,
        "late_chunks": late_chunks,
        "elapsed_s": elapsed,
    })


def _make_cpu_consumer(n_sensors: int):
    """Fused AWPU step jitted on host CPU at the deployment cadence."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import dataclasses

    import jax.numpy as jnp

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import Config
    from beamforming_lk_tpu.ops import antenna as ant

    # Deployment cadence (iterations=2, fused tracker+MISO chain) with the
    # dense f32 heatmap: bf16 is emulated (slow) on CPU, so f32 is the
    # honest host-side configuration.
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, iterations=2)
    )
    rows = int(np.sqrt(n_sensors))
    points = ant.create_antenna_grid(rows, n_sensors // rows, 0.02)
    step = make_awpu_step(points, cfg)
    state = awpu_init(cfg, n_sensors, seed=0)

    def consume(block, _state=[state]):
        _state[0], out = step(_state[0], jnp.asarray(block))
        np.asarray(out.prev_max)  # fence

    # Warm the compile before the soak starts.
    consume(np.zeros((n_sensors, BLOCK), np.float32))
    return consume


def _make_device_consumer(n_sensors: int, chunk: int):
    """Deployment-profile fused step dispatched as chunk-block scans."""
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.config import Config
    from beamforming_lk_tpu.ops import antenna as ant

    cfg = Config().realtime()
    rows = int(np.sqrt(n_sensors))
    points = ant.create_antenna_grid(rows, n_sensors // rows, 0.02)
    step = make_awpu_step(points, cfg)
    state = awpu_init(cfg, n_sensors, seed=0)
    dev = jax.devices()[0]

    # Double-buffered: dispatch chunk N asynchronously and fence its
    # result only when chunk N+1 has been collected — execution overlaps
    # with the next chunk's real-time arrival.  The measured latency per
    # chunk = fence-of-previous + async enqueue of current, i.e. any
    # backpressure from a slow previous chunk shows up in the metrics.
    inflight = [None]

    def consume(blocks, _state=[state]):
        if inflight[0] is not None:
            np.asarray(inflight[0])  # fence chunk N-1 (reliable host fetch)
        _state[0], out = step.scan(_state[0], jax.device_put(blocks, dev))
        inflight[0] = out.prev_max

    consume(np.zeros((chunk, n_sensors, BLOCK), np.float32))  # warm compile
    np.asarray(inflight[0])
    inflight[0] = None
    return consume


def soak(consumer: str, seconds: float, n_sensors: int = 64,
         chunk: int = 16) -> dict:
    from beamforming_lk_tpu.io.native import NativeIngest
    from beamforming_lk_tpu.utils.metrics import BlockMetrics

    if consumer == "cpu":
        consume, group = _make_cpu_consumer(n_sensors), 1
    elif consumer == "device":
        consume, group = _make_device_consumer(n_sensors, chunk), chunk
    else:
        consume, group = None, 1

    with NativeIngest("127.0.0.1", 0, n_sensors=n_sensors,
                      block_size=BLOCK, n_slots=max(32, 4 * group)) as ingest:
        q = mp.Queue()
        proc = mp.Process(
            target=_sender, args=(ingest.port, n_sensors, seconds, q)
        )
        proc.start()
        assert q.get(timeout=120) == "ready"  # sender imports can be slow
        if consume is not None:
            # Re-warm right before the clock starts: the sender's spawn
            # (heavy imports) leaves an idle gap after the compile warm-up.
            consume(np.zeros(
                (group, n_sensors, BLOCK) if group > 1 else (n_sensors, BLOCK),
                np.float32,
            ))
        # Deadline accounting is per dispatch group: `group` blocks of
        # audio buy group * 5.24 ms of budget.  The window covers a whole
        # minutes-long soak so the percentiles are over every dispatch.
        metrics = BlockMetrics(
            block_size=BLOCK * group, sample_rate=SAMPLE_RATE,
            window=1_000_000,
        )
        blocks = 0
        expected = int(seconds * SAMPLE_RATE) // BLOCK
        last_seq = -1
        seq_skips = 0
        pending = []
        while blocks < expected:
            seq, block = ingest.next_block(timeout=2.0)
            if seq is None:
                break  # sender finished and ring drained
            if last_seq >= 0 and seq != last_seq + 1:
                seq_skips += seq - last_seq - 1
            last_seq = seq
            blocks += 1
            if consume is None:
                metrics.start_block()
                metrics.end_block()
                continue
            pending.append(block)
            if len(pending) == group:
                metrics.start_block()
                consume(
                    np.stack(pending) if group > 1 else pending[0]
                )
                metrics.end_block()
                pending.clear()
        sender_stats = q.get(timeout=30)
        proc.join(timeout=30)
        stats = ingest.stats()

    out = {"consumer": consumer, "blocks_consumed": blocks,
           "consumer_seq_skips": seq_skips, "dispatch_group": group}
    out.update(sender_stats)
    out.update(stats)
    out.update(metrics.summary())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--consumers", default="none,cpu")
    ap.add_argument("--sensors", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    args = ap.parse_args()

    mp.set_start_method("spawn")  # no forked JAX state in the sender
    # Each phase in its own process: the cpu consumer pins the JAX platform
    # for its whole process, which must not leak into a device phase.
    for consumer in args.consumers.split(","):
        q = mp.Queue()
        p = mp.Process(
            target=_soak_to_queue,
            args=(q, consumer.strip(), args.seconds, args.sensors,
                  args.chunk),
        )
        p.start()
        r = q.get(timeout=600)
        p.join(timeout=60)
        print(json.dumps(r))
        sys.stdout.flush()


def _soak_to_queue(q, consumer, seconds, sensors, chunk):
    from beamforming_lk_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    try:
        q.put(soak(consumer, seconds, sensors, chunk))
    except Exception as e:  # surface the failure as a result line
        q.put({"consumer": consumer, "error": repr(e)})


if __name__ == "__main__":
    main()
