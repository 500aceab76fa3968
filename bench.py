"""Benchmark on one GPU: batch decode and device encode, end to end.

Prints one JSON line per metric, each naming the device (platform,
device_kind, count) and the card's name and power limit:
  e2e_decode_throughput_1chip     — `decode_batch` of shared-table streams
                                    (`encode_sharded`), compressed bytes on
                                    the host to decoded bytes on the host:
                                    host staging, copies and kernel included
  fullformat_decode_throughput_1chip — the same path on context-modeled,
                                    block-split device-encoded streams
  device_encode_throughput_1chip  — the whole device encode pipeline
                                    (match/parse stages, host table build,
                                    bit pack, stream assembly), steady state,
                                    with its compression ratio

Timing: host clock around work that ends in `block_until_ready` or a host
copy, after an untimed warm-up that compiles and checks the output
bit-exactly.  All inputs come from the seeded corpus (brotli_tpu/corpus.py).
Exits nonzero without a GPU or when any check fails.

Baselines: the reference's single-core JS decode ~0.15 GB/s (BASELINE.md,
noto-tc 7 MB / 47 ms on M2 Max) and q11 encode ~15 MB/s.
"""

from __future__ import annotations

import json
import subprocess
import time

BASELINE_DECODE_GBPS = 0.15   # reference decode, M2 Max single core
BASELINE_ENCODE_MBPS = 15.0   # reference q11 encode, M2 Max single core

E2E_CHUNK = 8192
E2E_LANES = 4096      # 32 MiB per timed batch
ENC_CHUNK = 32768     # 1024 x 32 KiB = 32 MiB per encode batch
ENC_DEPTH = 4
ENC_TABLE_GROUPS = 8
ENC_CTX_TREES = 8
FF_CHUNK = 4096
FF_BATCHES = 4        # 4 x 1024 device-encoded streams
REP = 3


def main() -> None:
    import jax

    from brotli_tpu import corpus
    from brotli_tpu.encode.sharded import encode_sharded
    from brotli_tpu.ops import device_encode as DE
    from brotli_tpu.ops.batch_decode import decode_batch
    from brotli_tpu.utils.compile_cache import init_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    init_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    env = {"device": {"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)},
           "card": card}

    def emit(metric, value, unit, vs_baseline, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "vs_baseline": vs_baseline, **extra, **env}),
              flush=True)

    def timed_decode(streams, expected):
        res = decode_batch(streams)              # warm-up + check
        if res.values() != expected or res.fallback_lanes:
            raise SystemExit("bench decode check failed")
        best = float("inf")
        for _ in range(REP):
            t0 = time.perf_counter()
            decode_batch(streams)
            best = min(best, time.perf_counter() - t0)
        return best, res

    # ---- metric 1: end-to-end decode of shared-table streams ----
    data = corpus.bulk(E2E_LANES * E2E_CHUNK, 1)
    streams = encode_sharded(data, chunk_size=E2E_CHUNK)
    chunks = [data[i: i + E2E_CHUNK] for i in range(0, len(data), E2E_CHUNK)]
    t, res = timed_decode(streams, chunks)
    gbps = len(data) / t / 1e9
    emit("e2e_decode_throughput_1chip", gbps * 1000, "MB/s",
         gbps / BASELINE_DECODE_GBPS, lanes=len(streams),
         batch_mb=len(data) / 1e6, fallback_lanes=res.fallback_lanes,
         error_lanes=res.error_lanes, wall_s=t)

    # ---- metric 2: device encode, whole pipeline steady state ----
    data3 = corpus.bulk(DE.B_LANES * ENC_CHUNK, 3)

    def encode_once():
        state = DE._encode_start(data3, ENC_CHUNK, 1, 2048, None, ENC_DEPTH,
                                 lit_ctx=ENC_CTX_TREES > 1, hist_stride=16)
        DE._encode_mid(state, 22, ENC_TABLE_GROUPS, ENC_CTX_TREES)
        return state, DE.stream_sizes(state)     # status fetch syncs

    state, sizes = encode_once()
    enc_streams = DE._encode_finish(state)
    chunks3 = [data3[i: i + ENC_CHUNK] for i in range(0, len(data3), ENC_CHUNK)]
    if decode_batch(enc_streams).values() != chunks3:
        raise SystemExit("bench encode round trip failed")
    if [len(s) for s in enc_streams] != list(sizes):
        raise SystemExit("bench encode size accounting failed")
    ratio = sum(map(len, enc_streams)) / len(data3)
    t0 = time.perf_counter()
    for _ in range(REP):
        encode_once()
    t_enc = (time.perf_counter() - t0) / REP
    mbps = len(data3) / t_enc / 1e6
    emit("device_encode_throughput_1chip", mbps, "MB/s",
         mbps / BASELINE_ENCODE_MBPS, ratio=ratio, wall_s=t_enc)

    # ---- metric 3: full-format decode of context-modeled streams ----
    ff_data = corpus.bulk(FF_BATCHES * 1024 * FF_CHUNK, 5)
    ff_streams = []
    for k in range(FF_BATCHES):
        piece = ff_data[k * 1024 * FF_CHUNK:(k + 1) * 1024 * FF_CHUNK]
        ff_streams += DE.encode_device_batch(
            piece, chunk_size=FF_CHUNK, chain_depth=ENC_DEPTH,
            table_groups=ENC_TABLE_GROUPS, lit_ctx_trees=ENC_CTX_TREES,
            block_types=2, block_seg=2048)
    ff_chunks = [ff_data[i: i + FF_CHUNK]
                 for i in range(0, len(ff_data), FF_CHUNK)]
    t, res = timed_decode(ff_streams, ff_chunks)
    gbps = len(ff_data) / t / 1e9
    emit("fullformat_decode_throughput_1chip", gbps * 1000, "MB/s",
         gbps / BASELINE_DECODE_GBPS, lanes=len(ff_streams),
         batch_mb=len(ff_data) / 1e6, fallback_lanes=res.fallback_lanes,
         error_lanes=res.error_lanes, wall_s=t,
         peak_bytes_in_use=(devs[0].memory_stats() or {}).get(
             "peak_bytes_in_use"))


if __name__ == "__main__":
    main()
