#!/usr/bin/env python3
"""Smoke run of brotli_tpu on one GPU, through the library's entry points.

  python chip_smoke.py               # phases 1-4 on one card
  python chip_smoke.py --four-gpus   # only the four-card phase

Phases (all data from `--seed`, see brotli_tpu/corpus.py):
  1. bulk encode: 1024 x 32 KiB of text/HTML encoded on the device
     (`encode_sharded_device`: chain depth 4, 8 table groups, 8 literal
     context trees), decoded on the device (`decode_batch`) and checked
     bit-exact; 16 streams also decoded by the host decoder and by the
     python golden decoder (decode/engine.py), which shares no code with
     the kernel.
  2. full-format decode: distinct host-encoded streams (q5/q11, TEXT and
     GENERIC, 2-64 KiB heavy-tailed, a FONT q11 stream with >= 16 block
     types per category, a multi-metablock stream of >= 1 MiB) spread over
     >= 4096 shuffled lanes, >= 64 MB decoded in one call; plus a
     custom-dictionary batch.  Every lane checked bit-exact.
  3. malformed lanes: 8 truncated copies inside the phase-2 batch must be
     flagged by the device and rejected by the host decoder.
  4. compiled memory of the decoder at the phase-2 shapes, and the
     device's peak memory.

Each phase prints one JSON line; times are smoke wall seconds, not a
benchmark.  Any failed check raises.  The last line is the device summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def card() -> str:
    """`name, power limit` of the card, from a child that does not use JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def emit(phase: str, env: dict, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, **env}), flush=True)


def phase_bulk(seed: int, env: dict) -> None:
    import numpy as np

    import brotli_tpu
    from brotli_tpu import corpus
    from brotli_tpu.decode.engine import decode as golden_decode
    from brotli_tpu.ops.batch_decode import decode_batch

    n_chunks, chunk = 1024, 32768
    data = corpus.bulk(n_chunks * chunk, seed)
    t0 = time.perf_counter()
    streams = brotli_tpu.encode_sharded_device(
        data, chunk_size=chunk, chain_depth=4, table_groups=8,
        lit_ctx_trees=8)
    t_enc = time.perf_counter() - t0
    check(len(streams) == n_chunks, "one stream per chunk")
    t0 = time.perf_counter()
    res = decode_batch(streams)
    t_dec = time.perf_counter() - t0
    chunks = [data[i * chunk:(i + 1) * chunk] for i in range(n_chunks)]
    exact = sum(o == c for o, c in zip(res.outputs, chunks))
    check(exact == n_chunks, f"device round trip {exact}/{n_chunks}")
    check(res.fallback_lanes == 0 and res.error_lanes == 0, "no fallback")
    pick = np.linspace(0, n_chunks - 1, 16).astype(int)
    for i in pick:
        check(brotli_tpu.decode(streams[i]) == golden_decode(streams[i])
              == chunks[i], f"host decode {i}")
    n_in = sum(map(len, streams))
    emit("bulk_encode_roundtrip", env, lanes=n_chunks, bytes_in=len(data),
         bytes_compressed=n_in, ratio=n_in / len(data),
         bytes_out=sum(map(len, res.outputs)), fallback_lanes=res.fallback_lanes,
         relaunched_lanes=res.relaunched_lanes, golden_checked=len(pick),
         smoke_encode_s=t_enc, smoke_decode_s=t_dec)


def distinct_streams(seed: int):
    """[(stream, decoded)] host-encoded with the library's own encoder."""
    import brotli_tpu
    from brotli_tpu import corpus

    out = []
    for k, n in enumerate(corpus.web_lengths(48, seed)):
        d = corpus.web_asset(int(n), seed * 1000 + k)
        q = 11 if k % 6 == 0 else 5
        out.append((brotli_tpu.encode(d, quality=q, lgwin=22,
                                      mode=(0, 1)[k % 2]), d))
    f = corpus.font(196608, seed)
    out.append((brotli_tpu.encode(f, quality=11, lgwin=22, mode=2), f))
    big = corpus.bulk(1 << 20, seed + 1)
    out.append((corpus.multi_metablock_stream(big), big))
    return out


def phase_full(seed: int, env: dict, n_lanes: int = 4096,
               min_bytes: int = 64 << 20) -> None:
    import jax
    import numpy as np

    from brotli_tpu import corpus
    from brotli_tpu.decode.bitreader import BitReader, BrotliError
    from brotli_tpu.decode.engine import (
        _MetablockState, _decode_window_bits, _read_metablock_length)
    from brotli_tpu.ops.batch_decode import DecodeJob, decode_batch

    t0 = time.perf_counter()
    distinct = distinct_streams(seed)
    t_host = time.perf_counter() - t0
    font_s = distinct[-2][0]
    br = BitReader(font_s)
    _decode_window_bits(br, large_window_enabled=False)
    br.read(2)
    _read_metablock_length(br, True)
    types = _MetablockState(br, large_window=False).num_types
    check(min(types) >= 16, f"FONT stream block types {types}")

    # spread over >= n_lanes shuffled lanes, >= min_bytes decoded
    reps = []
    total = 0
    k = 0
    while len(reps) < n_lanes or total < min_bytes:
        reps.append(k % len(distinct))
        total += len(distinct[k % len(distinct)][1])
        k += 1
    order = np.argsort(corpus._uniform(seed, 41, len(reps)))
    lanes = [reps[i] for i in order]
    streams = [distinct[j][0] for j in lanes]
    expected = [distinct[j][1] for j in lanes]
    # phase 3 rides along: truncated copies at seeded positions
    bad_at = sorted(int(x) for x in
                    corpus._uniform(seed, 43, 8) * len(streams))
    for n_bad, i in enumerate(bad_at):
        s = streams[i]
        streams.insert(i + n_bad, s[: max(1, len(s) * (n_bad + 1) // 10)])
        expected.insert(i + n_bad, None)

    t0 = time.perf_counter()
    res = decode_batch(streams)
    t_dec = time.perf_counter() - t0
    good = [i for i, e in enumerate(expected) if e is not None]
    bad = [i for i, e in enumerate(expected) if e is None]
    exact = sum(res.outputs[i] == expected[i] for i in good)
    check(exact == len(good), f"bit-exact {exact}/{len(good)}")
    flagged = sum(res.device_codes[i] != 0 for i in bad)
    rejected = sum(isinstance(res.outputs[i], BrotliError) for i in bad)
    check(flagged == len(bad) and rejected == len(bad),
          f"truncated lanes flagged {flagged}, rejected {rejected}")
    check(res.fallback_lanes == 0, f"fallback lanes {res.fallback_lanes}")
    check(res.error_lanes == len(bad), "error lanes are the truncated ones")
    out_bytes = sum(len(expected[i]) for i in good)
    emit("full_format_decode", env, lanes=len(streams),
         distinct_streams=len(distinct),
         bytes_in=sum(map(len, streams)), bytes_out=out_bytes,
         font_block_types=types, fallback_lanes=res.fallback_lanes,
         relaunched_lanes=res.relaunched_lanes, launches=res.launches,
         smoke_host_encode_s=t_host, smoke_decode_s=t_dec)
    emit("malformed_lanes", env, lanes=len(bad),
         bytes_in=sum(len(streams[i]) for i in bad), bytes_out=0,
         flagged=int(flagged),
         host_rejected=int(rejected), error_lanes=res.error_lanes,
         fallback_lanes=res.fallback_lanes,
         codes=sorted({int(res.device_codes[i]) for i in bad}))

    # custom dictionary: an earlier version of a resource as the dictionary
    dic = corpus.html(65536, seed + 5)
    pairs = [corpus.dictionary_stream(dic, 4096 << (k % 5), seed + k)
             for k in range(8)]
    cd_streams = [pairs[k % 8][0] for k in range(256)]
    t0 = time.perf_counter()
    cd_res = decode_batch(cd_streams, custom_dictionary=dic)
    t_cd = time.perf_counter() - t0
    exact = sum(cd_res.outputs[k] == pairs[k % 8][1] for k in range(256))
    check(exact == 256, f"custom dictionary bit-exact {exact}/256")
    check(cd_res.fallback_lanes == 0, "custom dictionary fallback")
    emit("custom_dictionary_decode", env, lanes=256,
         bytes_in=sum(map(len, cd_streams)),
         bytes_out=sum(map(len, cd_res.outputs)), dictionary_bytes=len(dic),
         fallback_lanes=cd_res.fallback_lanes, smoke_decode_s=t_cd)

    # phase 4: compiled memory of the decoder at the phase-2 shapes
    st = DecodeJob(streams).stage_lanes(list(range(len(streams))))
    mem = st.fn.lower(*st.args).compile().memory_analysis()
    jax.block_until_ready(st.fn(*st.args))
    t0 = time.perf_counter()
    jax.block_until_ready(st.fn(*st.args))
    t_kernel = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    emit("compiled_memory", env, bytes_in=sum(map(len, streams)),
         bytes_out=out_bytes, fallback_lanes=0,
         argument_bytes=mem.argument_size_in_bytes,
         output_bytes=mem.output_size_in_bytes,
         temp_bytes=mem.temp_size_in_bytes,
         generated_code_bytes=mem.generated_code_size_in_bytes,
         peak_bytes_in_use=stats.get("peak_bytes_in_use"),
         lanes=len(st.lanes), smoke_kernel_s=t_kernel)


def phase_four(seed: int, env: dict, chunk: int = 32768,
               interpret: bool = False) -> None:
    """Data-parallel encode and decode over four cards, against one card.
    (`chunk` and `interpret` exist for a CPU rehearsal on virtual devices.)"""
    import jax

    from brotli_tpu import corpus
    from brotli_tpu.ops.batch_decode import decode_batch
    from brotli_tpu.ops.device_encode import encode_device_batch
    from brotli_tpu.parallel.mesh import (
        decode_batches_multichip, encode_batches_multichip, get_mesh)

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    data = corpus.bulk(4 * 1024 * chunk, seed)
    kw = dict(chain_depth=4, table_groups=8, lit_ctx_trees=8)
    mesh = get_mesh(4)
    t0 = time.perf_counter()
    enc4 = encode_batches_multichip(data, mesh, chunk_size=chunk, **kw)
    t_enc4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res4 = decode_batches_multichip(enc4, mesh, interpret=interpret)
    t_dec4 = time.perf_counter() - t0
    dec4 = [o for r in res4 for o in r.values()]
    placed = [r.output_device for r in res4]
    fallback = sum(r.fallback_lanes for r in res4)
    # the one-card reference: the same pieces, all on device 0
    enc1 = []
    for off in range(0, len(data), 1024 * chunk):
        enc1 += encode_device_batch(data[off: off + 1024 * chunk],
                                    chunk_size=chunk, **kw)
    res1 = decode_batch(enc1, interpret=interpret)
    dec1 = res1.values()
    chunks = [data[i: i + chunk] for i in range(0, len(data), chunk)]
    check(enc4 == enc1, "four-card streams equal one-card streams")
    check(dec4 == dec1 == chunks, "decode bit-exact and in order")
    check(len(set(placed)) == 4, f"outputs on {sorted(set(placed))}")
    check(fallback == res1.fallback_lanes == 0, "no fallback")
    emit("four_gpu_data_parallel", env, lanes=len(enc4), bytes_in=len(data),
         bytes_compressed=sum(map(len, enc4)), bytes_out=sum(map(len, dec4)),
         output_devices=placed, fallback_lanes=fallback,
         smoke_encode_s=t_enc4, smoke_decode_s=t_dec4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()

    import jax

    import brotli_tpu  # noqa: F401  (fail before any output without the repo)
    from brotli_tpu.utils.compile_cache import init_compile_cache

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform}")
    init_compile_cache()
    from brotli_tpu.native import build_ffi_lib

    t0 = time.perf_counter()
    build_ffi_lib("cuda")
    t_build = time.perf_counter() - t0
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    name_power = card()
    print(f"card: {name_power}", flush=True)
    print(json.dumps({"phase": "setup", "kernel_build_s": t_build}), flush=True)
    env = {"device": device, "card": name_power}
    if args.four_gpus:
        phase_four(args.seed, env)
    else:
        phase_bulk(args.seed, env)
        phase_full(args.seed, env)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
