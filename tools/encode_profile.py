"""Device encoder on the GPU: per-module device time and CPU parity.

  python tools/encode_profile.py [--chunks 1024] [--out chiprun_out/encode_profile]

1. Encodes `corpus.bulk` (chunks x 32 KiB) on the GPU with the bulk-encode
   settings (chain depth 4, 8 table groups, 8 literal context trees), warm,
   and times one whole encode with the host clock.
2. Traces one more encode with `jax.profiler` and sums device time by XLA
   module from the trace; prints each module's share (the bit pack is the
   `_pack_jit` module, the match/parse stages `_device_stages_jit`).
3. Encodes the same input on the CPU backend and compares: total ratio
   (relative difference) and the number of byte-identical streams.
Every stream is also decoded by the host decoder and by the python golden
decoder (decode/engine.py), which shares no code with the native decoders.  Prints
JSON lines with the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_time_by_module(trace_dir: str) -> tuple[dict, dict]:
    """(seconds of GPU time per XLA module, seconds per trace line) from an
    xplane trace.  Modules come from the "XLA Modules" line when the trace
    has one, else from the kernels' `hlo_module` stat."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    modules, kernels, lines = (defaultdict(float) for _ in range(3))
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                sec = ev.duration_ns / 1e9
                lines[line.name] += sec
                if line.name == "XLA Modules":
                    modules[ev.name.split("(")[0]] += sec
                    continue
                for name, value in ev.stats:
                    if name == "hlo_module":
                        kernels[str(value)] += sec
    return dict(modules or kernels), dict(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=1024)
    ap.add_argument("--out", default="chiprun_out/encode_profile")
    args = ap.parse_args()

    import jax

    import brotli_tpu
    from brotli_tpu import corpus
    from brotli_tpu.decode.engine import decode as golden_decode
    from brotli_tpu.ops.device_encode import encode_device_batch
    from brotli_tpu.utils.compile_cache import init_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("encode_profile needs a GPU")
    init_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    env = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "card": card}
    chunk = 32768
    data = corpus.bulk(args.chunks * chunk, 0)
    kw = dict(chunk_size=chunk, chain_depth=4, table_groups=8,
              lit_ctx_trees=8)

    gpu = encode_device_batch(data, **kw)            # warm: compiles
    t0 = time.perf_counter()
    gpu = encode_device_batch(data, **kw)
    t_enc = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    jax.profiler.start_trace(args.out)
    t0 = time.perf_counter()
    encode_device_batch(data, **kw)
    t_traced = time.perf_counter() - t0
    jax.profiler.stop_trace()
    per, lines = device_time_by_module(args.out)
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "metric": "encode_device_time_by_module", "bytes_in": len(data),
        "wall_s": t_enc, "traced_wall_s": t_traced, "device_busy_s": busy,
        "modules": {k: [v, v / busy] for k, v in top},
        "pack_share": sum(v for k, v in per.items() if "_pack" in k) / busy,
        "trace_lines_s": lines, **env}), flush=True)

    with jax.default_device(jax.devices("cpu")[0]):
        cpu = encode_device_batch(data, **kw)
    chunks = [data[i: i + chunk] for i in range(0, len(data), chunk)]
    for streams in (gpu, cpu):
        if [brotli_tpu.decode(s) for s in streams] != chunks:
            raise SystemExit("encode_profile: host decode mismatch")
        if [golden_decode(s) for s in streams] != chunks:
            raise SystemExit("encode_profile: golden decode mismatch")
    r_gpu = sum(map(len, gpu)) / len(data)
    r_cpu = sum(map(len, cpu)) / len(data)
    print(json.dumps({
        "metric": "encode_gpu_vs_cpu", "lanes": len(gpu),
        "ratio_gpu": r_gpu, "ratio_cpu": r_cpu,
        "ratio_rel_diff": (r_gpu - r_cpu) / r_cpu,
        "identical_lanes": sum(a == b for a, b in zip(gpu, cpu)),
        "host_and_golden_decoded_lanes": 2 * len(gpu), **env}), flush=True)


if __name__ == "__main__":
    main()
