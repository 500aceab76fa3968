"""Profiling: device traces plus per-phase pipeline timing reports.

`trace` wraps jax.profiler.  `profile_decode` splits the batch decode
(ops/batch_decode.py) into host staging, the decode kernel and the copy
back; `profile_device_encode` splits the device encoder at its sync points.
Phases are wall-clock on the host around `block_until_ready`, after an
untimed warm-up run, so compilation never lands in a phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: profile the enclosed device work into `log_dir`
    (read it with `jax.profiler.ProfileData` or tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class Phase:
    """One timed pipeline phase."""

    name: str
    seconds: float
    kind: str                     # "host" | "device"
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


def phase_report(phases: list[Phase], total_bytes: int | None = None) -> str:
    """Aligned text table of a phase list; per-phase MB/s when sized."""
    width = max(len(p.name) for p in phases)
    lines = []
    for p in phases:
        rate = ""
        if total_bytes and p.seconds > 0:
            rate = f"  {total_bytes / p.seconds / 1e6:8.1f} MB/s"
        ex = "  ".join(f"{k}={v}" for k, v in p.extra.items())
        lines.append(f"{p.name:<{width}}  {p.seconds * 1e3:9.2f} ms"
                     f"  [{p.kind}]{rate}  {ex}".rstrip())
    return "\n".join(lines)


def profile_decode(streams: list[bytes], *, custom_dictionary=None,
                   interpret: bool = False):
    """Per-phase timing of one `decode_batch` launch on `streams`.

    Returns (phases, summary): host staging (pack + copy to the device),
    the decode kernel, and the copy back with the split into streams.
    Lanes that would need a relaunch are reported, not timed."""
    import jax
    import numpy as np

    from ..ops.batch_decode import DecodeJob

    job = DecodeJob(streams, custom_dictionary=custom_dictionary,
                    interpret=interpret)
    lanes = [i for i, s in enumerate(job.streams) if s]

    def run():
        t0 = time.perf_counter()
        st = job.stage_lanes(lanes)
        jax.block_until_ready(st.args)
        t1 = time.perf_counter()
        out, status = jax.block_until_ready(st.fn(*st.args))
        t2 = time.perf_counter()
        status = np.asarray(status)
        out = np.asarray(out)
        res = [out[o: o + n].tobytes()
               for o, n in zip(st.out_off, status[: len(st.lanes), 1])]
        t3 = time.perf_counter()
        return (t1 - t0, t2 - t1, t3 - t2), status[: len(st.lanes)], res

    run()                                       # warm: compile + build
    (t_stage, t_kernel, t_back), status, res = run()
    codes = status[:, 0]
    total = int(sum(len(r) for r, c in zip(res, codes) if c == 0))
    phases = [
        Phase("stage (host pack + copy in)", t_stage, "host",
              {"lanes": len(lanes)}),
        Phase("decode kernel", t_kernel, "device"),
        Phase("copy out + split", t_back, "host"),
    ]
    summary = {
        "bytes": total,
        "e2e_mbps": total / (t_stage + t_kernel + t_back) / 1e6,
        "kernel_mbps": total / t_kernel / 1e6,
        "flagged_lanes": int((codes != 0).sum()),
    }
    return phases, summary


def profile_device_encode(data: bytes, *, chunk_size: int = 32768,
                          chain_depth: int = 4, table_groups: int = 2,
                          lit_ctx_trees: int = 8, hist_stride: int = 16,
                          sample_stride: int = 256):
    """Per-phase timing of the device encode pipeline on `data`.

    One warm run compiles every jit; the timed run then splits the
    steady-state wall into the pipeline's sync points: the match/parse
    stage chain (dispatch + sample-fetch sync), the host cluster/table
    build + histogram/pack/assembly dispatch, and the final size fetch
    that drains the device queue.  Returns (phases, summary) with the
    steady-state MB/s and exact compressed ratio.  The phase split is
    wall-clock at the sync boundaries, because encode throughput is a
    whole-pipeline number.
    """
    import numpy as np

    from ..ops import device_encode as DE

    def run(timed):
        phases = []
        t0 = time.perf_counter()
        state = DE._encode_start(data, chunk_size, 1, sample_stride, None,
                                 chain_depth, lit_ctx=lit_ctx_trees > 1,
                                 hist_stride=hist_stride)
        np.asarray(state["rec0_sample_dev"])   # sync the stage chain
        phases.append(Phase("match/parse stages", time.perf_counter() - t0,
                            "device", {"chunks": state["n_chunks"]}))
        t0 = time.perf_counter()
        DE._encode_mid(state, 22, table_groups, lit_ctx_trees)
        phases.append(Phase("tables + pack dispatch",
                            time.perf_counter() - t0, "host"))
        t0 = time.perf_counter()
        sizes = DE.stream_sizes(state)
        phases.append(Phase("assembly sync", time.perf_counter() - t0,
                            "device"))
        return phases, sizes

    run(False)                                  # warm: compile everything
    t0 = time.perf_counter()
    phases, sizes = run(True)
    wall = time.perf_counter() - t0
    summary = {
        "bytes": len(data),
        "encode_mbps": len(data) / wall / 1e6,
        "ratio": float(np.sum(sizes)) / len(data),
    }
    return phases, summary
