"""Decompose the device-vs-host-q5 ratio gap on the chunked corpus.

Exact sizes from the SAME device-parse records under
  (a) per-GROUP shared tables (what the device emits today),
  (b) per-LANE private tables (the table-sharing cost isolated);
the remaining gap to host-q5-chunked (tools/host_q5_chunked.py on the
same input) is parse quality.

Usage: python tools/ratio_decompose.py [n_chunks] [chunk_kb]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

import brotli_tpu.ops.device_encode as DE  # noqa: E402
from tools.ratio_probe import body_bits, data  # noqa: E402

N_CHUNKS = int(sys.argv[1]) if len(sys.argv) > 1 else 128
CHUNK = (int(sys.argv[2]) if len(sys.argv) > 2 else 32) * 1024



def exact_size(state, rec0_np, group_of, modes, nt):
    n_chunks = state["n_chunks"]
    n_used = int(group_of.max()) + 1
    signed_mode = np.asarray([modes[g] == 3 for g in group_of], np.int32)
    hist_fn = DE._jitted_group_hist(n_used, state["hist_stride"], 1)
    flat = np.asarray(hist_fn(state["rec0"],
                              jnp.asarray(group_of.astype(np.int32)),
                              jnp.asarray(signed_mode)))
    tables = [
        DE._group_tables_from_hists(*DE._split_group_hist(flat, j, 1), nt)
        for j in range(n_used)
    ]
    for j, t in enumerate(tables):
        t["mode"] = modes[j] if nt > 1 else 0
    hdr_bits = np.zeros(n_chunks, np.int64)
    for s in range(n_chunks):
        w = DE._header_bits(int(state["n_valid_np"][s]), 22,
                            tables[int(group_of[s])])
        hdr_bits[s] = len(w.take_bytes()) * 8 + w.nbits
    bb = body_bits(rec0_np, group_of, signed_mode, tables, 1, None, None,
                   None)
    return int((((hdr_bits + bb[:n_chunks]) + 7) // 8).sum())


def main():
    state = DE._encode_start(data, CHUNK, 1, 256, None, 4, lit_ctx=True,
                             hist_stride=16)
    rec0_np = np.asarray(state["rec0"])
    n_chunks = state["n_chunks"]

    group_of, modes = DE._cluster_lanes(
        np.asarray(state["rec0_sample_dev"]), 8, n_chunks
    )
    sz = exact_size(state, rec0_np, group_of, modes, 8)
    print(f"(a) shared tables tg=8 nt=8:  {sz/len(data):.4f}", flush=True)

    # (b) per-lane tables: every chunk its own group, mode per chunk
    _, modes1 = DE._cluster_lanes(
        np.asarray(state["rec0_sample_dev"]), 1, n_chunks
    )
    per_lane = np.arange(len(group_of), dtype=np.int64)
    per_lane[n_chunks:] = n_chunks - 1 if n_chunks else 0
    lane_modes = [int(modes[group_of[s]]) for s in range(n_chunks)] + [0]
    # reuse per-chunk signed choice from its shared-group mode
    sz2 = exact_size(state, rec0_np, per_lane[: len(group_of)],
                     lane_modes, 8)
    print(f"(b) per-lane tables nt=8:     {sz2/len(data):.4f}", flush=True)


if __name__ == "__main__":
    main()
