"""Exact-size ratio probe for the device encoder (no pack kernel).

Runs the real device stages (XLA on CPU) once per parse config, then for
each table config computes EXACT stream sizes by summing code lengths
over the record arrays in numpy — the sizes the bit pack would emit.
Lets table-side knobs (table_groups, lit_ctx_trees, block_types,
block_seg) be swept without packing.  Input: the seeded bulk corpus.

Usage: python tools/ratio_probe.py [n_chunks] [chunk_kb]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

import brotli_tpu.ops.device_encode as DE

N_CHUNKS = int(sys.argv[1]) if len(sys.argv) > 1 else 128
CHUNK = (int(sys.argv[2]) if len(sys.argv) > 2 else 32) * 1024

from brotli_tpu import corpus  # noqa: E402

data = corpus.bulk(N_CHUNKS * CHUNK, 0)

from brotli_tpu.constants import (
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    INSERT_LENGTH_N_BITS,
    INSERT_LENGTH_OFFSET,
)

INS_NB = np.asarray(INSERT_LENGTH_N_BITS, np.int64)
CP_NB = np.asarray(COPY_LENGTH_N_BITS, np.int64)


def body_bits(rec0, group_of, signed_mode, tables, nbt, seg_of_col,
              seg_type, sw_words):
    """Exact per-lane body bit count from the record array (numpy)."""
    B, R = rec0.shape
    kind = (rec0 >> 28) & 0xF
    code = rec0 & 0x3FFF
    bits = np.zeros((B, R), np.int64)

    # per-lane depth tables
    for g, t in enumerate(tables):
        lanes = group_of == g
        if not lanes.any():
            continue
        lit_depths = np.stack([np.asarray(l[0], np.int64) for l in t["lits"]])
        cmd_d = np.asarray(t["cmd"][0], np.int64)
        dist_d = np.asarray(t["dist"][0], np.int64)
        cmap = np.asarray(t["cmap"], np.int64)
        r0 = rec0[lanes]
        k = kind[lanes]
        c = code[lanes]
        sm = signed_mode[lanes]
        ctx = np.where(sm[:, None] > 0, (r0 >> 20) & 0x3F, (r0 >> 14) & 0x3F)
        if nbt > 1:
            bt = seg_type[lanes][:, seg_of_col]
            cidx = bt * 64 + ctx
        else:
            cidx = ctx if len(t["lits"]) > 1 else np.zeros_like(ctx)
        tree = cmap[np.clip(cidx, 0, cmap.shape[0] - 1)]
        b = np.zeros_like(c, np.int64)
        lit_bits = lit_depths[tree, c & 0xFF]
        b = np.where(k == DE.K_LIT, lit_bits, b)
        # cmd: depth + ins extra + copy extra
        cell = c >> 6
        ri = np.where(cell < 2, cell, cell - 2)
        ins_code = ((0x29850 >> (2 * ri)) & 3) * 8 + ((c >> 3) & 7)
        cp_code = ((0x26244 >> (2 * ri)) & 3) * 8 + (c & 7)
        cmd_bits = (cmd_d[np.clip(c, 0, 703)] + INS_NB[np.clip(ins_code, 0, 23)]
                    + CP_NB[np.clip(cp_code, 0, 23)])
        b = np.where(k == DE.K_CMD, cmd_bits, b)
        dist_bits = dist_d[np.clip(c, 0, 63)] + np.where(
            c >= 16, ((c - 16) >> 1) + 1, 0
        )
        b = np.where(k == DE.K_DIST, dist_bits, b)
        if nbt > 1:
            sw = sw_words[lanes][:, seg_of_col]
            b = b + np.where((r0 >> 26) & 1 == 1, (sw >> 27).astype(np.int64), 0)
        bits[lanes] = b
    return bits.sum(axis=1)


def probe(state, table_groups, nt, nbt, rec0_np, lgwin=22):
    n_chunks = state["n_chunks"]
    n_valid_np = state["n_valid_np"]
    rec0_sample = np.asarray(state["rec0_sample_dev"])
    group_of, group_modes = DE._cluster_lanes(rec0_sample, table_groups,
                                              n_chunks)
    n_used = len(group_modes)
    signed_mode = np.asarray([group_modes[g] == 3 for g in group_of], np.int32)
    pseg = state.get("block_seg", 2048)
    nseg = state["chunk_size"] // pseg if nbt > 1 else 1
    sw_words = first_blen = t0_np = seg_type_np = None
    group_splits = None
    if nbt > 1:
        seg_type_np = np.asarray(state["seg_type"])
        sw_words, first_blen, t0_np, group_splits = DE._plan_block_switches(
            seg_type_np, np.asarray(state["seg_litcnt"]), n_chunks,
            group_of, n_used, nbt)
    cols = np.arange(0, rec0_np.shape[1], state["hist_stride"])
    split_args = ()
    if nbt > 1:
        seg_cols_h = np.clip((cols - 1) // pseg, 0, nseg - 1)
        split_args = (jnp.asarray(seg_type_np[:, seg_cols_h]),)
    hist_fn = DE._jitted_group_hist(n_used, state["hist_stride"], nbt)
    flat = np.asarray(hist_fn(state["rec0"],
                              jnp.asarray(group_of.astype(np.int32)),
                              jnp.asarray(signed_mode), *split_args))
    tables = [
        DE._group_tables_from_hists(*DE._split_group_hist(flat, j, nbt), nt)
        for j in range(n_used)
    ]
    for j, t in enumerate(tables):
        t["mode"] = group_modes[j] if nt > 1 else 0

    # headers (exact)
    hdr_bits = np.zeros(n_chunks, np.int64)
    cache = {}
    for s in range(n_chunks):
        grp = int(group_of[s])
        key = (int(n_valid_np[s]), grp,
               int(first_blen[s]) if nbt > 1 else 0,
               int(t0_np[s]) if nbt > 1 else 0)
        if key not in cache:
            split = None
            if nbt > 1:
                split = dict(nbt=nbt, first_blen=int(first_blen[s]),
                             t0=int(t0_np[s]), **group_splits[grp])
            w = DE._header_bits(int(n_valid_np[s]), lgwin, tables[grp], split)
            cache[key] = len(w.take_bytes()) * 8 + w.nbits
        hdr_bits[s] = cache[key]

    seg_of_col = np.clip(
        (np.arange(rec0_np.shape[1]) - 1) // pseg, 0, nseg - 1
    ) if nbt > 1 else None
    bb = body_bits(rec0_np, group_of, signed_mode, tables, nbt,
                   seg_of_col, seg_type_np, sw_words)
    total_bits = hdr_bits + bb[:n_chunks]
    return int(((total_bits + 7) // 8).sum())


def main():
    parse_cfgs = [
        dict(chain_depth=4, nbt=1, seg=2048),
        dict(chain_depth=4, nbt=4, seg=512),
        dict(chain_depth=4, nbt=7, seg=512),
    ]
    table_cfgs = [
        (1, 8, 1), (2, 8, 1), (4, 8, 1), (8, 8, 1), (12, 8, 1),
        (2, 16, 1), (8, 16, 1),
        (2, 8, 4), (8, 8, 4), (8, 16, 4), (8, 8, 7), (8, 16, 7),
        (12, 16, 4),
    ]
    seen_states = {}
    for pc in parse_cfgs:
        key = (pc["chain_depth"], pc["nbt"], pc["seg"])
        t0 = time.time()
        state = DE._encode_start(
            data, CHUNK, 1, 256, None, pc["chain_depth"],
            lit_ctx=True, hist_stride=16,
            block_types=pc["nbt"], block_seg=pc["seg"],
        )
        rec0_np = np.asarray(state["rec0"])
        seen_states[key] = (state, rec0_np)
        print(f"stages {key}: {time.time()-t0:.0f}s", flush=True)
        for tg, nt, nbt in table_cfgs:
            if nbt != pc["nbt"]:
                continue
            t0 = time.time()
            size = probe(state, tg, nt, nbt, rec0_np)
            print(f"  tg={tg} nt={nt} nbt={nbt} seg={pc['seg']}: "
                  f"ratio={size/len(data):.4f} ({time.time()-t0:.0f}s)",
                  flush=True)


if __name__ == "__main__":
    main()
