"""Native (C++) table builder parity: bit-identical to the python golden
implementations (entropy.create_huffman_depths count-limit retry +
tie-breaks; cluster.ts greedy merge incl. float accumulation order), so
swapping it into the device encoder's table step cannot change streams."""

import numpy as np

from conftest import TEXT

from brotli_tpu.encode.entropy import build_huffman_code
from brotli_tpu.encode.metablock_full import _cluster_and_build_context_map
from brotli_tpu.native import (
    build_huffman_code_native,
    cluster_context_map_native,
)


def test_huffman_code_parity_fuzz():
    rng = np.random.default_rng(7)
    for trial in range(300):
        n = int(rng.choice([64, 256, 704]))
        h = rng.integers(0, 1 << int(rng.integers(1, 20)), size=n)
        h[rng.random(n) < rng.random()] = 0
        if trial % 5 == 0:   # skewed: forces the count-limit retry
            h[: n // 8] = rng.integers(1 << 20, 1 << 24, size=n // 8)
        a = build_huffman_code(h.tolist(), n)
        b = build_huffman_code_native(h.tolist(), n)
        assert a == (b[0], b[1], b[2], b[3]) or \
            (a[0], a[1], a[2], a[3]) == (b[0], b[1], b[2], b[3]), trial


def test_cluster_context_map_parity_real_text():
    from brotli_tpu.decode.engine import _CONTEXT_LUT

    lut = np.asarray(_CONTEXT_LUT, np.int64)
    data = np.frombuffer(
        TEXT,
        np.uint8,
    ).astype(np.int64)
    p1 = np.concatenate([[0], data[:-1]])
    p2 = np.concatenate([[0, 0], data[:-2]])
    ctx = lut[512 + p1] | lut[768 + p2]   # UTF8 context mode
    hists = np.zeros((64, 256), np.int64)
    np.add.at(hists, (ctx, data), 1)
    a = _cluster_and_build_context_map(hists.tolist(), 64, 256)
    b = cluster_context_map_native(hists, 64, 256)
    assert a[0] == b[0] and list(a[1]) == list(b[1])


def test_cluster_context_map_parity_fuzz():
    rng = np.random.default_rng(3)
    for trial in range(6):
        rows = int(rng.choice([8, 64, 128]))
        hists = np.zeros((rows, 256), np.int64)
        for r in range(rows):
            syms = rng.choice(256, size=int(rng.integers(3, 40)),
                              replace=False)
            hists[r, syms] = rng.integers(1, 5000, size=syms.shape[0])
        # duplicate some rows: exercises zero-cost merges and tie-breaks
        if rows >= 16:
            hists[rows // 2:] = hists[: rows - rows // 2]
        a = _cluster_and_build_context_map(hists.tolist(), rows, 256)
        b = cluster_context_map_native(hists, rows, 256)
        assert a[0] == b[0] and list(a[1]) == list(b[1]), trial
