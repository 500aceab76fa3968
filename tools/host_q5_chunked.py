"""Host q5 ratio on the SAME independently-chunked corpus the device
encoder is measured on (the seeded bulk corpus) — the apples-to-apples
quality target.

The device encoder compresses B independent chunk streams (no cross-chunk
history); BASELINE.md's host-q5 numbers encode whole files, so they carry
a window advantage the device path structurally lacks.  This prints both
so the ratio gap decomposes into (chunking) + (parse/table quality).

Usage: python tools/host_q5_chunked.py [n_chunks] [chunk_kb] [quality]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from brotli_tpu import corpus, encode  # noqa: E402

N_CHUNKS = int(sys.argv[1]) if len(sys.argv) > 1 else 128
CHUNK = (int(sys.argv[2]) if len(sys.argv) > 2 else 32) * 1024
Q = int(sys.argv[3]) if len(sys.argv) > 3 else 5

data = corpus.bulk(N_CHUNKS * CHUNK, 0)   # the input tools/ratio_probe.py uses

chunked = 0
for i in range(0, len(data), CHUNK):
    chunked += len(encode(data[i : i + CHUNK], quality=Q))
    if (i // CHUNK) % 16 == 15:
        print(f"  {i // CHUNK + 1}/{N_CHUNKS}", flush=True)
whole = len(encode(data, quality=Q))
print(f"host q{Q} chunked ({CHUNK//1024} KB x {N_CHUNKS}): "
      f"{chunked/len(data):.4f}")
print(f"host q{Q} whole ({len(data)//1024} KB): {whole/len(data):.4f}")
