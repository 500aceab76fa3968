"""Generate tests/golden_encode.json: locked host-encoder outputs.

Exact-output locks: the size and sha256 of the encoder's bytes for a
(source, quality, mode) matrix over the seeded corpus, so any silent
decision or ratio change in encode/ fails the tests.  The sources are
stored in the file as corpus specs (`brotli_tpu.corpus.source`).

`q11_size_gates` is carried over unchanged: the q11 sizes of this encoder
against Google's encoder on Google's test corpus, recorded while that
corpus was available; the corpus is not in the repository.

Run:  python tools/gen_golden_encode.py   (rewrites tests/golden_encode.json)
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OUT = Path(__file__).resolve().parent.parent / "tests" / "golden_encode.json"

# key -> corpus spec; (key, qualities, mode)
SOURCES = {
    "text": ["text", 152089, 0],
    "text2": ["text", 125179, 1],
    "text_30k": ["text", 30000, 0],
    "html_20k": ["html", 20000, 3],
    "quickfox": ["literal", "The quick brown fox jumps over the lazy dog"],
    "x": ["literal", "X"],
    "noise_10k": ["noise", 10000, 0],
    "font_20k": ["font", 65536, 2, 20000],
    "text_8k": ["text", 8000, 4],
}
MATRIX = [
    ("text", [0, 1, 2, 5], 0),
    ("text2", [1, 5], 0),
    ("text_30k", [2, 4, 7, 9, 10, 11], 0),
    ("html_20k", [5, 9], 0),
    ("quickfox", [1, 5, 11], 0),
    ("x", [1, 5, 11], 0),
    ("noise_10k", [1, 5], 0),
    ("font_20k", [5], 2),        # FONT mode
    ("text_8k", [5, 11], 1),     # TEXT mode
]


def main() -> None:
    from brotli_tpu import corpus
    from brotli_tpu.decode import decode
    from brotli_tpu.encode import encode

    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    golden: dict = {"sources": SOURCES, "outputs": {},
                    "q11_size_gates": old.get("q11_size_gates", {})}
    for key, qualities, mode in MATRIX:
        data = corpus.source(SOURCES[key])
        for q in qualities:
            out = encode(data, quality=q, mode=mode)
            assert decode(out) == data, (key, q)
            golden["outputs"][f"{key}:q{q}:m{mode}"] = {
                "size": len(out),
                "sha256": hashlib.sha256(out).hexdigest(),
            }
            print(f"{key} q{q} m{mode}: {len(out)}", flush=True)
    OUT.write_text(json.dumps(golden, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
