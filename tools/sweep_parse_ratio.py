"""Parse-quality knob sweep for the device encoder (exact sizes).

Round-4's decomposition (tools/ratio_decompose.py) proved the device-vs-
host-q5 ratio gap is PARSE quality, not table sharing.  This sweeps the
parse-side knobs — hash2 (second 7-byte-hash candidate pass), lazy
thresholds, weak-match gate, chain depth — at a fixed table config and
reports exact stream sizes via the ratio_probe machinery.

Usage: python tools/sweep_parse_ratio.py [n_chunks] [chunk_kb]
(runs on the CPU unless --device is given)
"""

import importlib.util
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np  # noqa: E402

import jax  # noqa: E402

if "--device" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import brotli_tpu.ops.device_encode as DE  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "ratio_probe", Path(__file__).resolve().parent / "ratio_probe.py"
)
rp = importlib.util.module_from_spec(spec)

N_CHUNKS = int(sys.argv[1]) if len(sys.argv) > 1 else 64
CHUNK = (int(sys.argv[2]) if len(sys.argv) > 2 else 32) * 1024



def main() -> None:
    # load ratio_probe with our data size (it reads sys.argv itself)
    sys.argv = ["ratio_probe.py", str(N_CHUNKS), str(CHUNK // 1024)]
    spec.loader.exec_module(rp)
    data = rp.data

    # fixed table config = the bench's (tg=2, nt=8) + block splitting
    TG, NT, NBT, SEG = 8, 8, 4, 512

    parse_cfgs = [
        dict(chain_depth=4),
        dict(chain_depth=4, hash2=True),
        dict(chain_depth=4, lazy=(70, 135)),
        dict(chain_depth=4, lazy=(135, 200)),
        dict(chain_depth=4, min_gate=7),
        dict(chain_depth=4, min_gate=11),
        dict(chain_depth=4, hash2=True, lazy=(70, 135)),
        dict(chain_depth=6, hash2=True),
        dict(chain_depth=8),
    ]
    for pc in parse_cfgs:
        t0 = time.time()
        state = DE._encode_start(
            data, CHUNK, 1, 256, None, pc.get("chain_depth", 4),
            lit_ctx=True, hist_stride=16,
            block_types=NBT, block_seg=SEG,
            hash2=pc.get("hash2", False),
            lazy=pc.get("lazy", (105, 175)),
            min_gate=pc.get("min_gate", 9),
        )
        rec0_np = np.asarray(state["rec0"])
        size = rp.probe(state, TG, NT, NBT, rec0_np)
        print(
            f"{pc}: ratio={size / len(data):.4f} "
            f"({time.time() - t0:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
