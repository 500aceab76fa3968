"""Native components, built from the committed sources on first use.

* `libbrotli_tpu_native.so` (g++, loaded with ctypes): the host decoder,
  which runs the shared decoder core (brotli_core.h), and the encoder's
  table builder and context clustering.
* the batched decode custom call (batch_decode.cu, see ops/batch_decode.py):
  built with nvcc for the GPU and with g++ for the CPU, from one source.

Outputs go to `native/build/` (listed in .gitignore), stamped with a hash of
their sources and command so a stale or foreign build is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR / "build"
_LIB: ctypes.CDLL | None = None


def _build(name: str, srcs: list[Path], deps: list[Path], cmd: list[str]) -> Path:
    """Compile `srcs` into build/`name` unless a matching stamp exists.

    The stamp hashes sources, headers and the command: mtimes are unreliable
    in fresh checkouts, and a binary built with -march=native on another
    host can SIGILL.  The output is written under a unique name and renamed
    into place, so concurrent builders never load a half-written file.
    """
    _BUILD.mkdir(exist_ok=True)
    out = _BUILD / name
    stamp = _BUILD / (name + ".hash")
    h = hashlib.sha256(" ".join(cmd).encode())
    for s in (*srcs, *deps):
        h.update(s.read_bytes())
    digest = h.hexdigest()
    if out.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return out
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run([*cmd, "-o", tmp, *map(str, srcs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    stamp.write_text(digest)
    return out


def build_host_lib() -> Path:
    return _build(
        "libbrotli_tpu_native.so",
        [_DIR / "decoder.cpp", _DIR / "table_builder.cpp"],
        [_DIR / "brotli_core.h"],
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-lpthread"],
    )


def _ffi_include() -> str:
    import jax.ffi

    return str(jax.ffi.include_dir())


def build_ffi_lib(platform: str) -> Path:
    """The batched decode custom call for `platform` ("cpu" or "cuda")."""
    src = [_DIR / "batch_decode.cu"]
    deps = [_DIR / "brotli_core.h"]
    inc = ["-I", _ffi_include(), "-I", str(_DIR)]
    if platform == "cpu":
        return _build("libbrotli_batch_cpu.so", src, deps,
                      ["g++", "-x", "c++", "-O3", "-std=c++17", "-shared",
                       "-fPIC", "-w", *inc])
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    return _build("libbrotli_batch_cuda.so", src, deps,
                  [nvcc, "-O3", "-std=c++17", "-shared",
                   "-gencode", "arch=compute_90a,code=sm_90a",
                   "-Xcompiler", "-fPIC", "-w", *inc])


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_host_lib()))
        dec = lib.brotli_core_decode
        dec.restype = ctypes.c_int
        dec.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4
            + [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        )
        bh = lib.native_build_huffman_code
        bh.restype = None
        bh.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        cc = lib.native_cluster_context_map
        cc.restype = ctypes.c_int
        cc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def build_huffman_code_native(histogram, alphabet_size: int):
    """Bit-identical native analog of entropy.build_huffman_code (same
    count-limit retry + tie-breaking); returns (depths, bits, count, s4)
    as python lists for drop-in use."""
    import numpy as np

    h = np.ascontiguousarray(np.asarray(histogram, np.int64)[:alphabet_size])
    if h.shape[0] < alphabet_size:
        h = np.concatenate([h, np.zeros(alphabet_size - h.shape[0], np.int64)])
    nz = np.flatnonzero(h)
    count = int(nz.shape[0])
    s4 = [0, 0, 0, 0]
    for k in range(min(4, count)):
        s4[k] = int(nz[k])
    if count <= 1:
        return [0] * alphabet_size, [0] * alphabet_size, count, s4
    lib = get_lib()
    depths = np.zeros(alphabet_size, np.uint8)
    bits = np.zeros(alphabet_size, np.uint16)
    lib.native_build_huffman_code(
        h.ctypes.data, alphabet_size, depths.ctypes.data, bits.ctypes.data
    )
    return depths.astype(np.int64).tolist(), bits.astype(np.int64).tolist(), \
        count, s4


def cluster_context_map_native(hists, rows: int, syms: int):
    """Bit-identical native analog of
    metablock_full._cluster_and_build_context_map; returns
    (num_clusters, context_map list)."""
    import numpy as np

    if rows <= 1:
        return 1, [0] * max(1, rows)
    arr = np.ascontiguousarray(np.asarray(hists, np.int64).reshape(rows, syms))
    cmap = np.zeros(rows, np.int32)
    lib = get_lib()
    n = lib.native_cluster_context_map(
        arr.ctypes.data, rows, syms, 64, cmap.ctypes.data
    )
    return int(n), cmap.astype(np.int64).tolist()


# ---------------------------------------------------------------------------
# decoder core inputs (brotli_core.h) and the host decoder
# ---------------------------------------------------------------------------

# Default table arena for one lane (int32 words): the fixed region plus
# room for 16 literal, 8 command and 8 distance trees.  A metablock that
# needs more reports ERR_ARENA_CAP with its exact need.
ERR_OUT_CAP = -1000
ERR_ARENA_CAP = -1001
ARENA_FIXED = 10773
ARENA_DEFAULT = ARENA_FIXED + 16 * 631 + 8 * 1081 + 8 * 921

_CORE_TABLES = None


def core_tables():
    """(packed int32 tables, static dictionary u8, transform strings u8) in
    the layout brotli_core.h expects (single source of truth: constants.py)."""
    global _CORE_TABLES
    if _CORE_TABLES is None:
        import numpy as np

        from ..constants import (
            BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET, CMD_LUT,
            CODE_LENGTH_CODE_LENGTHS, CODE_LENGTH_CODE_ORDER,
            COPY_LENGTH_N_BITS, COPY_LENGTH_OFFSET,
            DICT_OFFSETS_BY_LENGTH, DICT_SIZE_BITS_BY_LENGTH,
            INSERT_LENGTH_N_BITS, INSERT_LENGTH_OFFSET,
        )
        from ..decode.dictionary import get_dictionary
        from ..decode.engine import _CONTEXT_LUT
        from ..decode.transforms import TRANSFORM_LIST

        storage = bytearray()
        spans = np.zeros((len(TRANSFORM_LIST), 4), dtype=np.int32)
        ops = np.zeros(len(TRANSFORM_LIST), dtype=np.int32)
        for i, (pre, op, suf) in enumerate(TRANSFORM_LIST):
            spans[i, 0] = len(storage); spans[i, 1] = len(pre)
            storage.extend(pre)
            spans[i, 2] = len(storage); spans[i, 3] = len(suf)
            storage.extend(suf)
            ops[i] = op
        parts = [
            INSERT_LENGTH_N_BITS, INSERT_LENGTH_OFFSET,
            COPY_LENGTH_N_BITS, COPY_LENGTH_OFFSET,
            BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET,
            np.asarray(CMD_LUT).reshape(-1), _CONTEXT_LUT,
            CODE_LENGTH_CODE_ORDER, CODE_LENGTH_CODE_LENGTHS,
            (DICT_OFFSETS_BY_LENGTH, 32), (DICT_SIZE_BITS_BY_LENGTH, 32),
            spans.reshape(-1), ops,
        ]

        def i32(part):
            x, n = part if isinstance(part, tuple) else (part, None)
            x = np.asarray(x, np.int32).reshape(-1)
            return x if n is None else np.pad(x, (0, n - x.size))

        packed = np.concatenate([i32(x) for x in parts])
        assert packed.size == 5705  # brotli_core.h P_TOTAL
        _CORE_TABLES = (
            np.ascontiguousarray(packed),
            np.frombuffer(get_dictionary(), dtype=np.uint8),
            np.frombuffer(bytes(storage) + b"\x00", dtype=np.uint8),
        )
    return _CORE_TABLES


def compound_bytes(custom_dictionary) -> bytes:
    """Custom/compound dictionary chunks as one buffer (at most 15 chunks)."""
    from ..decode.bitreader import BrotliError

    if custom_dictionary is None:
        return b""
    if isinstance(custom_dictionary, (bytes, bytearray, memoryview)):
        return bytes(custom_dictionary)
    chunks = [bytes(c) for c in custom_dictionary]
    if len(chunks) > 15:
        raise BrotliError(-27, "too many dictionary chunks")
    return b"".join(chunks)


def native_decode(data: bytes, custom_dictionary=None,
                  large_window: bool = False) -> bytes:
    """Decode one stream with the decoder core on the host; raises
    BrotliError on failure.  Output and arena grow on the core's request."""
    import numpy as np

    from ..decode.bitreader import BrotliError

    lib = get_lib()
    packed, dict_data, tf_storage = core_tables()
    cd = np.frombuffer(compound_bytes(custom_dictionary) + b"\x00", np.uint8)
    buf = np.frombuffer(bytes(data) + b"\x00", dtype=np.uint8)
    cap = max(len(data) * 6 + (1 << 20), 1 << 16)
    arena_cap = ARENA_DEFAULT
    p = ctypes.c_void_p
    while True:
        out = np.empty(cap, dtype=np.uint8)
        arena = np.empty(arena_cap, dtype=np.int32)
        size = ctypes.c_int64(0)
        rc = lib.brotli_core_decode(
            buf.ctypes.data_as(p), len(data), packed.ctypes.data_as(p),
            dict_data.ctypes.data_as(p), tf_storage.ctypes.data_as(p),
            cd.ctypes.data_as(p), len(cd) - 1, 1 if large_window else 0,
            out.ctypes.data_as(p), cap, arena.ctypes.data_as(p), arena_cap,
            ctypes.byref(size),
        )
        if rc == ERR_OUT_CAP:
            cap = max(cap * 2, int(size.value))
        elif rc == ERR_ARENA_CAP:
            arena_cap = int(size.value)
        elif rc != 0:
            raise BrotliError(rc)
        else:
            return out[: size.value].tobytes()
