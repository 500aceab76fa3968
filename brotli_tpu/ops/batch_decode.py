"""Batched full-format Brotli decode on the GPU: one thread per stream.

`decode_batch` decodes a list of independent Brotli streams in one custom
call (native/batch_decode.cu, which runs the shared decoder core
native/brotli_core.h).  Every lane parses its own metablock headers, builds
its Huffman tables in device memory and decodes into its own region of one
flat output buffer, which also serves as its LZ history.  The full format
is covered: context maps, block switching in all three categories, tree
groups, the static dictionary with all 121 transforms, custom and compound
dictionaries, uncompressed and metadata blocks, multi-metablock streams and
large windows.  Limits are the format's own (256 block types and trees).

Layout of one launch (lanes sorted longest-first so a warp holds streams of
similar length):
  in      u8   concatenated compressed streams, `in_off` (n+1) i32 offsets
  out     u8   flat output, lane i owns [out_off[i], out_off[i+1])
  arena   i32  per-lane table scratch, lane i owns [arena_off[i], ...+1])
  status  i32  (n, 3): code, decoded length, size needed
Lane counts and buffer sizes are rounded up to a few buckets so compiles
stay bounded; padding lanes are empty and fail at once without touching
memory.

Output capacity per lane is the stream's decoded size when its header
gives it (a single ISLAST metablock), and otherwise an estimate.  A lane
whose output or table arena is too small reports the size it needs
(ERR_OUT_CAP / ERR_ARENA_CAP) and is relaunched on the device with that
size: `relaunched_lanes` counts them.  Lanes are split over as many
launches as keep each launch's input, output and arena within
LAUNCH_BYTES.  A lane that needs more than `max_output_size` is rejected
with the host decoder's error (-28) without being decoded; a lane that
needs more than LAUNCH_BYTES on its own is flagged.  A lane the device
flags is given to the host decoder for its verdict: if the host also
rejects the stream, the lane is an `error_lanes` entry carrying the host's
BrotliError; if the host decodes it, the lane is a `fallback_lanes` entry
and a warning is logged.  Nothing falls back silently.

`interpret=True` runs the same custom call through its CPU build (g++), which
decodes the lanes in a loop with the identical per-lane code; that is how the
CPU tests reach this module.  With `interpret=False` a non-GPU backend
raises.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from dataclasses import dataclass, field

import numpy as np

from ..decode import decoded_size
from ..decode.bitreader import BrotliError
from ..native import (
    ARENA_DEFAULT, ERR_ARENA_CAP, ERR_OUT_CAP, build_ffi_lib, compound_bytes,
    core_tables,
)

_log = logging.getLogger(__name__)

TARGET = "brotli_decode_batch"
MAX_LAUNCH_BYTES = (1 << 31) - 1   # int32 offsets
# Most input, output or arena bytes one launch is given (and so one lane):
# bucketing a total of at most 2^30 keeps every buffer under 2 GiB.
LAUNCH_BYTES = 1 << 30
MIN_LANES = 32


@dataclass
class BatchDecodeResult:
    """Per-stream results and the lane counts of the run."""

    outputs: list            # bytes, or the host's BrotliError, per stream
    error_lanes: int = 0     # device-flagged; the host rejects them too
    fallback_lanes: int = 0  # device-flagged; the host decoded them
    relaunched_lanes: int = 0
    launches: int = 0
    output_device: str = ""  # where the last launch's output buffer lived
    device_codes: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def values(self) -> list[bytes]:
        """The decoded streams; raises the first stream's BrotliError."""
        for o in self.outputs:
            if isinstance(o, BrotliError):
                raise o
        return self.outputs


def bucket(x: int, minimum: int = 1) -> int:
    """Smallest 2^k or 3*2^(k-1) >= max(x, minimum)."""
    x = max(int(x), minimum, 1)
    p = 1 << (x - 1).bit_length()
    return p * 3 // 4 if p * 3 // 4 >= x and p >= 4 else p


def _platform(interpret: bool) -> str:
    import jax

    if interpret:
        return "cpu"
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "decode_batch needs a GPU backend (found "
            f"{jax.default_backend()!r}); pass interpret=True to run the "
            "CPU build of the same kernel"
        )
    return "cuda"


@functools.lru_cache(maxsize=2)
def _register(platform: str) -> None:
    import jax

    lib = ctypes.cdll.LoadLibrary(str(build_ffi_lib(platform)))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.BrotliDecodeBatch),
        platform="CUDA" if platform == "cuda" else "cpu",
    )


@functools.lru_cache(maxsize=32)
def _decode_fn(n_lanes: int, n_out: int, n_arena: int, cd_len: int,
               large_window: bool):
    import jax
    import jax.numpy as jnp

    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n_out,), jnp.uint8),
         jax.ShapeDtypeStruct((n_lanes, 3), jnp.int32),
         jax.ShapeDtypeStruct((n_arena,), jnp.int32)),
        has_side_effect=True,
    )

    def run(inp, in_off, out_off, arena_off, tables, dct, tfs, cd):
        out, status, _ = call(inp, in_off, out_off, arena_off, tables, dct,
                              tfs, cd, cd_len=np.int64(cd_len),
                              large_window=np.int64(large_window))
        return out, status

    return jax.jit(run)


def _default_device(platform: str):
    import jax

    return jax.devices("cpu")[0] if platform == "cpu" else jax.devices()[0]


@functools.lru_cache(maxsize=16)
def _tables_on(device):
    import jax

    return tuple(jax.device_put(x, device) for x in core_tables())


@dataclass
class Staged:
    """One launch's device arguments and the host view of its layout."""

    fn: object
    args: tuple
    lanes: np.ndarray      # stream index of each launch lane (sorted order)
    out_off: np.ndarray


def stage(streams, lanes, caps, arena_caps, cd: bytes, large_window: bool,
          device) -> Staged:
    """Pack `lanes` (longest stream first) into one launch's buffers."""
    import jax

    lanes = np.asarray(sorted(lanes, key=lambda i: -len(streams[i])), np.int64)
    n = len(lanes)
    n_pad = bucket(n, MIN_LANES)
    in_len = np.zeros(n_pad, np.int64)
    out_len = np.zeros(n_pad, np.int64)
    ar_len = np.zeros(n_pad, np.int64)
    in_len[:n] = [len(streams[i]) for i in lanes]
    out_len[:n] = caps[lanes]
    ar_len[:n] = arena_caps[lanes]
    offs = [np.concatenate([[0], np.cumsum(x)]) for x in (in_len, out_len, ar_len)]
    n_in = bucket(offs[0][-1] + 8, 1 << 12)
    n_out = bucket(offs[1][-1], 1 << 12)
    n_arena = bucket(offs[2][-1], 1 << 12)
    if max(n_in, n_out, 4 * n_arena) > MAX_LAUNCH_BYTES:
        raise ValueError("launch buffers over 2 GiB")
    inp = np.zeros(n_in, np.uint8)
    inp[: offs[0][-1]] = np.frombuffer(
        b"".join(streams[i] for i in lanes), np.uint8)
    tables, dct, tfs = _tables_on(device)
    cd_arr = np.frombuffer(cd + b"\x00", np.uint8)
    args = (
        jax.device_put(inp, device),
        *(jax.device_put(o.astype(np.int32), device) for o in offs),
        tables, dct, tfs, jax.device_put(cd_arr, device),
    )
    fn = _decode_fn(n_pad, n_out, n_arena, len(cd), bool(large_window))
    return Staged(fn, args, lanes, offs[1])


class DecodeJob:
    """One batch on one device: `launch` dispatches the first launches
    without waiting, `finish` collects them, relaunches lanes that asked for
    larger buffers, and asks the host decoder about flagged lanes."""

    def __init__(self, streams, *, custom_dictionary=None,
                 max_output_size: int | None = None,
                 large_window: bool = False, interpret: bool = False,
                 device=None):
        from ..utils.compile_cache import init_compile_cache

        platform = _platform(interpret)
        init_compile_cache()
        _register(platform)
        self.device = device or _default_device(platform)
        self.streams = [bytes(s) for s in streams]
        self.custom_dictionary = custom_dictionary
        self.cd = compound_bytes(custom_dictionary)
        self.large_window = large_window
        self.max_output_size = max_output_size
        self.lane_limit = LAUNCH_BYTES if max_output_size is None else \
            min(LAUNCH_BYTES, max(max_output_size, 0))
        n = len(self.streams)
        self.caps = np.zeros(n, np.int64)
        self.arena_caps = np.full(n, ARENA_DEFAULT, np.int64)
        self.codes = np.zeros(n, np.int64)
        self.res = BatchDecodeResult([None] * n)
        self.pending = []
        for i, s in enumerate(self.streams):
            if not s:
                self.codes[i] = -16   # empty input: the host's verdict below
                continue
            cap = decoded_size(s[:16])   # the header fits in 16 bytes
            if cap < 0:
                cap = 8 * len(s) + 65536
            elif not self._fits(i, cap):
                continue
            self.caps[i] = min(cap, self.lane_limit)

    def _fits(self, i: int, need: int) -> bool:
        """Whether lane i may have `need` output bytes.  If not, it is
        rejected as the host decoder rejects output over max_output_size,
        or, when too large for one launch, flagged for the host's verdict."""
        if self.max_output_size is not None and need > self.max_output_size:
            self.res.outputs[i] = BrotliError(
                -28, "output larger than maxOutputSize")
            self.res.error_lanes += 1
        elif need <= LAUNCH_BYTES:
            return True
        self.codes[i] = ERR_OUT_CAP
        return False

    def stage_lanes(self, lanes) -> Staged:
        """One launch's buffers for `lanes` at their current capacities."""
        return stage(self.streams, lanes, self.caps, self.arena_caps, self.cd,
                     self.large_window, self.device)

    def _dispatch(self, lanes) -> None:
        """Launch `lanes`, split so that no launch's input, output or arena
        passes LAUNCH_BYTES."""
        group, used = [], (0, 0, 0)
        for i in lanes:
            size = (len(self.streams[i]) + 8, int(self.caps[i]),
                    4 * int(self.arena_caps[i]))
            used = tuple(u + x for u, x in zip(used, size))
            if group and max(used) > LAUNCH_BYTES:
                self._launch_one(group)
                group, used = [], size
            group.append(i)
        if group:
            self._launch_one(group)

    def _launch_one(self, lanes) -> None:
        st = self.stage_lanes(lanes)
        self.pending.append((st, st.fn(*st.args)))
        self.res.launches += 1

    def launch(self) -> "DecodeJob":
        self._dispatch(np.flatnonzero(self.codes == 0))
        return self

    def finish(self) -> BatchDecodeResult:
        res, outputs = self.res, self.res.outputs
        while self.pending:
            launched, self.pending = self.pending, []
            retry = []
            for st, (out_dev, status_dev) in launched:
                res.output_device = str(next(iter(out_dev.devices())))
                status = np.asarray(status_dev)
                out = np.asarray(out_dev)
                for j, i in enumerate(st.lanes):
                    code, length, need = (int(x) for x in status[j])
                    if code == 0:
                        o = int(st.out_off[j])
                        outputs[i] = out[o: o + length].tobytes()
                    elif code == ERR_OUT_CAP:
                        if self._fits(i, need):
                            self.caps[i] = min(max(need, 2 * self.caps[i]),
                                               self.lane_limit)
                            retry.append(i)
                    elif code == ERR_ARENA_CAP:
                        self.arena_caps[i] = need
                        retry.append(i)
                    else:
                        self.codes[i] = code
            res.relaunched_lanes += len(retry)
            if retry:
                self._dispatch(retry)
        from ..decode import decode as host_decode

        for i in np.flatnonzero(self.codes):
            if outputs[i] is not None:
                continue
            try:
                outputs[i] = host_decode(
                    self.streams[i], custom_dictionary=self.custom_dictionary,
                    max_output_size=self.max_output_size,
                    large_window=self.large_window)
                res.fallback_lanes += 1
                _log.warning("device flagged stream %d (code %d) but the "
                             "host decoded it", i, self.codes[i])
            except BrotliError as e:
                outputs[i] = e
                res.error_lanes += 1
        res.device_codes = self.codes
        return res


def decode_batch(streams, *, custom_dictionary=None,
                 max_output_size: int | None = None,
                 large_window: bool = False, interpret: bool = False,
                 device=None) -> BatchDecodeResult:
    """Decode independent Brotli streams in one device batch.

    `max_output_size` bounds each stream's output as in the host `decode`.
    `device` defaults to the first GPU.  See the module docstring for the
    result's lane counts."""
    return DecodeJob(streams, custom_dictionary=custom_dictionary,
                     max_output_size=max_output_size,
                     large_window=large_window, interpret=interpret,
                     device=device).launch().finish()
