"""brotli_tpu — a batched Brotli (RFC 7932) encoder/decoder in JAX.

Built from scratch with the full capability surface of the reference
TypeScript library (countertype/brotli-lib): one-shot and streaming encode
across qualities 0-11, full-format decode with static/custom dictionaries,
plus what the reference does not have — batched device execution on a GPU
(a CUDA batch decoder, an XLA encoder) and data parallelism over the
devices of one host.

Layout:
  constants.py  — RFC format tables, shared by both pipelines
  corpus.py     — seeded synthetic inputs for tests, bench and tools
  decode/       — decoder: python golden path + the native host decoder
  encode/       — encoder: quality-tiered pipelines
  native/       — C++/CUDA: the decoder core shared by host and GPU
  ops/          — device code: batch decode custom call, device encoder
  parallel/     — data parallelism over a device mesh, dictionary broadcast
  utils/        — profiling/bench helpers, compile cache
"""

from .decode import decode, decoded_size, BrotliError
from .encode import encode, Encoder, encode_fragment
from .encode.sharded import encode_sharded, encode_sharded_concat


def encode_sharded_device(data, **kw):
    """Device encoder: sort-based parallel encode of <=1024 chunks
    (ops/device_encode.py). Lazy import keeps JAX off the critical path."""
    from .ops.device_encode import encode_device_batch

    return encode_device_batch(data, **kw)

__version__ = "0.2.0"

__all__ = [
    "decode", "decoded_size", "BrotliError",
    "encode", "Encoder", "encode_fragment",
    "encode_sharded", "encode_sharded_concat", "encode_sharded_device",
    "__version__",
]
