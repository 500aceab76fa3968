"""Multi-device scaling: data-parallel batch decode and encode over the
devices of one host, metablock-sharded encode, dictionary broadcast."""

from .mesh import decode_batches_multichip, encode_batches_multichip, get_mesh
from .shard import parallel_encode, shard_file

__all__ = ["get_mesh", "decode_batches_multichip", "encode_batches_multichip",
           "parallel_encode", "shard_file"]
