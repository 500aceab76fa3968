"""Determinism across shard counts + numeric-safety harness (SURVEY §5).

The reference has no race detection (single-threaded); the analog here is
proving that results are IDENTICAL regardless of how work is sharded
(device counts, repeated runs), plus a debug harness that decodes under
jax_debug_nans (the decode is integer-only; the flag must be a no-op).
"""

import jax

from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu.ops.batch_decode import decode_batch
from brotli_tpu.ops.device_encode import encode_device_batch
from brotli_tpu.parallel.mesh import decode_batches_multichip, get_mesh

from conftest import TEXT

ALICE = TEXT


def test_decode_identical_across_group_sizes():
    data = ALICE[:8192]
    streams = encode_sharded(data, chunk_size=1024)
    a, b = ([o for r in decode_batches_multichip(streams, get_mesh(n),
                                                 interpret=True)
             for o in r.values()] for n in (2, 4))
    c = decode_batch(streams, interpret=True).values()
    assert a == b == c
    assert b"".join(a) == data


def test_device_encode_deterministic_across_runs():
    data = ALICE[:4096]
    a = encode_device_batch(data, chunk_size=1024)
    b = encode_device_batch(data, chunk_size=1024)
    assert a == b


def test_decode_under_debug_nans():
    """Integer-only decode must be clean under jax_debug_nans."""
    data = ALICE[:2048]
    streams = encode_sharded(data, chunk_size=512)
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        got = decode_batch(streams, interpret=True).values()
    finally:
        jax.config.update("jax_debug_nans", prev)
    assert b"".join(got) == data
