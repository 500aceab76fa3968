"""Data parallelism over the devices of one host.

The batch codec is data-parallel over streams (SURVEY.md section 2.3):
each device decodes or encodes its own contiguous share of the batch, with
its own copy of the format tables and static dictionary, and results come
back in input order.  No collective is needed.  The mesh is a 1-D
`streams` axis over `jax.devices()`.
"""

from __future__ import annotations

import numpy as np


def get_mesh(n_devices: int | None = None, axis_name: str = "streams"):
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def broadcast_dictionary(mesh=None):
    """The static dictionary replicated over the mesh: one copy resident on
    each device (the decode kernel reads it from device memory)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..decode.dictionary import get_dictionary

    if mesh is None:
        mesh = get_mesh()
    data = np.frombuffer(get_dictionary(), dtype=np.uint8)
    return jax.device_put(jnp.asarray(data), NamedSharding(mesh, P()))


def decode_batches_multichip(streams: list[bytes], mesh=None, *,
                             custom_dictionary=None, interpret: bool = False):
    """Decode a batch across the mesh devices, one contiguous share each.

    Every device's first launch is dispatched before any result is read, so
    the devices decode concurrently.  Returns one `BatchDecodeResult` per
    device, in mesh order, so the shares' outputs concatenate to the input
    order; each carries its lane counts and the device that held its
    output."""
    from ..ops.batch_decode import DecodeJob

    if mesh is None:
        mesh = get_mesh()
    devices = list(mesh.devices.reshape(-1))
    cuts = np.linspace(0, len(streams), len(devices) + 1).astype(int)
    jobs = [
        DecodeJob(streams[a:b], custom_dictionary=custom_dictionary,
                  interpret=interpret, device=dev).launch()
        for dev, a, b in zip(devices, cuts[:-1], cuts[1:])
    ]
    return [job.finish() for job in jobs]


def encode_batches_multichip(
    data: bytes,
    mesh=None,
    *,
    chunk_size: int = 32768,
    hash_stride: int = 1,
    max_distance: int | None = None,
    chain_depth: int = 2,
    table_groups: int = 1,
    lit_ctx_trees: int = 1,
    hist_stride: int | None = None,
) -> list[bytes]:
    """Encode large inputs across mesh devices, one 1024-chunk batch each.

    Data parallel like decode_batches_multichip, with overlapped dispatch:
    the encode pipeline (ops/device_encode.py) is driven in three phases —
    (1) match/parse/record stages dispatched to every device before any
    result is fetched, (2) host table build + bit-pack dispatch per
    device, (3) fetch + stream assembly — so all devices compute their
    heavy stages concurrently.

    The quality knobs (chain_depth, table_groups, lit_ctx_trees,
    hist_stride, max_distance) are the single-device encode_device_batch
    knobs, passed through verbatim so both produce the same bytes.
    """
    import jax

    from ..ops.device_encode import (
        B_LANES,
        _HIST_STRIDE_DEFAULT,
        _encode_finish,
        _encode_mid,
        _encode_start,
    )
    from ..encode.api import _encode_empty

    if mesh is None:
        mesh = get_mesh()
    if len(data) == 0:
        return [_encode_empty()]
    devices = list(mesh.devices.reshape(-1))
    batch_bytes = B_LANES * chunk_size
    pieces = [
        bytes(data[off : off + batch_bytes])
        for off in range(0, len(data), batch_bytes)
    ]
    if hist_stride is None:
        hist_stride = _HIST_STRIDE_DEFAULT

    # phase 1: dispatch the XLA stages on every device (async)
    states = []
    for bi, piece in enumerate(pieces):
        dev = devices[bi % len(devices)]
        with jax.default_device(dev):
            states.append((dev, _encode_start(
                piece, chunk_size, hash_stride, 256,
                max_distance, chain_depth,
                lit_ctx=lit_ctx_trees > 1, hist_stride=hist_stride,
            )))
    # phase 2: host tables + pack dispatch (fetches each device's sample,
    # which only waits on that device; the packs again run concurrently)
    for dev, state in states:
        with jax.default_device(dev):
            _encode_mid(state, 22, table_groups, lit_ctx_trees)
    # phase 3: ordered fetch + assembly
    out: list[bytes] = []
    for dev, state in states:
        out.extend(_encode_finish(state))
    return out
