"""Parallel layer: data-parallel decode and encode over an 8-device
virtual CPU mesh, and metablock-sharded encode."""

import pytest

from brotli_tpu import decode
from brotli_tpu.encode import encode
from brotli_tpu.encode.api import encode_fragment
from brotli_tpu.parallel import decode_batches_multichip, get_mesh, parallel_encode
from brotli_tpu.parallel.mesh import broadcast_dictionary

from conftest import TEXT

ALICE = TEXT


def _decoded(streams, mesh):
    """Outputs of the mesh decode in input order."""
    results = decode_batches_multichip(streams, mesh, interpret=True)
    return [o for r in results for o in r.values()]


def test_mesh_has_8_devices():
    assert get_mesh().devices.size == 8


@pytest.mark.parametrize("quality", [1, 5, 11])
def test_parallel_encode_roundtrip(quality):
    enc = parallel_encode(ALICE, quality=quality, shard_size=20000, num_workers=2)
    assert decode(enc) == ALICE


def test_parallel_encode_single_shard_matches_oneshot():
    enc = parallel_encode(ALICE[:30000], quality=5, shard_size=1 << 20)
    assert enc == encode(ALICE[:30000], quality=5, size_hint=30000)


def test_fragment_concat_various_counts():
    data = ALICE[:60000]
    for n in (2, 3, 7):
        size = -(-len(data) // n)
        frags = []
        for i in range(n):
            off = i * size
            shard = data[off : off + size]
            prelude = (data[off - 1], data[off - 2]) if off >= 2 else (0, 0)
            frags.append(
                encode_fragment(
                    shard, quality=5, first=(i == 0), last=(i == n - 1),
                    context_prelude=prelude,
                )
            )
        assert decode(b"".join(frags)) == data


def test_sharded_decode_over_mesh():
    mesh = get_mesh()
    datas = [ALICE[i * 1500 : (i + 1) * 1500] for i in range(16)]
    streams = [encode(d, quality=1) for d in datas]
    results = decode_batches_multichip(streams, mesh, interpret=True)
    assert [o for r in results for o in r.values()] == datas
    assert len({r.output_device for r in results}) == 8
    assert sum(r.fallback_lanes + r.error_lanes for r in results) == 0


def test_dictionary_broadcast_replicated():
    mesh = get_mesh()
    d = broadcast_dictionary(mesh)
    assert d.shape == (122784,)
    assert bytes(d[:4].tolist()) == b"time"


def test_multichip_decode_shares_in_order():
    from brotli_tpu.encode.sharded import encode_sharded

    data = ALICE[:16384]
    streams = encode_sharded(data, chunk_size=1024)
    got = _decoded(streams, get_mesh(4))
    assert b"".join(got) == data


def test_multichip_mixed_tables_and_sizes():
    import brotli_tpu

    # different tables and sizes per stream; fewer streams than devices
    a = brotli_tpu.encode(ALICE[:600], quality=1)
    b = brotli_tpu.encode(bytes(900), quality=9)
    got = _decoded([a, b], get_mesh(4))
    assert got == [ALICE[:600], bytes(900)]


def test_multichip_decode_never_calls_host_decoder(monkeypatch):
    """Valid streams decode on the devices: the host decoder is a tripwire."""
    import sys

    from brotli_tpu.encode.sharded import encode_sharded

    dec = sys.modules["brotli_tpu.decode"]

    def _boom(*a, **k):  # pragma: no cover - tripwire
        raise AssertionError("host decoder used for a valid stream")

    monkeypatch.setattr(dec, "decode", _boom)
    data = ALICE[:16384]
    streams = encode_sharded(data, chunk_size=1024)
    got = _decoded(streams, get_mesh(4))
    assert b"".join(got) == data


def test_multichip_encode_batches():
    from brotli_tpu.parallel.mesh import encode_batches_multichip

    # > 1 MB so the input splits into two per-device batches (1024 x 1 KB)
    data = (ALICE * 12)[: 1600 * 1024]
    streams = encode_batches_multichip(data, get_mesh(2), chunk_size=1024)
    assert len(streams) == 1600
    assert b"".join(decode(s) for s in streams) == data


def test_multichip_encode_matches_single_chip_config():
    """Encode knobs (chain_depth, context trees, table groups,
    hist_stride) pass through the multichip encode verbatim: per-batch
    output bytes equal the single-device encode of the same piece."""
    from brotli_tpu.ops.device_encode import encode_device_batch
    from brotli_tpu.parallel.mesh import encode_batches_multichip

    data = (ALICE * 12)[: 1300 * 1024]  # 2 pieces at 1024 lanes x 1 KB
    cfg = dict(chunk_size=1024, chain_depth=3, table_groups=2,
               lit_ctx_trees=2, hist_stride=16)
    multi = encode_batches_multichip(data, get_mesh(2), **cfg)
    single = []
    for off in range(0, len(data), 1024 * 1024):
        single.extend(encode_device_batch(data[off : off + 1024 * 1024], **cfg))
    assert len(multi) == len(single)
    assert multi == single


def test_multichip_static_dictionary_streams():
    """Streams with static-dictionary references decode over the mesh,
    each device reading its own copy of the dictionary."""
    words = b"the quick brown fox jumps over the lazy dog "
    streams = [encode(words * 3, quality=11),
               encode(b"information development government " * 2, quality=5)]
    exp = [decode(s) for s in streams]
    got = _decoded(streams, get_mesh(4))
    assert got == exp
