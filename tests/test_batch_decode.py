"""Batch decode kernel (ops/batch_decode.py) through its CPU build.

The custom call runs the same per-lane decoder core on the CPU when
`interpret=True`, so these tests cover the kernel's arithmetic and the
wrapper's layout, padding buckets, relaunches and error accounting.  The
`gpu` tests run the CUDA build on a card.
"""

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu import BrotliError, corpus
from brotli_tpu.decode import decode as host_decode
from brotli_tpu.encode.api import _NO_MASK
from brotli_tpu.encode.bitwriter import BitWriter, encode_window_bits
from brotli_tpu.encode.command import make_command
from brotli_tpu.encode.metablock import store_metablock_trivial
from brotli_tpu.native import ARENA_FIXED, ERR_OUT_CAP
from brotli_tpu.ops import batch_decode
from brotli_tpu.ops.batch_decode import DecodeJob, bucket, decode_batch

from conftest import FONT, HTML, TEXT


def _num_types(stream: bytes):
    from brotli_tpu.decode.bitreader import BitReader
    from brotli_tpu.decode.engine import (
        _MetablockState, _decode_window_bits, _read_metablock_length)

    br = BitReader(stream)
    _decode_window_bits(br, large_window_enabled=False)
    islast = br.read(1)
    if islast:
        br.read(1)
    _read_metablock_length(br, bool(islast))
    st = _MetablockState(br, large_window=False)
    return st.num_types, len(st.lit_group), len(st.dist_group)


def _check(streams, expected, **kw):
    res = decode_batch(streams, interpret=True, **kw)
    assert res.values() == expected
    assert res.fallback_lanes == res.error_lanes == 0
    return res


def test_round1_subset_shared_tables():
    from brotli_tpu.encode.sharded import encode_sharded

    data = TEXT[:24576]
    streams = encode_sharded(data, chunk_size=2048)
    res = _check(streams,
                 [data[i: i + 2048] for i in range(0, len(data), 2048)])
    assert res.relaunched_lanes == 0   # the header gives each lane's size


@pytest.mark.parametrize("quality,mode", [(5, 0), (9, 1), (11, 0)])
def test_context_maps_and_tree_groups(quality, mode):
    datas = [TEXT[:6000], HTML[:5000], TEXT[7000:9000] + HTML[:3000]]
    streams = [brotli_tpu.encode(d, quality=quality, mode=mode) for d in datas]
    if quality == 9:
        assert max(_num_types(s)[1] for s in streams) > 1   # several trees
    _check(streams, datas)


def test_heavy_block_switching_font_q11():
    """A FONT-mode q11 host encode with >= 16 block types in every
    category (the enc-ttf class) decodes bit-exactly."""
    data = corpus.font(196608, 0)
    stream = brotli_tpu.encode(data, quality=11, lgwin=22, mode=2)
    types = _num_types(stream)[0]
    assert min(types) >= 16, types
    _check([stream, stream], [data, data])


def test_dictionary_transforms_on_device():
    """Pure static-dictionary references, one per transform class
    (identity, omit-first/last, uppercase-first/all, prefixes, suffixes)."""
    from brotli_tpu.decode import dictionary as sd
    from brotli_tpu.decode.transforms import TRANSFORM_LIST, transform_word

    chosen, seen_ops = [], set()
    for tf, (_pre, op, _suf) in enumerate(TRANSFORM_LIST):
        if op not in seen_ops:
            chosen.append(tf)
            seen_ops.add(op)
    chosen += list(range(0, len(TRANSFORM_LIST), 7))   # and a spread of all
    parts, commands, pos = [], [], 0
    for k, tf in enumerate(chosen):
        wlen = 4 + (k % 20)
        shift = sd.size_bits(wlen)
        widx = (37 * k) % (1 << shift)
        out = transform_word(sd.get_word(wlen, widx), tf)
        distance = min(pos, (1 << 22) - 16) + 1 + ((tf << shift) | widx)
        commands.append(make_command(0, wlen, 0, distance + 15, 0, 0))
        parts.append(out)
        pos += len(out)
    expected = b"".join(parts)
    w = BitWriter()
    nb, val = encode_window_bits(22, False)
    w.write(nb, val)
    store_metablock_trivial(
        w, expected, 0, len(expected), _NO_MASK, True, commands, 64, 0, 0)
    stream = w.finish()
    assert host_decode(stream) == expected
    _check([stream], [expected])


def test_static_dictionary_in_host_streams():
    words = b"information development government necessary different "
    datas = [words * 4, b"The Quick Brown Fox " * 5 + words]
    _check([brotli_tpu.encode(d, quality=q) for d, q in zip(datas, (5, 11))],
           datas)


def test_custom_and_compound_dictionaries():
    dic = HTML[:20000]
    pairs = [corpus.dictionary_stream(dic, 3000 + 2000 * k, k) for k in range(4)]
    _check([p[0] for p in pairs], [p[1] for p in pairs], custom_dictionary=dic)
    chunks = [dic[:7000], dic[7000:13000], dic[13000:]]
    _check([p[0] for p in pairs], [p[1] for p in pairs],
           custom_dictionary=chunks)


def test_multi_metablock_uncompressed_and_metadata():
    data = HTML[:40000] + TEXT[:30000]
    stream = corpus.multi_metablock_stream(data, 1 << 13, qualities=(5, 0, 1, 9))
    assert brotli_tpu.decoded_size(stream) == -1
    res = _check([stream], [data])
    assert res.launches >= 1


def test_large_window_stream():
    from brotli_tpu.constants import distance_alphabet_size
    from brotli_tpu.encode.command import make_insert_command

    data = b"large window test payload " * 10
    w = BitWriter()
    nb, val = encode_window_bits(26, True)
    w.write(nb, val)
    store_metablock_trivial(
        w, data, 0, len(data), (1 << 62) - 1, True,
        [make_insert_command(len(data))], distance_alphabet_size(0, 0, 62))
    w.align_to_byte()
    s = w.finish()
    _check([s], [data], large_window=True)
    res = decode_batch([s], interpret=True)
    assert res.device_codes[0] == -11 and res.error_lanes == 1


def test_truncated_and_malformed_lanes_flagged():
    good = [brotli_tpu.encode(TEXT[:5000], quality=q) for q in (1, 5, 11)]
    bad = [good[1][: len(good[1]) // 2], good[2][:-3], b"", b"\x0c\xff\xff",
           good[0][:1]]
    res = decode_batch(good + bad, interpret=True)
    assert res.outputs[:3] == [TEXT[:5000]] * 3
    for k, b in enumerate(bad):
        lane = 3 + k
        assert res.device_codes[lane] != 0
        assert isinstance(res.outputs[lane], BrotliError)
        with pytest.raises(BrotliError) as ei:
            host_decode(b)
        assert res.outputs[lane].code == ei.value.code
    assert res.error_lanes == len(bad) and res.fallback_lanes == 0
    with pytest.raises(BrotliError):
        res.values()


def test_poisoned_distance_flags():
    """A copy distance beyond both the window and the dictionary range
    flags the lane (-9) instead of emitting garbage."""
    data = b"ABCDEFGH????"
    bogus = (1 << 22) + (1 << 25)
    w = BitWriter()
    nb, val = encode_window_bits(22, False)
    w.write(nb, val)
    store_metablock_trivial(
        w, data, 0, len(data), _NO_MASK, True,
        [make_command(8, 4, 0, bogus + 15, 0, 0)], 64, 0, 0)
    res = decode_batch([w.finish()], interpret=True)
    assert res.device_codes[0] == -9 and res.error_lanes == 1


def test_output_and_arena_relaunch():
    """Lanes whose capacity or table arena is too small report the size
    they need and are relaunched on the device, not sent to the host."""
    data = TEXT[:50000]
    s = brotli_tpu.encode(data, quality=11)
    job = DecodeJob([s, s], interpret=True)
    assert list(job.caps) == [50000, 50000]
    job.caps[0] = 100
    res = job.launch().finish()
    assert res.values() == [data, data]
    assert res.relaunched_lanes == 1 and res.launches == 2
    job = DecodeJob([s], interpret=True)
    job.arena_caps[:] = ARENA_FIXED        # room for no tree
    res = job.launch().finish()
    assert res.values() == [data] and res.relaunched_lanes == 1


def test_arena_below_fixed_region_relaunched():
    """A lane whose arena cannot hold the fixed table region is told to
    grow before anything is written to it, then to fit its trees."""
    datas = [TEXT[k * 5000: k * 5000 + 4000] for k in range(6)]
    job = DecodeJob([brotli_tpu.encode(d, quality=9) for d in datas],
                    interpret=True)
    job.arena_caps[:] = 1000
    res = job.launch().finish()
    assert res.values() == datas
    assert res.relaunched_lanes == 12 and res.launches == 3


def test_offsets_and_padding_buckets():
    streams = [brotli_tpu.encode(TEXT[k * 700: k * 700 + 300 + 97 * k],
                                 quality=5) for k in range(37)]
    job = DecodeJob(streams, interpret=True)
    st = job.stage_lanes(list(range(37)))
    inp, in_off, out_off, arena_off = (np.asarray(a) for a in st.args[:4])
    assert in_off.shape == (bucket(37, 32) + 1,) == (49,)
    assert inp.size == bucket(in_off[-1] + 8, 1 << 12)
    # lanes are sorted longest first, and each owns its exact capacity
    lens = [len(streams[i]) for i in st.lanes]
    assert lens == sorted(lens, reverse=True)
    assert list(np.diff(out_off)[:37]) == [int(job.caps[i]) for i in st.lanes]
    assert (np.diff(in_off)[37:] == 0).all()       # padding lanes are empty
    for j, i in enumerate(st.lanes):
        assert inp[in_off[j]: in_off[j + 1]].tobytes() == streams[i]
    assert [bucket(x) for x in (5, 6, 7, 100, 4096, 5000)] == \
        [6, 6, 8, 128, 4096, 6144]


def test_interpret_false_raises_without_gpu():
    import jax

    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        decode_batch([brotli_tpu.encode(b"abc", quality=5)])


def test_empty_batch_and_empty_stream():
    assert decode_batch([], interpret=True).outputs == []
    res = decode_batch([b""], interpret=True)
    assert isinstance(res.outputs[0], BrotliError) and res.error_lanes == 1


@pytest.mark.gpu
def test_gpu_build_matches_host(gpu):
    """On a card: the CUDA build decodes a mixed batch like the host."""
    datas = [TEXT[:20000], HTML[:9000], FONT[:12000]]
    streams = [brotli_tpu.encode(d, quality=q, mode=m)
               for d, q, m in zip(datas, (5, 11, 9), (1, 0, 2))]
    res = decode_batch(streams * 50)
    assert res.values() == datas * 50
    assert res.fallback_lanes == 0


def test_profile_decode_report():
    """Decode profiler: three phases around one launch of the CPU build,
    and a byte count equal to the decoded total."""
    from brotli_tpu.utils import phase_report, profile_decode

    datas = [TEXT[:8000], HTML[:6000]]
    streams = [brotli_tpu.encode(d, quality=5) for d in datas]
    phases, summary = profile_decode(streams, interpret=True)
    assert [p.kind for p in phases] == ["host", "device", "host"]
    assert summary["bytes"] == sum(map(len, datas))
    assert summary["flagged_lanes"] == 0
    assert len(phase_report(phases, summary["bytes"]).splitlines()) == 3


def _declares(mlen: int, islast: bool) -> bytes:
    """A stream whose first metablock header declares `mlen` bytes (and
    whose content is missing)."""
    w = BitWriter()
    nb, val = encode_window_bits(22, False)
    w.write(nb, val)
    w.write(1, int(islast))
    if islast:
        w.write(1, 0)            # ISLASTEMPTY
    w.write(2, 2)                # MNIBBLES = 6
    w.write(24, mlen - 1)
    if not islast:
        w.write(1, 1)            # ISUNCOMPRESSED
    w.align_to_byte()
    return w.finish() + bytes(16)


def test_declared_huge_output_over_max_output_size():
    """Streams that declare 16 MiB against a 1 MiB limit are rejected with
    the host's error (-28) without decoding: one by its header alone, one
    when the device reports the size it needs.  Other lanes decode."""
    good = brotli_tpu.encode(TEXT[:4000], quality=5)
    big_last, big_first = _declares(1 << 24, True), _declares(1 << 24, False)
    assert brotli_tpu.decoded_size(big_last) == 1 << 24
    res = decode_batch([good, big_last, big_first], interpret=True,
                       max_output_size=1 << 20)
    assert res.outputs[0] == TEXT[:4000]
    for lane in (1, 2):
        assert res.outputs[lane].code == -28
        assert res.device_codes[lane] == ERR_OUT_CAP
    assert res.error_lanes == 2 and res.fallback_lanes == 0
    assert res.launches == 1 and res.relaunched_lanes == 0


def test_lane_over_launch_limit_gets_host_verdict(monkeypatch):
    """A lane that needs more than one launch may hold is flagged and
    decoded by the host (a counted fallback); a truncated one gets the
    host's error.  The batch's other lanes still decode on the device."""
    monkeypatch.setattr(batch_decode, "LAUNCH_BYTES", 1 << 16)
    small = [TEXT[k * 3000: k * 3000 + 2500] for k in range(3)]
    big = TEXT[:100000]
    multi = TEXT[40000:130000]
    streams = [brotli_tpu.encode(d, quality=5) for d in small + [big]]
    streams.append(corpus.multi_metablock_stream(multi, 1 << 13))
    res = decode_batch(streams + [streams[3][:-40]], interpret=True)
    assert res.outputs[:5] == small + [big, multi]
    assert isinstance(res.outputs[5], BrotliError)
    assert list(res.device_codes[3:]) == [ERR_OUT_CAP] * 3
    assert res.fallback_lanes == 2 and res.error_lanes == 1


@pytest.mark.parametrize("limit", [1 << 13, 1 << 14, 1 << 16])
def test_launches_split_to_the_limit(monkeypatch, limit):
    """Lanes are split over launches that each keep their input, output
    and arena within LAUNCH_BYTES (a lane alone may pass it), and come
    back in order."""
    monkeypatch.setattr(batch_decode, "LAUNCH_BYTES", limit)
    groups = []
    launch_one = DecodeJob._launch_one

    def spy(job, lanes):
        groups.append([(len(job.streams[i]) + 8, int(job.caps[i]),
                        4 * int(job.arena_caps[i])) for i in lanes])
        launch_one(job, lanes)

    monkeypatch.setattr(DecodeJob, "_launch_one", spy)
    datas = [TEXT[k * 1000: k * 1000 + 700 + 300 * (k % 4)] for k in range(24)]
    streams = [brotli_tpu.encode(d, quality=5) for d in datas]
    job = DecodeJob(streams, interpret=True)
    job.arena_caps[:] = 1000        # relaunched for the arena they need
    res = job.launch().finish()
    assert res.values() == datas
    assert res.fallback_lanes == res.error_lanes == 0
    for g in groups:
        assert len(g) == 1 or max(map(sum, zip(*g))) <= limit
    assert len(groups) == res.launches >= -(-sum(map(len, datas)) // limit)


def test_entry_compile_check():
    """The compile-check entry decodes its example batch with the CPU
    build only when asked to, and raises off the GPU otherwise."""
    import jax

    import __graft_entry__ as graft

    fn, args = graft.entry(interpret=True)
    _, status = fn(*args)
    status = np.asarray(status)
    assert (status[:, 0] == 0).all()
    assert status[:, 1].sum() == sum(2048 + 512 * k for k in range(32))
    assert jax.default_backend() != "gpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        graft.entry()
