"""BASELINE config 4: FONT mode + custom/compound dictionary decode.

FONT mode changes the distance parameterization (npostfix=1, ndirect=12,
enc-constants.ts:121-127); compound dictionaries are decoder-side prefix
dictionaries (engine.ts:142-159, 964-1011).
"""

import pytest

import brotli_tpu
from brotli_tpu.encode.bitwriter import BitWriter, encode_window_bits
from brotli_tpu.encode.command import make_command, make_insert_command
from brotli_tpu.encode.metablock import store_metablock_trivial
from brotli_tpu.encode.params import make_params

from conftest import FONT



@pytest.mark.parametrize("quality", [1, 5, 11])
def test_font_mode_roundtrip(quality):
    data = FONT[:20000]
    font = brotli_tpu.encode(data, quality=quality, mode=2)
    generic = brotli_tpu.encode(data, quality=quality, mode=0)
    assert brotli_tpu.decode(font) == data
    assert brotli_tpu.decode(generic) == data
    if quality >= 4:  # MIN_QUALITY_FOR_NONZERO_DISTANCE_PARAMS: npostfix
        assert font != generic  # /ndirect plumbing reaches the stream
    else:  # reference gates FONT dist params on quality (enc-constants.ts)
        assert font == generic


def test_font_mode_distance_params():
    params = make_params(5, None, 2, 20000)
    assert params.dist.npostfix == 1
    assert params.dist.ndirect == 12


def _craft_dict_stream(prefix_total: int, insert: bytes, copy_len: int,
                       back_into_dict: int) -> bytes:
    """Stream: insert literals, then copy `copy_len` bytes starting
    `back_into_dict` bytes from the END of the compound dictionary."""
    params = make_params(5, 22, 0, 64)
    pos = len(insert)
    max_distance = pos  # min(out_pos, max_backward) at the copy
    distance = max_distance + back_into_dict
    cmds = [
        make_command(len(insert), copy_len, 0, distance + 15,
                     params.dist.ndirect, params.dist.npostfix),
    ]
    w = BitWriter()
    nb, val = encode_window_bits(params.lgwin, False)
    w.write(nb, val)
    mlen = len(insert) + copy_len
    store_metablock_trivial(
        w, insert + b"\x00" * copy_len, 0, mlen, (1 << 62) - 1, True, cmds,
        params.dist_alphabet_size, params.dist.npostfix, params.dist.ndirect,
    )
    w.align_to_byte()
    return w.finish()


def test_compound_dictionary_single_chunk():
    d = b"hello world dictionary content!"
    s = _craft_dict_stream(len(d), b"abc", 8, len(d))
    out = brotli_tpu.decode(s, custom_dictionary=d)
    assert out == b"abc" + d[:8]


def test_compound_dictionary_suffix_addressing():
    d = b"0123456789ABCDEF"
    # back_into_dict=4 -> copy from 4 bytes before the dictionary end
    s = _craft_dict_stream(len(d), b"xy", 4, 4)
    out = brotli_tpu.decode(s, custom_dictionary=d)
    assert out == b"xy" + d[-4:]


def test_compound_dictionary_multi_chunk_crossing():
    chunks = [b"AAAABBBB", b"CCCCDDDD"]
    total = sum(len(c) for c in chunks)
    # copy 12 bytes starting 14 back from the end: crosses the chunk seam
    s = _craft_dict_stream(total, b"!", 12, 14)
    out = brotli_tpu.decode(s, custom_dictionary=chunks)
    assert out == b"!" + (b"".join(chunks))[-14:][:12]


def test_compound_dictionary_overflow_rejected():
    d = b"tiny"
    s = _craft_dict_stream(len(d), b"abc", 16, 4)  # runs past the dict end
    with pytest.raises(brotli_tpu.BrotliError):
        brotli_tpu.decode(s, custom_dictionary=d)


def test_too_many_dictionary_chunks_rejected():
    with pytest.raises(brotli_tpu.BrotliError):
        brotli_tpu.decode(b"\x00" * 4, custom_dictionary=[b"x"] * 16)


# --- encoder-side static-dictionary matches (north-star E22 extension) ---

def test_static_dict_matches_emitted_and_decode():
    # text full of dictionary words with no self-repetition
    data = (b"information development government necessary "
            b"different performance particular education ")
    s = brotli_tpu.encode(data, quality=5)
    assert brotli_tpu.decode(s) == data


def test_static_dict_matches_real_words():
    # probe with actual dictionary words so the test is self-validating
    from brotli_tpu.decode.dictionary import get_word
    from brotli_tpu.encode.static_dict import find_dictionary_match

    for length in (4, 6, 8, 10):
        w = get_word(length, 3)
        m = find_dictionary_match(w + b"\x00\x00", 0, length)
        assert m is not None
        ml, mi = m
        assert get_word(ml, mi) == w[:ml]


def test_static_dict_lookup_is_exact():
    from brotli_tpu.encode.static_dict import find_dictionary_match
    from brotli_tpu.decode.dictionary import get_word
    m = find_dictionary_match(b"development kit", 0, 15)
    assert m is not None
    length, idx = m
    assert get_word(length, idx) == b"development kit"[:length]


# --- large-window decode (lgwin > 24; decoder-side extension, D4) ---

def test_large_window_decode():
    from brotli_tpu.constants import distance_alphabet_size
    from brotli_tpu.encode.bitwriter import BitWriter, encode_window_bits
    from brotli_tpu.encode.command import make_insert_command
    from brotli_tpu.encode.metablock import store_metablock_trivial

    data = b"large window test payload " * 10
    w = BitWriter()
    nb, val = encode_window_bits(26, True)
    w.write(nb, val)
    cmds = [make_insert_command(len(data))]
    store_metablock_trivial(
        w, data, 0, len(data), (1 << 62) - 1, True, cmds,
        distance_alphabet_size(0, 0, 62),
    )
    w.align_to_byte()
    s = w.finish()
    assert brotli_tpu.decode(s, large_window=True) == data
    with pytest.raises(brotli_tpu.BrotliError):
        brotli_tpu.decode(s)  # without the flag the stream must be rejected


def test_compound_dictionary_on_device_v3():
    """Compound-dictionary streams decode through the batch kernel (CPU
    build): addresses past the window into the dictionary, a copy across
    a chunk seam, and an overflow that the lane flags and the host rejects
    (no silent fallback)."""
    from brotli_tpu.ops.batch_decode import decode_batch

    d1 = b"hello world dictionary content!"
    chunks = [b"AAAABBBB", b"CCCCDDDD"]
    total = sum(len(c) for c in chunks)
    cases = [
        (_craft_dict_stream(len(d1), b"abc", 8, len(d1)), d1,
         b"abc" + d1[:8]),
        (_craft_dict_stream(len(d1), b"xy", 4, 4), d1, b"xy" + d1[-4:]),
        (_craft_dict_stream(total, b"!", 12, 14), chunks,
         b"!" + (b"".join(chunks))[-14:][:12]),
    ]
    for s, cd, expected in cases:
        res = decode_batch([s, s], interpret=True, custom_dictionary=cd)
        assert res.values() == [expected, expected]
        assert res.fallback_lanes == 0
    bad = _craft_dict_stream(4, b"abc", 16, 4)
    res = decode_batch([bad], interpret=True, custom_dictionary=b"tiny")
    assert res.device_codes[0] == -9 and res.error_lanes == 1
    assert isinstance(res.outputs[0], brotli_tpu.BrotliError)
    with pytest.raises(brotli_tpu.BrotliError):
        res.values()
