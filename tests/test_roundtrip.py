"""Encoder round-trip tests across all qualities (reference test strategy
brotli.test.ts:199-312: quality sweep + deterministic fuzz + streaming)."""

import pytest

from brotli_tpu import decode
from brotli_tpu.encode import Encoder, encode

from conftest import FONT, TEXT


def _xorshift32(seed):
    x = seed
    while True:
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        yield x


def _random_bytes(n, seed=1):
    g = _xorshift32(seed)
    return bytes(next(g) & 0xFF for _ in range(n))


def _ramp_bytes(n):
    return bytes(i & 0xFF for i in range(n))


ALICE = TEXT

CASES = [
    b"",
    b"x",
    b"hello world, hello world, hello world! " * 3,
    ALICE[:4500],
    _ramp_bytes(8192),
    b"\x00" * 10000,
    _random_bytes(5000),
]


@pytest.mark.parametrize("quality", list(range(12)))
def test_roundtrip_all_qualities(quality):
    for data in CASES:
        enc = encode(data, quality=quality)
        assert decode(enc) == data, f"q{quality} len={len(data)}"


# 18 sizes x 2 patterns x all 12 qualities, mirroring the reference's fuzz
# envelope (brotli.test.ts:247-281). The HQ qualities (10/11) cap at 2 KB in
# the default run — python Zopfli on every size would dominate suite time —
# with the full sizes covered by the slow variant below.
_FUZZ_SIZES = [1, 2, 3, 4, 5, 7, 8, 15, 16, 31, 63, 64,
               127, 255, 256, 1000, 4095, 8192]


@pytest.mark.parametrize("quality", list(range(12)))
def test_roundtrip_sizes_fuzz(quality):
    cap = 2048 if quality >= 10 else 10**9
    for size in _FUZZ_SIZES:
        if size > cap:
            continue
        for maker, tag in [(_random_bytes, "rnd"), (_ramp_bytes, "ramp")]:
            data = maker(size)
            enc = encode(data, quality=quality)
            assert decode(enc) == data, f"q{quality} {tag} {size}"


@pytest.mark.slow
@pytest.mark.parametrize("quality", [10, 11])
def test_roundtrip_sizes_fuzz_hq_large(quality):
    for size in [4095, 8192]:
        for maker, tag in [(_random_bytes, "rnd"), (_ramp_bytes, "ramp")]:
            data = maker(size)
            enc = encode(data, quality=quality)
            assert decode(enc) == data, f"q{quality} {tag} {size}"


def test_modes_roundtrip():
    data = ALICE[:8000]
    for mode in (0, 1, 2):  # GENERIC, TEXT, FONT
        for q in (1, 5, 11):
            enc = encode(data, quality=q, mode=mode)
            assert decode(enc) == data, f"mode={mode} q={q}"


def test_font_mode_differs_from_generic():
    data = FONT[:20000]
    generic = encode(data, quality=5, mode=0)
    font = encode(data, quality=5, mode=2)
    assert decode(font) == data
    assert font != generic  # npostfix/ndirect actually plumbed


@pytest.mark.parametrize("quality", [1, 4, 5, 9, 10, 11])
def test_streaming_random_chunks(quality):
    data = ALICE[:12000]
    enc = Encoder(quality=quality)
    out = bytearray()
    g = _xorshift32(7)
    i = 0
    while i < len(data):
        n = (next(g) % 257) + 1
        out.extend(enc.update(data[i : i + n]))
        i += n
    out.extend(enc.finish())
    assert decode(bytes(out)) == data


def test_compression_shrinks_text():
    data = ALICE[:40000]
    for q in (1, 5, 9, 11):
        assert len(encode(data, quality=q)) < len(data) * 0.6


def test_encode_sharded_concat_roundtrip():
    """encode_sharded_concat: one spliced stream, any standard decoder.

    Covers the cross-chunk distance-ring sentinel and the empty-metadata
    splice (ADVICE round 1): repetitive data makes every non-final chunk end
    in a copy, so the next chunk starts with the previous chunk's ring
    state poisoned by the sentinel.
    """
    from brotli_tpu import encode_sharded_concat

    rep = (b"abcdefgh" * 200)[:1500]  # chunk ends mid-repetition => copy
    cases = [
        ALICE[:5000],           # text, 5 chunks
        rep + ALICE[:2000],     # copy crossing chunk boundary
        b"\x00" * 4000,         # byte-run copies to every chunk end
        ALICE[:1024],           # exactly one chunk
        ALICE[:1025],           # chunk + 1-byte tail
    ]
    for data in cases:
        stream = encode_sharded_concat(data, chunk_size=1024)
        assert decode(stream) == data, f"len={len(data)}"
        # python golden engine too (independent of the native fast path)
        from brotli_tpu.decode.engine import decode as py_decode

        assert py_decode(stream) == data


def test_honor_lgwin_distances_beyond_4mb():
    """lgwin-honoring mode (SURVEY section 5): with lgwin=24 the encoder
    searches the full ~16 MB window; the reference quirk caps matches at
    (1<<22)-16 regardless of lgwin.  A repeat at distance ~4.3 MB is only
    compressible in the honoring mode; both modes must round-trip."""
    import hashlib

    prefix = b"".join(
        hashlib.sha256(i.to_bytes(4, "little")).digest() for i in range(2048)
    )  # 64 KB incompressible-ish
    data = prefix + b"\x00" * (4 * 1024 * 1024 + 128 * 1024) + prefix

    quirk = encode(data, quality=2, lgwin=24)
    honored = encode(data, quality=2, lgwin=24, honor_lgwin=True)
    assert decode(quirk) == data
    assert decode(honored) == data
    # the distance > 4 MB match only exists in the honoring mode
    assert len(honored) < len(quirk) - 30000
