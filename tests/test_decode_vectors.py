"""Decoder conformance on seeded vectors and the one third-party stream.

Mirrors the reference's test strategy (test/brotli.test.ts:88-101): every
vector decodes to its original, byte for byte, through both host decoders
(the native core and the python golden engine).  The vectors are the
seeded corpus encoded at several qualities, modes and window sizes, plus
`data/dictionary.br`, a stream written by Google's encoder.
"""

from pathlib import Path

import pytest

import brotli_tpu
from brotli_tpu import BrotliError, corpus, decode, decoded_size

from conftest import FONT, HTML, TEXT

DICT_BR = Path(brotli_tpu.__file__).parent / "data" / "dictionary.br"


def _vectors():
    out = [("dictionary.br", DICT_BR.read_bytes(), None)]
    cases = [
        ("text", TEXT[:20000]), ("html", HTML[:16000]), ("font", FONT[:12000]),
        ("empty", b""), ("one", b"x"), ("zeros", b"\x00" * 5000),
    ]
    for name, data in cases:
        for q, mode, lgwin in ((1, 0, 22), (5, 1, 22), (9, 0, 18),
                               (11, 2, 16), (0, 0, 10)):
            if q == 11 and len(data) > 4000:
                data = data[:4000]
            out.append((f"{name}_q{q}_m{mode}_w{lgwin}",
                        brotli_tpu.encode(data, quality=q, mode=mode,
                                          lgwin=lgwin), data))
    return out


_VECTORS = _vectors()


def _python_engine_decode(data: bytes) -> bytes:
    from brotli_tpu.decode.engine import decode as py_decode

    return py_decode(data)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("name,comp,base", _VECTORS,
                         ids=[v[0] for v in _VECTORS])
def test_vector(name: str, comp: bytes, base: bytes | None, engine: str):
    fn = decode if engine == "native" else _python_engine_decode
    out = fn(comp)
    if base is None:   # dictionary.br decodes to the static dictionary
        from brotli_tpu.decode.dictionary import get_dictionary

        base = get_dictionary()
    assert out == base


def test_decoded_size_empty_stream():
    # ISLAST+ISLASTEMPTY one-byte stream
    assert decode(bytes([0x3B])) == b""


def test_decoded_size_single_metablock():
    data = brotli_tpu.encode(TEXT[:30000], quality=9)
    assert decoded_size(data) == 30000
    payload = b"peekable" * 200
    assert decoded_size(brotli_tpu.encode(payload, quality=5)) == len(payload)
    # an empty input yields -1, never raises
    assert decoded_size(b"") == -1
    # a multi-metablock stream is not cheaply sized
    multi = corpus.multi_metablock_stream(TEXT[:40000], 1 << 14)
    assert decoded_size(multi) == -1


def test_max_output_size_enforced():
    data = brotli_tpu.encode(TEXT[:30000], quality=5)
    with pytest.raises(BrotliError):
        decode(data, max_output_size=100)
    assert decode(data, max_output_size=30000) == TEXT[:30000]


def test_truncated_input_raises():
    data = brotli_tpu.encode(TEXT[:30000], quality=5)
    with pytest.raises(BrotliError):
        decode(data[: len(data) // 2])


def test_garbage_raises():
    with pytest.raises(BrotliError):
        decode(b"\x0c\xff\xff\xff\xff\xff\xff")


# --- native decoder core vs python golden engine ---

def test_native_matches_python_engine():
    from brotli_tpu.decode.engine import decode as py_decode
    from brotli_tpu.native import native_decode

    for _, comp, _base in _VECTORS[:12]:
        assert native_decode(comp) == py_decode(comp)


def _bad_inputs():
    text = brotli_tpu.encode(TEXT[:40000], quality=9)
    multi = corpus.multi_metablock_stream(HTML[:40000], 1 << 13)
    font = brotli_tpu.encode(FONT[:8000], quality=11, mode=2)
    bads = [
        b"\x1b\x03\x00\xff\xff\xff", b"\x00", b"",
        b"\x0c\xff\xff\xff\xff\xff\xff",
        bytes([0x3B]) + b"X",          # valid empty stream + garbage
        text[: len(text) // 2],         # truncated mid-stream
        text[:3], text[:17], text[:-1],
        b"\xa1\xff\xff\xff\xff",
        multi[: len(multi) // 3], multi[:-1], multi + b"\x00",
    ]
    bads += [font[:k] for k in range(1, len(font), 211)]
    # seeded bit flips
    u = corpus._uniform(3, 77, 3 * 120)
    for k in range(120):
        src = bytearray((text, multi, font)[k % 3][:2000])
        for j in range(3):
            pos = int(u[3 * k + j] * len(src))
            src[pos] ^= 1 << (int(u[3 * k + j] * 8 * len(src)) % 8)
        bads.append(bytes(src))
    return bads


def test_native_error_codes_match():
    """Exact error-code (and output) parity between the native core and the
    python engine on truncated, corrupted and garbage inputs."""
    from brotli_tpu.decode.engine import decode as py_decode
    from brotli_tpu.native import native_decode

    for bad in _bad_inputs():
        py = nat = None
        try:
            py = py_decode(bad)
        except BrotliError as e:
            py = e.code
        try:
            nat = native_decode(bad)
        except BrotliError as e:
            nat = e.code
        assert py == nat, f"divergence on {bad[:16]!r}: py={py!r:.40} nat={nat!r:.40}"
