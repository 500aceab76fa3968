"""Seeded synthetic corpus: web text, HTML and font-like binary tables.

Tests, the bench, `chip_smoke.py` and the tools all draw their inputs from
here, so every run can rebuild its data from a seed with nothing
downloaded.  The same seed gives the same bytes on any host: the random
stream is a counter-based splitmix64 hash computed in numpy, not numpy's
generators, whose streams may change between versions.

Choices, each named where it is made:
  * vocabulary: the ASCII-letter words of lengths 2-12 in the RFC 7932
    static dictionary (`data/dictionary.bin`), in dictionary order, which
    is roughly by frequency; text built from them also exercises the
    encoder's static-dictionary references;
  * word ranks: Zipf with exponent ZIPF_S = 1.1 over the vocabulary;
  * sentences: 4-18 words, the first capitalised, ended by ". ", "? "
    or ", " (weights 6:1:2);
  * HTML: each block is one of HTML_TEMPLATES filled with words and one
    sentence;
  * font tables: a sfnt-like header, then 0.5-4 KiB tables in a seeded
    order, of glyph contours (int16 deltas, small and signed), metrics
    (u16 pairs), a sorted cmap (u16 runs), loca offsets (increasing u32),
    kerning pairs, ASCII names, zero padding, near-random payload, and
    fixed-width records (stride 4-96 B, the first 1-4 bytes of each record
    fresh), so that a q10/11 FONT-mode encode splits all three block
    categories into many types;
  * web lengths: log-uniform between 2 KiB and 64 KiB (heavy-tailed: half
    the streams are under 11.3 KiB).
"""

from __future__ import annotations

import functools

import numpy as np

ZIPF_S = 1.1
HTML_TEMPLATES = (
    '<div class="{w0} {w1}"><p>{s}</p></div>\n',
    '<li><a href="/{w0}/{w1}.html" title="{w2}">{s}</a></li>\n',
    '<h2 id="{w0}">{s}</h2>\n',
    '<tr><td class="{w0}">{w1}</td><td>{s}</td></tr>\n',
    '<meta name="{w0}" content="{s}">\n',
    '<span style="color:#{hex}">{s}</span>\n',
)


def _hash(seed: int, stream: int, n: int) -> np.ndarray:
    """n splitmix64 outputs for (seed, stream), as uint64."""
    x = (np.arange(n, dtype=np.uint64)
         + np.uint64((seed * 0x9E3779B1 + stream * 0x85EBCA77)
                     & 0xFFFFFFFFFFFFFFFF))
    with np.errstate(over="ignore"):
        x = x * np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _uniform(seed: int, stream: int, n: int) -> np.ndarray:
    """n floats in [0, 1)."""
    return (_hash(seed, stream, n) >> np.uint64(11)).astype(np.float64) / (1 << 53)


@functools.lru_cache(maxsize=1)
def vocabulary() -> tuple[bytes, ...]:
    from .constants import DICT_OFFSETS_BY_LENGTH, DICT_SIZE_BITS_BY_LENGTH
    from .decode.dictionary import get_dictionary

    d = get_dictionary()
    words = []
    for length in range(2, 13):
        nbits = int(DICT_SIZE_BITS_BY_LENGTH[length])
        if nbits == 0:
            continue
        off = int(DICT_OFFSETS_BY_LENGTH[length])
        for k in range(1 << nbits):
            w = d[off + k * length: off + (k + 1) * length]
            if w.isalpha() and w.isascii() and w.islower():
                words.append(w)
    return tuple(words)


@functools.lru_cache(maxsize=1)
def _zipf_cdf() -> np.ndarray:
    ranks = np.arange(1, len(vocabulary()) + 1, dtype=np.float64)
    p = ranks ** -ZIPF_S
    return np.cumsum(p / p.sum())


def _words(seed: int, stream: int, n: int) -> list[bytes]:
    idx = np.searchsorted(_zipf_cdf(), _uniform(seed, stream, n), side="right")
    vocab = vocabulary()
    return [vocab[min(int(i), len(vocab) - 1)] for i in idx]


def _sentences(seed: int, stream: int, n_bytes: int) -> list[bytes]:
    words = _words(seed, stream, n_bytes // 3 + 64)
    u = _uniform(seed, stream + 1, len(words))
    out, i, total, k = [], 0, 0, 0
    while total < n_bytes:
        if i + 18 >= len(words):
            words += _words(seed + 7919 * (k + 1), stream, 4096)
            u = np.concatenate([u, _uniform(seed + 7919 * (k + 1), stream + 1, 4096)])
            k += 1
        n = 4 + int(u[i] * 15)
        ws = words[i:i + n]
        end = (b". ", b". ", b". ", b". ", b". ", b". ", b"? ",
               b", ", b", ")[int(u[i + 1] * 9)]
        s = b" ".join([ws[0].capitalize(), *ws[1:]]) + end
        out.append(s)
        total += len(s)
        i += n
    return out


def text(n_bytes: int, seed: int = 0) -> bytes:
    """Prose of `n_bytes` bytes from Zipf-drawn dictionary words."""
    return b"".join(_sentences(seed, 1, n_bytes))[:n_bytes]


def html(n_bytes: int, seed: int = 0) -> bytes:
    """HTML blocks from HTML_TEMPLATES, `n_bytes` bytes."""
    sents = _sentences(seed, 3, n_bytes)
    words = _words(seed, 5, 3 * len(sents) + 3)
    pick = _uniform(seed, 6, len(sents))
    parts = [b"<!DOCTYPE html>\n<html><body>\n"]
    total = len(parts[0])
    for k, s in enumerate(sents):
        t = HTML_TEMPLATES[int(pick[k] * len(HTML_TEMPLATES))]
        block = t.format(
            w0=words[3 * k].decode(), w1=words[3 * k + 1].decode(),
            w2=words[3 * k + 2].decode(), s=s.decode().strip(),
            hex=f"{int(pick[k] * 0xFFFFFF):06x}",
        ).encode()
        parts.append(block)
        total += len(block)
        if total >= n_bytes:
            break
    return b"".join(parts)[:n_bytes]


def _font_table(kind: int, n: int, seed: int, stream: int) -> bytes:
    u = _uniform(seed, stream, n)
    if kind == 0:    # glyph contours: small signed int16 deltas
        scale = 4 + 200 * u[0]
        v = np.round(np.tan((u - 0.5) * 2.8) * scale).astype(np.int16)
        return v.astype(">i2").tobytes()
    if kind == 1:    # metrics: (advance, lsb) u16 pairs
        adv = (500 + (u * 700).astype(np.int64) // 10 * 10).astype(">u2")
        lsb = (u * 97).astype(">u2")
        return np.stack([adv, lsb], 1).tobytes()
    if kind == 2:    # cmap: sorted u16 code points with short runs
        cps = np.cumsum(1 + (u < 0.2) * (u * 40).astype(np.int64))
        return (cps & 0xFFFF).astype(">u2").tobytes()
    if kind == 3:    # loca: increasing u32 offsets
        return np.cumsum((u * 300).astype(np.int64) * 2).astype(">u4").tobytes()
    if kind == 4:    # kerning pairs: (left, right, value) u16,u16,i16
        left = np.sort((u * 600).astype(np.int64)).astype(">u2")
        right = ((u * 1e4).astype(np.int64) % 600).astype(">u2")
        val = (-(u * 120).astype(np.int64) // 10 * 10).astype(">i2")
        return b"".join(
            a.tobytes() + b.tobytes() + c.tobytes()
            for a, b, c in zip(left, right, val)
        )
    if kind == 5:    # name table: ASCII strings
        return text(n * 2, seed + stream)
    if kind == 6:    # padding: zero runs between short random fields
        v = np.zeros(2 * n, np.uint8)
        hot = u < 0.05
        v[: n][hot] = (u[hot] * 255).astype(np.uint8)
        return v.tobytes()
    if kind == 7:    # compressed-glyph payload: near-random bytes
        return (_hash(seed, stream + 1, 2 * n) & np.uint64(0xFF)).astype(np.uint8).tobytes()
    # fixed-width records: a template of `stride` bytes whose first
    # `fresh` bytes change from record to record (ids, offsets), so each
    # table has its own insert-length / copy-length command statistics;
    stride = (4, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 96)[(kind - 8) % 12]
    fresh = 1 + int(u[0] * min(4, stride - 2))
    reps = max(1, 2 * n // stride)
    rec = (_hash(seed, stream + 1, stride) & np.uint64(0xFF)).astype(np.uint8)
    v = np.tile(rec, (reps, 1))
    # fresh bytes from a per-table byte range, so literal statistics
    # differ between tables too
    span = 4 + int(u[1] * 60)
    base = int(u[2] * (256 - span))
    h = _hash(seed, stream + 2, reps * fresh) % np.uint64(span)
    v[:, :fresh] = (base + h.astype(np.int64)).astype(np.uint8).reshape(reps, fresh)
    return v.tobytes()


N_FONT_KINDS = 20


def font(n_bytes: int, seed: int = 0) -> bytes:
    """Font-like binary: an sfnt-style header and a seeded run of tables."""
    u = _uniform(seed, 11, 4096)
    parts = [b"\x00\x01\x00\x00" + bytes(8)]
    total, k = 12, 0
    while total < n_bytes:
        kind = int(u[2 * k] * N_FONT_KINDS)
        n = 256 + int(u[2 * k + 1] * 1792)
        tab = _font_table(kind, n // 2, seed, 100 + k)
        parts.append(tab)
        total += len(tab)
        k += 1
    return b"".join(parts)[:n_bytes]


def web_lengths(n: int, seed: int = 0, lo: int = 2048, hi: int = 65536) -> np.ndarray:
    """n log-uniform lengths in [lo, hi]."""
    u = _uniform(seed, 21, n)
    return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))).astype(np.int64)


def web_asset(n_bytes: int, seed: int = 0) -> bytes:
    """A text or HTML asset (alternating by seed)."""
    return (html if seed % 2 else text)(n_bytes, seed)


def bulk(n_bytes: int, seed: int = 0, piece: int = 65536) -> bytes:
    """Bulk-encode input: text and HTML pieces of `piece` bytes, mixed."""
    parts = []
    for k in range(-(-n_bytes // piece)):
        parts.append(web_asset(piece, seed * 100003 + k))
    return b"".join(parts)[:n_bytes]


# ---------------------------------------------------------------------------
# streams with a given layout, built by the host encoder
# ---------------------------------------------------------------------------

def multi_metablock_stream(data: bytes, shard: int = 1 << 17,
                           qualities=(5, 1, 0)) -> bytes:
    """One stream of many metablocks: `data` cut into shards encoded in
    turn at `qualities` (q0 stores uncompressed metablocks), spliced by the
    empty metadata blocks that `encode_fragment` puts between fragments."""
    from .encode import encode_fragment

    cuts = list(range(0, len(data), shard)) or [0]
    parts = []
    for k, a in enumerate(cuts):
        piece = data[a:a + shard]
        parts.append(encode_fragment(
            piece, quality=qualities[k % len(qualities)], lgwin=22,
            first=k == 0, last=k == len(cuts) - 1, out_offset=a,
            context_prelude=(data[a - 1] if a else 0, data[a - 2] if a > 1 else 0),
        ))
    return b"".join(parts)


def dictionary_stream(dictionary: bytes, n_bytes: int,
                      seed: int = 0) -> tuple[bytes, bytes]:
    """(stream, decoded) for a stream coded against `dictionary` as its
    custom (compound) dictionary: alternating literal inserts of new text
    and copies of 8-200 bytes from seeded places in the dictionary, the way
    a new version of a resource refers to its previous version."""
    from .encode.bitwriter import BitWriter, encode_window_bits
    from .encode.command import make_command
    from .encode.metablock import store_metablock_trivial
    from .encode.params import make_params

    params = make_params(5, 22, 0, n_bytes)
    max_backward = (1 << 22) - 16
    fresh = text(n_bytes, seed + 1)
    u = _uniform(seed, 31, 3 * (n_bytes // 8 + 8))
    out = bytearray()
    cmds = []
    k = 0
    while len(out) < n_bytes:
        ins = fresh[len(out): len(out) + 1 + int(u[3 * k] * 120)]
        copy_len = 8 + int(u[3 * k + 1] * 192)
        src = int(u[3 * k + 2] * (len(dictionary) - copy_len))
        pos = len(out) + len(ins)
        distance = min(pos, max_backward) + len(dictionary) - src
        cmds.append(make_command(len(ins), copy_len, 0, distance + 15,
                                 params.dist.ndirect, params.dist.npostfix))
        out += ins + dictionary[src: src + copy_len]
        k += 1
    w = BitWriter()
    nb, val = encode_window_bits(params.lgwin, False)
    w.write(nb, val)
    store_metablock_trivial(
        w, bytes(out), 0, len(out), (1 << 62) - 1, True, cmds,
        params.dist_alphabet_size, params.dist.npostfix, params.dist.ndirect,
    )
    w.align_to_byte()
    return w.finish(), bytes(out)


def noise(n_bytes: int, seed: int = 0) -> bytes:
    """Incompressible bytes."""
    return (_hash(seed, 51, n_bytes) & np.uint64(0xFF)).astype(np.uint8).tobytes()


def source(spec) -> bytes:
    """Bytes named by a spec: ("literal", text), or (generator, n_bytes,
    seed[, cut]) with generator one of text/html/font/noise/bulk."""
    if spec[0] == "literal":
        return spec[1].encode()
    name, n, seed, *cut = spec
    data = globals()[name](int(n), int(seed))
    return data[: cut[0]] if cut else data
