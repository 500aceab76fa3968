// RFC 7932 Brotli stream decoder core, shared by the host and the GPU.
//
// One call decodes one whole stream: window bits, every metablock header,
// Huffman table builds, context maps, block switching in all three
// categories, the static dictionary with its 121 transforms, compound
// dictionaries and large-window streams.  The same source is compiled by
// g++ for the host decoder (decoder.cpp) and the CPU build of the batch
// call (batch_decode.cu), and by
// nvcc for the GPU batch kernel, where one thread decodes one stream.
//
// Memory is caller-provided and flat, so a thread needs no allocator:
//   * `out[0, out_cap)`: the stream's own output, which is also its LZ
//     history (no ring, no window cap beyond the format's own);
//   * `arena[0, arena_cap)`: int32 scratch for one metablock's Huffman
//     tables, context maps and distance tables (reused per metablock).
// Tables use the python golden decoder's (nbits<<16 | payload) layout
// (brotli_tpu/decode/huffman.py).  Error codes follow the reference's
// negative scheme; two more say the caller's buffers were too small and
// report the size that is needed:
//   ERR_OUT_CAP   output capacity (need = bytes known to be required)
//   ERR_ARENA_CAP table arena (need = int32 words for the metablock)
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BRC_FN __host__ __device__ inline
#else
#define BRC_FN inline
#endif

namespace brc {

constexpr int ERR_OUT_CAP = -1000;
constexpr int ERR_ARENA_CAP = -1001;

constexpr int MAX_CODE_LENGTH = 15;
constexpr int64_t HUGE_BLOCK = 1 << 28;
constexpr int NUM_LIT = 256;
constexpr int NUM_CMD = 704;
constexpr int MAX_DIST_ALPHA = 544;

// Per-tree table strides: MAX_HUFFMAN_TABLE_SIZE for the alphabet (+1 slack).
constexpr int LIT_STRIDE = 631;
constexpr int CMD_STRIDE = 1081;
constexpr int BTYPE_STRIDE = 663;   // alphabet <= 258
constexpr int BLEN_STRIDE = 403;    // alphabet 26

// Fixed arena region (int32 words), then the metablock's tree groups.
constexpr int A_TYPE = 0;                                  // 3 x BTYPE_STRIDE
constexpr int A_LEN = A_TYPE + 3 * BTYPE_STRIDE;           // 3 x BLEN_STRIDE
constexpr int A_CMTAB = A_LEN + 3 * BLEN_STRIDE;           // cmap code table
constexpr int A_CLEN = A_CMTAB + BTYPE_STRIDE;             // code lengths (704)
constexpr int A_SORTED = A_CLEN + NUM_CMD;                 // sorted symbols
constexpr int A_CMAP = A_SORTED + NUM_CMD;                 // 256*64 bytes
constexpr int A_DCMAP = A_CMAP + 256 * 64 / 4;             // 256*4 bytes
constexpr int A_MODES = A_DCMAP + 256 * 4 / 4;             // 256 bytes
constexpr int A_DEXTRA = A_MODES + 256 / 4;                // 544
constexpr int A_DOFFSET = A_DEXTRA + MAX_DIST_ALPHA;       // 544
constexpr int A_TREES = A_DOFFSET + MAX_DIST_ALPHA;

// Packed int32 format tables: one buffer, fixed offsets (built by
// native/__init__.py:packed_tables in this order).
constexpr int P_INS_NBITS = 0;
constexpr int P_INS_OFFSET = P_INS_NBITS + 24;
constexpr int P_CP_NBITS = P_INS_OFFSET + 24;
constexpr int P_CP_OFFSET = P_CP_NBITS + 24;
constexpr int P_BLEN_NBITS = P_CP_OFFSET + 24;
constexpr int P_BLEN_OFFSET = P_BLEN_NBITS + 26;
constexpr int P_CMD_LUT = P_BLEN_OFFSET + 26;
constexpr int P_CONTEXT_LUT = P_CMD_LUT + 704 * 4;
constexpr int P_CLC_ORDER = P_CONTEXT_LUT + 2048;
constexpr int P_CLC_LENGTHS = P_CLC_ORDER + 18;
constexpr int P_DICT_OFFSETS = P_CLC_LENGTHS + 6;
constexpr int P_DICT_SIZEBITS = P_DICT_OFFSETS + 32;
constexpr int P_TF_SPANS = P_DICT_SIZEBITS + 32;
constexpr int NUM_TRANSFORMS = 121;
constexpr int P_TF_OPS = P_TF_SPANS + NUM_TRANSFORMS * 4;
constexpr int P_TOTAL = P_TF_OPS + NUM_TRANSFORMS;

struct Tables {
  const int32_t* ins_nbits;      // 24
  const int32_t* ins_offset;     // 24
  const int32_t* cp_nbits;       // 24
  const int32_t* cp_offset;      // 24
  const int32_t* blen_nbits;     // 26
  const int32_t* blen_offset;    // 26
  const int32_t* cmd_lut;        // 704*4: ins_code, cp_code, implicit, dist_ctx
  const int32_t* context_lut;    // 2048
  const int32_t* clc_order;      // 18
  const int32_t* clc_lengths;    // 6
  const int32_t* dict_offsets;   // 32
  const int32_t* dict_sizebits;  // 32
  const uint8_t* dict_data;
  const int32_t* tf_spans;       // 121*4: pre_off, pre_len, suf_off, suf_len
  const int32_t* tf_ops;         // 121
  const uint8_t* tf_storage;
  int32_t num_transforms;
};

BRC_FN Tables make_tables(const int32_t* p, const uint8_t* dict_data,
                          const uint8_t* tf_storage) {
  return Tables{p + P_INS_NBITS, p + P_INS_OFFSET, p + P_CP_NBITS,
                p + P_CP_OFFSET, p + P_BLEN_NBITS, p + P_BLEN_OFFSET,
                p + P_CMD_LUT, p + P_CONTEXT_LUT, p + P_CLC_ORDER,
                p + P_CLC_LENGTHS, p + P_DICT_OFFSETS, p + P_DICT_SIZEBITS,
                dict_data, p + P_TF_SPANS, p + P_TF_OPS, tf_storage,
                NUM_TRANSFORMS};
}

// Compound dictionary chunks, concatenated (a copy crosses chunk seams
// byte-linearly, so one buffer is equivalent).
struct Compound {
  const uint8_t* data;
  int64_t len;
};


struct Result {
  int32_t code;
  int64_t out_len;
  int64_t need;  // for ERR_OUT_CAP / ERR_ARENA_CAP
};

// LSB-first bit reader over a byte buffer.  Bits past the end read as
// zeros; a read that starts two 32-bit words or more past the end sets the
// sticky `err` (-10).  Both match the python golden decoder's BitReader,
// so truncated streams fail with the same code on every decoder.
struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t next;   // next byte to load
  int64_t limit;  // first bit position whose read is an error
  uint64_t buf;
  int nbuf;
  int err;

  BRC_FN void init(const uint8_t* d, int64_t n) {
    data = d; len = n; next = 0; buf = 0; nbuf = 0; err = 0;
    limit = 32 * ((n + 3) / 4 + 2);
  }
  BRC_FN void fill() {
    while (nbuf <= 56) {
      uint64_t b = next < len ? data[next] : 0;
      buf |= b << nbuf;
      nbuf += 8;
      next++;
    }
  }
  BRC_FN uint32_t peek(int n) {
    if (bitpos() >= limit) err = -10;
    if (nbuf < n) fill();
    return static_cast<uint32_t>(buf & ((1ull << n) - 1));
  }
  BRC_FN void skip(int n) { buf >>= n; nbuf -= n; }
  BRC_FN uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  BRC_FN int64_t bitpos() const { return next * 8 - nbuf; }
  BRC_FN bool overrun() const { return bitpos() > len * 8; }
  // drops the padding bits up to the byte boundary; nonzero padding is -5
  BRC_FN int jump_to_byte_boundary() {
    int pad = static_cast<int>((-bitpos()) & 7);
    if (pad && read(pad) != 0) return -5;
    return 0;
  }
  // bytes [start, start+n) of the input at the (aligned) cursor, or -1
  BRC_FN int64_t take_bytes(int64_t n) {
    int64_t start = bitpos() >> 3;
    if (start + n > len) return -1;
    next = start + n;
    buf = 0;
    nbuf = 0;
    return start;
  }
};

BRC_FN int next_key(int key, int length) {
  int step = 1 << (length - 1);
  while (key & step) step >>= 1;
  return (key & (step - 1)) + step;
}

BRC_FN int next_table_bit_size(const int* count, int length, int root_bits) {
  int left = 1 << (length - root_bits);
  while (length < MAX_CODE_LENGTH) {
    left -= count[length];
    if (left <= 0) break;
    length++;
    left <<= 1;
  }
  return length - root_bits;
}

// Canonical two-level table (mirrors decode/huffman.py).  `sorted_syms`
// is scratch of at least n entries.
BRC_FN int build_huffman_table(int32_t* table, int root_bits,
                               const int32_t* code_lengths, int n,
                               int32_t* sorted_syms) {
  int count[MAX_CODE_LENGTH + 1];
  int offsets[MAX_CODE_LENGTH + 2];
  for (int i = 0; i <= MAX_CODE_LENGTH; i++) count[i] = 0;
  for (int i = 0; i < n; i++) count[code_lengths[i]]++;
  offsets[0] = 0;
  offsets[1] = 0;
  for (int ln = 1; ln <= MAX_CODE_LENGTH; ln++)
    offsets[ln + 1] = offsets[ln] + count[ln];
  int num_used = offsets[MAX_CODE_LENGTH + 1];
  for (int sym = 0; sym < n; sym++) {
    int ln = code_lengths[sym];
    if (ln) sorted_syms[offsets[ln]++] = sym;
  }
  int table_size = 1 << root_bits;
  int total_size = table_size;
  if (num_used == 1) {
    for (int i = 0; i < total_size; i++) table[i] = sorted_syms[0];
    return total_size;
  }
  if (num_used == 0) {
    for (int i = 0; i < total_size; i++) table[i] = 0;
    return total_size;
  }
  int key = 0, symbol = 0, step = 1;
  for (int ln = 1; ln <= root_bits; ln++) {
    step <<= 1;
    while (count[ln] > 0) {
      int item = (ln << 16) | sorted_syms[symbol++];
      for (int pos = table_size; pos > 0;) {
        pos -= step;
        table[key + pos] = item;
      }
      key = next_key(key, ln);
      count[ln]--;
    }
  }
  int mask = total_size - 1;
  int low = -1;
  int cur_off = 0;
  int sub_size = table_size;
  for (int ln = root_bits + 1; ln <= MAX_CODE_LENGTH; ln++) {
    step <<= 1;
    while (count[ln] > 0) {
      if ((key & mask) != low) {
        cur_off += sub_size;
        int sub_bits = next_table_bit_size(count, ln, root_bits);
        sub_size = 1 << sub_bits;
        total_size += sub_size;
        low = key & mask;
        table[low] = ((sub_bits + root_bits) << 16) | (cur_off - low);
      }
      int item = ((ln - root_bits) << 16) | sorted_syms[symbol++];
      int sub_step = 1 << (ln - root_bits);
      int base = cur_off + (key >> root_bits);
      for (int pos = sub_size; pos > 0;) {
        pos -= sub_step;
        table[base + pos] = item;
      }
      key = next_key(key, ln);
      count[ln]--;
    }
  }
  return total_size;
}

BRC_FN int read_symbol(const int32_t* table, BitReader& br) {
  uint32_t v = br.peek(15);
  int slot = v & 0xFF;
  int entry = table[slot];
  int bits = entry >> 16;
  if (bits <= 8) {
    br.skip(bits);
    return entry & 0xFFFF;
  }
  slot += entry & 0xFFFF;
  entry = table[slot + ((v & ((1u << bits) - 1)) >> 8)];
  br.skip((entry >> 16) + 8);
  return entry & 0xFFFF;
}

BRC_FN int bit_length(uint32_t x) {
  int n = 0;
  while (x) { n++; x >>= 1; }
  return n;
}

BRC_FN int max_table_size(int alpha_limit) {
  // MAX_HUFFMAN_TABLE_SIZE by (alphabet+31)>>5 (huffman.py)
  const int sizes[] = {256, 402, 436, 468, 500, 534, 566, 598, 630, 662,
                       694, 726, 758, 790, 822, 854, 886, 920, 952,
                       984, 1016, 1048, 1080};
  int idx = (alpha_limit + 31) >> 5;
  if (idx > 22) idx = 22;
  return sizes[idx];
}

// Code lengths of a complex prefix code (RFC 3.5) into `code_lengths`.
BRC_FN int read_code_lengths(const int32_t* clcl, int num_symbols,
                             BitReader& br, int32_t* code_lengths,
                             int32_t* scratch) {
  for (int i = 0; i < num_symbols; i++) code_lengths[i] = 0;
  int32_t table[32];
  build_huffman_table(table, 5, clcl, 18, scratch);
  int symbol = 0, prev_len = 8, repeat = 0, repeat_len = 0;
  int space = 32768;
  while (symbol < num_symbols && space > 0) {
    int entry = table[br.peek(5)];
    br.skip(entry >> 16);
    int code_len = entry & 0xFFFF;
    if (code_len < 16) {
      repeat = 0;
      code_lengths[symbol++] = code_len;
      if (code_len) {
        prev_len = code_len;
        space -= 32768 >> code_len;
      }
    } else {
      int extra_bits = code_len - 14;
      int new_len = (code_len == 16) ? prev_len : 0;
      if (repeat_len != new_len) { repeat = 0; repeat_len = new_len; }
      int old_repeat = repeat;
      if (repeat > 0) repeat = (repeat - 2) << extra_bits;
      repeat += br.read(extra_bits) + 3;
      int delta = repeat - old_repeat;
      if (symbol + delta > num_symbols) return -2;
      for (int i = 0; i < delta; i++) code_lengths[symbol++] = repeat_len;
      if (repeat_len) space -= delta << (15 - repeat_len);
    }
  }
  if (space != 0) return -18;
  return 0;
}

// Reads one prefix code and builds its table at `table`.
BRC_FN int read_huffman_code(const Tables& T, int alpha_max, int alpha_limit,
                             int32_t* table, BitReader& br, int32_t* arena) {
  int32_t* code_lengths = arena + A_CLEN;
  int32_t* sorted = arena + A_SORTED;
  uint32_t simple_or_skip = br.read(2);
  if (simple_or_skip == 1) {
    int max_bits = bit_length(alpha_max - 1);
    int num_symbols = br.read(2) + 1;
    int symbols[4];
    for (int i = 0; i < num_symbols; i++) {
      symbols[i] = br.read(max_bits);
      if (symbols[i] >= alpha_limit) return -15;
      for (int j = 0; j < i; j++)
        if (symbols[j] == symbols[i]) return -7;
    }
    for (int i = 0; i < alpha_limit; i++) code_lengths[i] = 0;
    int shape = num_symbols;
    if (num_symbols == 4 && br.read(1)) shape = 5;
    const int L[6][4] = {{0, 0, 0, 0}, {1, 0, 0, 0}, {1, 1, 0, 0},
                         {1, 2, 2, 0}, {2, 2, 2, 2}, {1, 2, 3, 3}};
    for (int i = 0; i < num_symbols; i++) code_lengths[symbols[i]] = L[shape][i];
    build_huffman_table(table, 8, code_lengths, alpha_limit, sorted);
    return 0;
  }
  int32_t fixed[16];
  int32_t clc_lengths[6];
  for (int i = 0; i < 6; i++) clc_lengths[i] = T.clc_lengths[i];
  build_huffman_table(fixed, 4, clc_lengths, 6, sorted);
  int32_t clcl[18];
  for (int i = 0; i < 18; i++) clcl[i] = 0;
  int space = 32, num_codes = 0;
  for (int i = simple_or_skip; i < 18; i++) {
    int idx = T.clc_order[i];
    int entry = fixed[br.peek(4)];
    br.skip(entry >> 16);
    int v = entry & 0xFFFF;
    clcl[idx] = v;
    if (v) {
      space -= 32 >> v;
      num_codes++;
      if (space <= 0) break;
    }
  }
  if (space != 0 && num_codes != 1) return -4;
  int rc = read_code_lengths(clcl, alpha_limit, br, code_lengths, sorted);
  if (rc) return rc;
  build_huffman_table(table, 8, code_lengths, alpha_limit, sorted);
  return 0;
}

BRC_FN int var_len_uint8(BitReader& br) {
  if (br.read(1) == 0) return 0;
  int n = br.read(3);
  if (n == 0) return 1;
  return br.read(n) + (1 << n);
}

// Context map of `size` entries into bytes `cmap`; *num_trees set.
BRC_FN int decode_context_map(const Tables& T, int size, BitReader& br,
                              uint8_t* cmap, int* num_trees, int32_t* arena) {
  for (int i = 0; i < size; i++) cmap[i] = 0;
  *num_trees = var_len_uint8(br) + 1;
  if (*num_trees == 1) return 0;
  int use_rle = br.read(1);
  int max_run_prefix = use_rle ? br.read(4) + 1 : 0;
  int alphabet = *num_trees + max_run_prefix;
  int32_t* table = arena + A_CMTAB;
  int rc = read_huffman_code(T, alphabet, alphabet, table, br, arena);
  if (rc) return rc;
  int i = 0;
  while (i < size) {
    int code = read_symbol(table, br);
    if (code == 0) {
      i++;
    } else if (code <= max_run_prefix) {
      int64_t reps = (1ll << code) + br.read(code);
      if (i + reps > size) return -3;
      i += static_cast<int>(reps);
    } else {
      cmap[i++] = static_cast<uint8_t>(code - max_run_prefix);
    }
  }
  if (br.read(1)) {  // inverse move-to-front
    uint8_t mtf[256];
    for (int k = 0; k < 256; k++) mtf[k] = static_cast<uint8_t>(k);
    for (int k = 0; k < size; k++) {
      int idx = cmap[k];
      uint8_t v = mtf[idx];
      cmap[k] = v;
      for (int j = idx; j > 0; j--) mtf[j] = mtf[j - 1];
      mtf[0] = v;
    }
  }
  return 0;
}

BRC_FN void calc_distance_lut(int alpha_limit, int npostfix, int ndirect,
                              int32_t* extra, int32_t* offset) {
  for (int k = 0; k < 16 && k < alpha_limit; k++) { extra[k] = 0; offset[k] = 0; }
  int postfix = 1 << npostfix;
  int i = 16;
  for (int j = 0; j < ndirect && i < alpha_limit; j++, i++) {
    extra[i] = 0;
    offset[i] = j + 1;
  }
  int bits = 1, half = 0;
  while (i < alpha_limit) {
    int base = ndirect + ((((2 + half) << bits) - 4) << npostfix) + 1;
    for (int j = 0; j < postfix && i < alpha_limit; j++, i++) {
      extra[i] = bits;
      offset[i] = base + j;
    }
    bits += half;
    half ^= 1;
  }
}

// LZ copy inside the stream's own output; moves up to 16 bytes per step
// whenever the distance allows.
BRC_FN void copy_within(uint8_t* out, int64_t pos, int64_t distance,
                        int64_t length) {
  uint8_t* dst = out + pos;
  const uint8_t* src = out + pos - distance;
  if (distance >= 16) {
    int64_t k = 0;
    for (; k + 16 <= length; k += 16) {
      uint8_t t[16];
#pragma unroll
      for (int j = 0; j < 16; j++) t[j] = src[k + j];
#pragma unroll
      for (int j = 0; j < 16; j++) dst[k + j] = t[j];
    }
    for (; k < length; k++) dst[k] = src[k];
  } else {
    for (int64_t k = 0; k < length; k++) dst[k] = src[k];
  }
}

BRC_FN void uppercase_span(uint8_t* buf, int64_t start, int64_t length,
                           bool first_only) {
  int64_t off = start;
  int64_t remaining = first_only ? 1 : length;
  int64_t end = start + length;
  while (remaining > 0 && off < end) {
    uint8_t c0 = buf[off];
    if (c0 < 0xC0) {
      if (c0 >= 97 && c0 <= 122) buf[off] ^= 32;
      off += 1;
      remaining -= 1;
    } else if (c0 < 0xE0) {
      if (off + 1 < end) buf[off + 1] ^= 32;
      off += 2;
      remaining -= 2;
    } else {
      if (off + 2 < end) buf[off + 2] ^= 5;
      off += 3;
      remaining -= 3;
    }
    if (first_only) break;
  }
}

struct Metablock {
  int num_types[3];
  int64_t block_len[3];
  int btype[3];
  int btype_prev[3];
  int num_lit_trees, num_dist_trees;
  int npostfix, ndirect;
  int dist_stride;
  bool trivial_literal;
  int32_t* arena;

  BRC_FN int32_t* type_table(int c) const { return arena + A_TYPE + c * BTYPE_STRIDE; }
  BRC_FN int32_t* len_table(int c) const { return arena + A_LEN + c * BLEN_STRIDE; }
  BRC_FN uint8_t* cmap() const { return reinterpret_cast<uint8_t*>(arena + A_CMAP); }
  BRC_FN uint8_t* dist_cmap() const { return reinterpret_cast<uint8_t*>(arena + A_DCMAP); }
  BRC_FN uint8_t* modes() const { return reinterpret_cast<uint8_t*>(arena + A_MODES); }
  BRC_FN const int32_t* lit_tree(int k) const { return arena + A_TREES + k * LIT_STRIDE; }
  BRC_FN const int32_t* cmd_tree(int k) const {
    return arena + A_TREES + num_lit_trees * LIT_STRIDE + k * CMD_STRIDE;
  }
  BRC_FN const int32_t* dist_tree(int k) const {
    return arena + A_TREES + num_lit_trees * LIT_STRIDE
           + num_types[1] * CMD_STRIDE + k * dist_stride;
  }

  BRC_FN int64_t read_block_length(const Tables& T, BitReader& br, int c) {
    int code = read_symbol(len_table(c), br);
    return T.blen_offset[code] + br.read(T.blen_nbits[code]);
  }

  BRC_FN void block_switch(const Tables& T, BitReader& br, int c) {
    int sym = read_symbol(type_table(c), br);
    int64_t length = read_block_length(T, br, c);
    int bt;
    if (sym == 0) bt = btype_prev[c];
    else if (sym == 1) bt = btype[c] + 1;
    else bt = sym - 2;
    if (bt >= num_types[c]) bt -= num_types[c];
    btype_prev[c] = btype[c];
    btype[c] = bt;
    block_len[c] = length;
  }

  // Parses the metablock header after MLEN; builds every table.
  BRC_FN int init(const Tables& T, BitReader& br, bool large_window,
                  int32_t* a, int64_t arena_cap, int64_t* need) {
    arena = a;
    // The fixed region is written before the trees are sized: never past
    // a smaller arena.
    if (arena_cap < A_TREES) { *need = A_TREES; return ERR_ARENA_CAP; }
    for (int c = 0; c < 3; c++) {
      int n = var_len_uint8(br) + 1;
      num_types[c] = n;
      btype[c] = 0;
      btype_prev[c] = 1;
      if (n >= 2) {
        int rc = read_huffman_code(T, n + 2, n + 2, type_table(c), br, arena);
        if (rc) return rc;
        rc = read_huffman_code(T, 26, 26, len_table(c), br, arena);
        if (rc) return rc;
        block_len[c] = read_block_length(T, br, c);
      } else {
        block_len[c] = HUGE_BLOCK;
      }
    }
    npostfix = br.read(2);
    ndirect = br.read(4) << npostfix;
    for (int i = 0; i < num_types[0]; i++) modes()[i] = static_cast<uint8_t>(br.read(2));
    int rc = decode_context_map(T, num_types[0] << 6, br, cmap(), &num_lit_trees, arena);
    if (rc) return rc;
    trivial_literal = true;
    for (int j = 0; j < (num_types[0] << 6); j++)
      if (cmap()[j] != (j >> 6)) { trivial_literal = false; break; }
    rc = decode_context_map(T, num_types[2] << 2, br, dist_cmap(), &num_dist_trees, arena);
    if (rc) return rc;

    int dist_alpha_max = 16 + ndirect + ((2 * 24) << npostfix);
    int dist_alpha_limit = dist_alpha_max;
    if (large_window) {
      dist_alpha_max = 16 + ndirect + ((2 * 62) << npostfix);
      // calculateDistanceAlphabetLimit(0x7FFFFFFC)
      int64_t offset = ((0x7FFFFFFCll - ndirect) >> npostfix) + 4;
      int ndistbits = bit_length(static_cast<uint32_t>(offset)) - 1 - 1;
      int group = ((ndistbits - 1) << 1) | ((offset >> ndistbits) & 1);
      dist_alpha_limit = ((group - 1) << npostfix) + (1 << npostfix) + ndirect + 16;
    }
    dist_stride = max_table_size(dist_alpha_limit) + 1;
    int64_t total = A_TREES + static_cast<int64_t>(num_lit_trees) * LIT_STRIDE
                    + static_cast<int64_t>(num_types[1]) * CMD_STRIDE
                    + static_cast<int64_t>(num_dist_trees) * dist_stride;
    if (total > arena_cap) { *need = total; return ERR_ARENA_CAP; }

    for (int k = 0; k < num_lit_trees; k++) {
      rc = read_huffman_code(T, NUM_LIT, NUM_LIT,
                             const_cast<int32_t*>(lit_tree(k)), br, arena);
      if (rc) return rc;
    }
    for (int k = 0; k < num_types[1]; k++) {
      rc = read_huffman_code(T, NUM_CMD, NUM_CMD,
                             const_cast<int32_t*>(cmd_tree(k)), br, arena);
      if (rc) return rc;
    }
    for (int k = 0; k < num_dist_trees; k++) {
      rc = read_huffman_code(T, dist_alpha_max, dist_alpha_limit,
                             const_cast<int32_t*>(dist_tree(k)), br, arena);
      if (rc) return rc;
    }
    calc_distance_lut(dist_alpha_limit, npostfix, ndirect, arena + A_DEXTRA,
                      arena + A_DOFFSET);
    return 0;
  }
};

BRC_FN int read_metablock_length(BitReader& br, bool input_end, int64_t* mbl,
                                 bool* is_uncompressed, bool* is_metadata) {
  *is_uncompressed = false;
  *is_metadata = false;
  int size_nibbles = br.read(2) + 4;
  if (size_nibbles == 7) {
    *is_metadata = true;
    if (br.read(1) != 0) return -6;
    int size_bytes = br.read(2);
    if (size_bytes == 0) { *mbl = 0; return 0; }
    int64_t m = 0;
    for (int i = 0; i < size_bytes; i++) {
      uint32_t bits = br.read(8);
      if (bits == 0 && i + 1 == size_bytes && size_bytes > 1) return -8;
      m += static_cast<int64_t>(bits) << (i * 8);
    }
    *mbl = m + 1;
    return 0;
  }
  int64_t m = 0;
  for (int i = 0; i < size_nibbles; i++) {
    uint32_t bits = br.read(4);
    if (bits == 0 && i + 1 == size_nibbles && size_nibbles > 4) return -8;
    m += static_cast<int64_t>(bits) << (i * 4);
  }
  *mbl = m + 1;
  if (!input_end) *is_uncompressed = br.read(1) != 0;
  return 0;
}

BRC_FN int decode_window_bits(BitReader& br, bool large_window, int* wbits,
                              bool* is_large) {
  *is_large = false;
  if (br.read(1) == 0) { *wbits = 16; return 0; }
  int n = br.read(3);
  if (n != 0) { *wbits = 17 + n; return 0; }
  n = br.read(3);
  if (n == 0) { *wbits = 17; return 0; }
  if (n != 1) { *wbits = 8 + n; return 0; }
  if (!large_window) return -11;
  if (br.read(1) == 1) return -11;
  *wbits = br.read(6);
  if (*wbits < 10 || *wbits > 30) return -11;
  *is_large = true;
  return 0;
}

// Decodes one whole stream.  res.code is 0 on success.
BRC_FN Result decode_stream(const Tables& T, const Compound& cd,
                            const uint8_t* data, int64_t data_len,
                            bool large_window, uint8_t* out, int64_t out_cap,
                            int32_t* arena, int64_t arena_cap) {
  Result res{0, 0, 0};
  BitReader br;
  br.init(data, data_len);
  int64_t pos = 0;
  int wbits;
  bool is_large;
  int rc = decode_window_bits(br, large_window, &wbits, &is_large);
  if (rc) { res.code = rc; return res; }
  const int64_t max_backward = (1ll << wbits) - 16;
  const int64_t cd_total = cd.len;
  int64_t dist_rb[4] = {16, 15, 11, 4};
  int dist_rb_idx = 3;
  const int sidx[16] = {0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1};
  const int sdel[16] = {0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3};

  // A failed read (br.err) came first, as in the golden decoder, which
  // raises at the read itself.
#define BRC_FAIL(c) \
  do { res.code = br.err ? br.err : (c); res.out_len = pos; return res; } while (0)
  bool input_end = false;
  while (!input_end) {
    if (br.overrun()) BRC_FAIL(-10);
    input_end = br.read(1) != 0;
    if (input_end && br.read(1)) break;
    int64_t mbl;
    bool is_uncompressed, is_metadata;
    rc = read_metablock_length(br, input_end, &mbl, &is_uncompressed, &is_metadata);
    if (rc) BRC_FAIL(rc);
    if (is_metadata) {
      if ((rc = br.jump_to_byte_boundary())) BRC_FAIL(rc);
      if (br.take_bytes(mbl) < 0) BRC_FAIL(-10);
      continue;
    }
    if (mbl == 0) continue;
    if (pos + mbl > out_cap) { res.need = pos + mbl; BRC_FAIL(ERR_OUT_CAP); }
    if (is_uncompressed) {
      if ((rc = br.jump_to_byte_boundary())) BRC_FAIL(rc);
      int64_t start = br.take_bytes(mbl);
      if (start < 0) BRC_FAIL(-10);
      for (int64_t k = 0; k < mbl; k++) out[pos + k] = data[start + k];
      pos += mbl;
      continue;
    }
    const int64_t mb_end = pos + mbl;

    Metablock st;
    rc = st.init(T, br, is_large, arena, arena_cap, &res.need);
    if (rc) BRC_FAIL(rc);
    const uint8_t* cmap = st.cmap();
    const uint8_t* dist_cmap = st.dist_cmap();
    const int32_t* dist_extra = arena + A_DEXTRA;
    const int32_t* dist_offset = arena + A_DOFFSET;
    const int32_t* cmd_table = st.cmd_tree(0);
    const int32_t* lit_table = st.lit_tree(cmap[0]);
    int clo = st.modes()[0] << 9;
    int cmap_slice = 0;
    int dist_cmap_slice = 0;

    while (pos < mb_end) {
      if (br.err) BRC_FAIL(br.err);
      if (st.block_len[1] == 0) {
        st.block_switch(T, br, 1);
        cmd_table = st.cmd_tree(st.btype[1]);
      }
      st.block_len[1]--;
      int cmd = read_symbol(cmd_table, br);
      const int32_t* cl = T.cmd_lut + cmd * 4;
      int ins_code = cl[0], cp_code = cl[1];
      int64_t insert_len = T.ins_offset[ins_code] + br.read(T.ins_nbits[ins_code]);
      int64_t copy_len = T.cp_offset[cp_code] + br.read(T.cp_nbits[cp_code]);

      if (insert_len > 0) {
        // Literals past the metablock end are still decoded (not stored),
        // then fail with -9, as the golden decoder does.
        int64_t end = pos + insert_len;
        int64_t store_end = end < mb_end ? end : mb_end;
        if (st.trivial_literal) {
          while (pos < end) {
            if (st.block_len[0] == 0) {
              st.block_switch(T, br, 0);
              lit_table = st.lit_tree(cmap[st.btype[0] << 6]);
            }
            int64_t batch = end - pos;
            if (st.block_len[0] < batch) batch = st.block_len[0];
            st.block_len[0] -= batch;
            int64_t stop = pos + batch;
            for (; pos < stop; pos++) {
              int sym = read_symbol(lit_table, br);
              if (pos < store_end) out[pos] = static_cast<uint8_t>(sym);
            }
          }
        } else {
          int p1 = pos > 0 ? out[pos - 1] : 0;
          int p2 = pos > 1 ? out[pos - 2] : 0;
          while (pos < end) {
            if (st.block_len[0] == 0) {
              st.block_switch(T, br, 0);
              int bt = st.btype[0];
              cmap_slice = bt << 6;
              clo = st.modes()[bt] << 9;
            }
            int64_t batch = end - pos;
            if (st.block_len[0] < batch) batch = st.block_len[0];
            st.block_len[0] -= batch;
            int64_t stop = pos + batch;
            const int32_t* lut1 = T.context_lut + clo;
            const int32_t* lut2 = lut1 + 256;
            for (; pos < stop; pos++) {
              int ctx = lut1[p1] | lut2[p2];
              int sym = read_symbol(st.lit_tree(cmap[cmap_slice + ctx]), br);
              if (pos < store_end) out[pos] = static_cast<uint8_t>(sym);
              p2 = p1;
              p1 = sym;
            }
          }
        }
        if (pos > mb_end) BRC_FAIL(-9);
        if (pos == mb_end) break;
      }

      int64_t distance;
      int distance_code;
      if (cl[2]) {
        distance_code = -1;
        distance = dist_rb[dist_rb_idx];
      } else {
        if (st.block_len[2] == 0) {
          st.block_switch(T, br, 2);
          dist_cmap_slice = st.btype[2] << 2;
        }
        st.block_len[2]--;
        int tree_idx = dist_cmap[dist_cmap_slice + cl[3]];
        distance_code = read_symbol(st.dist_tree(tree_idx), br);
        if (distance_code < 16) {
          int idx = (dist_rb_idx - sidx[distance_code]) & 3;
          distance = dist_rb[idx] + sdel[distance_code];
          if (distance < 1) BRC_FAIL(-12);
        } else {
          int64_t bits = br.read(dist_extra[distance_code]);
          distance = dist_offset[distance_code] + (bits << st.npostfix);
        }
      }

      int64_t max_distance = pos < max_backward ? pos : max_backward;
      if (distance > max_distance) {
        if (distance > 0x7FFFFFFCll) BRC_FAIL(-9);
        int64_t address = distance - max_distance - 1 - cd_total;
        if (address < 0) {
          // compound dictionary
          int64_t cd_addr = -address - 1;
          if (cd_addr + copy_len > cd_total) BRC_FAIL(-9);
          if (pos + copy_len > mb_end) BRC_FAIL(-9);
          dist_rb_idx = (dist_rb_idx + 1) & 3;
          dist_rb[dist_rb_idx] = distance;
          for (int64_t k = 0; k < copy_len; k++) out[pos + k] = cd.data[cd_addr + k];
          pos += copy_len;
        } else {
          int64_t word_len = copy_len;
          if (word_len > 24) BRC_FAIL(-9);
          int shift = T.dict_sizebits[word_len];
          if (shift == 0) BRC_FAIL(-9);
          int64_t word_idx = address & ((1ll << shift) - 1);
          int64_t transform_idx = address >> shift;
          if (transform_idx >= T.num_transforms) BRC_FAIL(-9);
          const uint8_t* word = T.dict_data + T.dict_offsets[word_len] + word_idx * word_len;
          const int32_t* span = T.tf_spans + transform_idx * 4;
          int op = T.tf_ops[transform_idx];
          int omit_first = (op >= 12 && op <= 20) ? op - 11 : 0;
          int omit_last = (op >= 1 && op <= 9) ? op : 0;
          if (omit_first > word_len) omit_first = static_cast<int>(word_len);
          int64_t body_len = word_len - omit_first - omit_last;
          if (body_len < 0) body_len = 0;
          int64_t tlen = span[1] + body_len + span[3];
          if (pos + tlen > mb_end) BRC_FAIL(-9);
          for (int k = 0; k < span[1]; k++) out[pos++] = T.tf_storage[span[0] + k];
          int64_t body_start = pos;
          for (int64_t k = 0; k < body_len; k++) out[pos++] = word[omit_first + k];
          if (op == 10) uppercase_span(out, body_start, body_len, true);
          else if (op == 11) uppercase_span(out, body_start, body_len, false);
          for (int k = 0; k < span[3]; k++) out[pos++] = T.tf_storage[span[2] + k];
        }
        continue;
      }

      if (distance_code > 0) {
        dist_rb_idx = (dist_rb_idx + 1) & 3;
        dist_rb[dist_rb_idx] = distance;
      }
      if (pos + copy_len > mb_end) BRC_FAIL(-9);
      copy_within(out, pos, distance, copy_len);
      pos += copy_len;
    }
  }
  if ((rc = br.jump_to_byte_boundary())) BRC_FAIL(rc);
  if (br.overrun()) BRC_FAIL(-10);
  if (br.err) BRC_FAIL(br.err);
#undef BRC_FAIL
  res.out_len = pos;
  return res;
}

}  // namespace brc
