// Host entry point of the Brotli decoder core (brotli_core.h), loaded with
// ctypes by brotli_tpu/native/__init__.py.  All format constants and the
// static dictionary are passed in from Python, so there is a single source
// of truth (brotli_tpu/constants.py + data/).

#include <cstdint>

#include "brotli_core.h"

extern "C" {

// Decodes one stream with the shared core (brotli_core.h).  Returns 0 or a
// negative brotli error code; ERR_OUT_CAP / ERR_ARENA_CAP (-1000 / -1001)
// set *out_len_or_need to the size required and ask the caller to retry.
int brotli_core_decode(const uint8_t* data, int64_t data_len,
                       const int32_t* packed_tables, const uint8_t* dict_data,
                       const uint8_t* tf_storage, const uint8_t* cd_data,
                       int64_t cd_len, int32_t large_window, uint8_t* out,
                       int64_t out_cap, int32_t* arena, int64_t arena_cap,
                       int64_t* out_len_or_need) {
  brc::Tables T = brc::make_tables(packed_tables, dict_data, tf_storage);
  brc::Compound cd{cd_data, cd_len};
  brc::Result r = brc::decode_stream(T, cd, data, data_len, large_window != 0,
                                     out, out_cap, arena, arena_cap);
  *out_len_or_need = (r.code == brc::ERR_OUT_CAP || r.code == brc::ERR_ARENA_CAP)
                         ? r.need : r.out_len;
  return r.code;
}

}  // extern "C"
