// Batched Brotli decode as an XLA FFI custom call.
//
// One lane = one stream.  Inputs are flat: the concatenated compressed
// streams with (n+1) byte offsets, and (n+1) offsets into the flat output
// and arena buffers, which fix each lane's output capacity and table arena.
// Each lane decodes into its own output region, which also serves as its LZ
// history (brotli_core.h).  status[i] = (code, out_len, need).  Offsets
// and status are int32: one launch addresses under 2 GiB of each buffer.
//
// The same source builds two handlers:
//   * nvcc (CUDA): one GPU thread per lane, one warp per block;
//   * g++ -x c++ (host): the lanes decoded in a loop on the CPU.  This is the
//     build the CPU tests call; it runs the identical per-lane code.

#include <cstdint>
#include <string>

#include "brotli_core.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct Batch {
  brc::Tables T;
  brc::Compound cd;
  const uint8_t* in;
  const int32_t* in_off;
  uint8_t* out;
  const int32_t* out_off;
  int32_t* arena;
  const int32_t* arena_off;
  int32_t* status;
  int64_t n_lanes;
  bool large_window;
};

BRC_FN void decode_lane(const Batch& b, int64_t i) {
  brc::Result r = brc::decode_stream(
      b.T, b.cd, b.in + b.in_off[i], b.in_off[i + 1] - b.in_off[i],
      b.large_window, b.out + b.out_off[i], b.out_off[i + 1] - b.out_off[i],
      b.arena + b.arena_off[i], b.arena_off[i + 1] - b.arena_off[i]);
  b.status[3 * i + 0] = r.code;
  b.status[3 * i + 1] = static_cast<int32_t>(r.out_len);
  b.status[3 * i + 2] = static_cast<int32_t>(r.need);
}

ffi::Error make_batch(ffi::Buffer<ffi::U8> in, ffi::Buffer<ffi::S32> in_off,
                      ffi::Buffer<ffi::S32> out_off,
                      ffi::Buffer<ffi::S32> arena_off,
                      ffi::Buffer<ffi::S32> tables, ffi::Buffer<ffi::U8> dict,
                      ffi::Buffer<ffi::U8> tf_storage, ffi::Buffer<ffi::U8> cd,
                      int64_t cd_len, int64_t large_window,
                      ffi::ResultBuffer<ffi::U8> out,
                      ffi::ResultBuffer<ffi::S32> status,
                      ffi::ResultBuffer<ffi::S32> arena, Batch* b) {
  int64_t n = static_cast<int64_t>(in_off.element_count()) - 1;
  if (n < 0 || out_off.element_count() != in_off.element_count() ||
      arena_off.element_count() != in_off.element_count() ||
      status->element_count() != static_cast<size_t>(3 * n)) {
    return ffi::Error::InvalidArgument("brotli_decode_batch: lane shapes");
  }
  if (tables.element_count() < static_cast<size_t>(brc::P_TOTAL)) {
    return ffi::Error::InvalidArgument("brotli_decode_batch: tables");
  }
  b->T = brc::make_tables(tables.typed_data(), dict.typed_data(),
                          tf_storage.typed_data());
  b->cd = brc::Compound{cd.typed_data(), cd_len};
  b->in = in.typed_data();
  b->in_off = in_off.typed_data();
  b->out = out->typed_data();
  b->out_off = out_off.typed_data();
  b->arena = arena->typed_data();
  b->arena_off = arena_off.typed_data();
  b->status = status->typed_data();
  b->n_lanes = n;
  b->large_window = large_window != 0;
  return ffi::Error::Success();
}

#define BRC_FFI_SIGNATURE                               \
      .Arg<ffi::Buffer<ffi::U8>>()                      \
      .Arg<ffi::Buffer<ffi::S32>>()                     \
      .Arg<ffi::Buffer<ffi::S32>>()                     \
      .Arg<ffi::Buffer<ffi::S32>>()                     \
      .Arg<ffi::Buffer<ffi::S32>>()                     \
      .Arg<ffi::Buffer<ffi::U8>>()                      \
      .Arg<ffi::Buffer<ffi::U8>>()                      \
      .Arg<ffi::Buffer<ffi::U8>>()                      \
      .Attr<int64_t>("cd_len")                          \
      .Attr<int64_t>("large_window")                    \
      .Ret<ffi::Buffer<ffi::U8>>()                      \
      .Ret<ffi::Buffer<ffi::S32>>()                     \
      .Ret<ffi::Buffer<ffi::S32>>()

#if defined(__CUDACC__)

__global__ void decode_kernel(Batch b) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < b.n_lanes) decode_lane(b, i);
}

ffi::Error decode_cuda(cudaStream_t stream, ffi::Buffer<ffi::U8> in,
                       ffi::Buffer<ffi::S32> in_off,
                       ffi::Buffer<ffi::S32> out_off,
                       ffi::Buffer<ffi::S32> arena_off,
                       ffi::Buffer<ffi::S32> tables, ffi::Buffer<ffi::U8> dict,
                       ffi::Buffer<ffi::U8> tf_storage, ffi::Buffer<ffi::U8> cd,
                       int64_t cd_len, int64_t large_window,
                       ffi::ResultBuffer<ffi::U8> out,
                       ffi::ResultBuffer<ffi::S32> status,
                       ffi::ResultBuffer<ffi::S32> arena) {
  Batch b;
  ffi::Error err = make_batch(in, in_off, out_off, arena_off, tables, dict,
                              tf_storage, cd, cd_len, large_window, out,
                              status, arena, &b);
  if (err.failure()) return err;
  if (b.n_lanes == 0) return ffi::Error::Success();
  // One warp per block spreads a few thousand lanes over every SM.
  constexpr int kThreads = 32;
  int blocks = static_cast<int>((b.n_lanes + kThreads - 1) / kThreads);
  decode_kernel<<<blocks, kThreads, 0, stream>>>(b);
  cudaError_t last = cudaGetLastError();
  if (last != cudaSuccess) {
    return ffi::Error::Internal(std::string("brotli_decode_batch launch: ") +
                                cudaGetErrorString(last));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BrotliDecodeBatch, decode_cuda,
    ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>() BRC_FFI_SIGNATURE);

#else

ffi::Error decode_host(ffi::Buffer<ffi::U8> in, ffi::Buffer<ffi::S32> in_off,
                       ffi::Buffer<ffi::S32> out_off,
                       ffi::Buffer<ffi::S32> arena_off,
                       ffi::Buffer<ffi::S32> tables, ffi::Buffer<ffi::U8> dict,
                       ffi::Buffer<ffi::U8> tf_storage, ffi::Buffer<ffi::U8> cd,
                       int64_t cd_len, int64_t large_window,
                       ffi::ResultBuffer<ffi::U8> out,
                       ffi::ResultBuffer<ffi::S32> status,
                       ffi::ResultBuffer<ffi::S32> arena) {
  Batch b;
  ffi::Error err = make_batch(in, in_off, out_off, arena_off, tables, dict,
                              tf_storage, cd, cd_len, large_window, out,
                              status, arena, &b);
  if (err.failure()) return err;
  for (int64_t i = 0; i < b.n_lanes; i++) decode_lane(b, i);
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BrotliDecodeBatch, decode_host,
                              ffi::Ffi::Bind() BRC_FFI_SIGNATURE);

#endif
