// GAScore puts for Hopper (sm_90a): one copy kernel, three destination maps.
//
// Replaces three TPU kernels of src/repro/kernels/gascore.py, each one
// remote DMA per rank (pltpu.make_async_remote_copy + DMA semaphores):
//   ring_shift  (:67, body :75)  rank r's row lands on rank (r + k) % n;
//   perm_put    (:100, body :118) rank r's row lands on rank dst[r];
//   offset_put  (:147, body :172) rank r's data lands in rank (r + k) % n's
//                                 segment row at a sender-chosen byte offset,
//                                 in place (input_output_aliases={2: 0}).
// On one H100 every rank's partition lies in the same HBM, so a "remote"
// DMA is a copy inside one rank-stacked tensor, and all n ranks' puts are
// one launch: blockIdx.y is the sending rank, blockIdx.x strides over its
// row. There are no semaphores: the launch's end on the stream is the
// receive-complete event.
//
// Bound: bytes. Each rank's row is read once and written once, no
// arithmetic; the least time is 2 * n * row_bytes / 3.35 TB/s. What this
// design does about it: raw words, never floats, so int32 command words
// bitcast into an f32 carrier (NaN patterns included) arrive bit for bit;
// 16-byte vector loads and stores when every row, pointer and offset is
// 16-byte aligned (else 4-, 2- or 1-byte words, chosen by the wrapper);
// enough CTAs per rank to fill the 132 SMs, each with a grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 256;

// Destination row of sender r, and the word offset inside it.
struct RankMap {
  int dst[kMaxRanks];
  long long dst_word_off[kMaxRanks];
};

template <typename W>
__global__ void put_kernel(const W* __restrict__ src, W* __restrict__ dst,
                           long long src_row_words, long long dst_row_words,
                           long long copy_words, RankMap map) {
  const int r = blockIdx.y;
  const W* s = src + (long long)r * src_row_words;
  W* d = dst + (long long)map.dst[r] * dst_row_words + map.dst_word_off[r];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < copy_words; i += stride) {
    d[i] = s[i];
  }
}

template <typename W>
int launch(const void* src, void* dst, long long src_row_bytes,
           long long dst_row_bytes, long long copy_bytes, int n,
           const RankMap& map, int sms, cudaStream_t stream) {
  const long long words = copy_bytes / (long long)sizeof(W);
  long long want = (words + kThreads - 1) / kThreads;
  long long cap = (4LL * sms + n - 1) / n;  // ~4 CTAs per SM over all ranks
  if (cap < 1) cap = 1;
  const int bx = (int)(want < cap ? (want < 1 ? 1 : want) : cap);
  dim3 grid(bx, n);
  put_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst),
      src_row_bytes / (long long)sizeof(W),
      dst_row_bytes / (long long)sizeof(W), words, map);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Copy row r of src (n rows of src_row_bytes) to row dst_rank[r] of dst
// (rows of dst_row_bytes) at byte offset dst_byte_off[r]; copy_bytes per
// row. word_bytes (16, 4, 2 or 1) must divide every row size, offset and
// both base pointers' alignment: the wrapper checks. Returns the CUDA error
// of the launch (0 on success).
int repro_gascore_put(const void* src, void* dst, int n,
                      long long src_row_bytes, long long dst_row_bytes,
                      long long copy_bytes, const int* dst_rank,
                      const long long* dst_byte_off, int word_bytes,
                      int sms, void* stream) {
  if (n < 1 || n > kMaxRanks) return (int)cudaErrorInvalidValue;
  RankMap map;
  for (int r = 0; r < n; ++r) {
    map.dst[r] = dst_rank[r];
    map.dst_word_off[r] = dst_byte_off[r] / word_bytes;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16:
      return launch<uint4>(src, dst, src_row_bytes, dst_row_bytes, copy_bytes,
                           n, map, sms, s);
    case 4:
      return launch<uint32_t>(src, dst, src_row_bytes, dst_row_bytes,
                              copy_bytes, n, map, sms, s);
    case 2:
      return launch<uint16_t>(src, dst, src_row_bytes, dst_row_bytes,
                              copy_bytes, n, map, sms, s);
    case 1:
      return launch<uint8_t>(src, dst, src_row_bytes, dst_row_bytes,
                             copy_bytes, n, map, sms, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
