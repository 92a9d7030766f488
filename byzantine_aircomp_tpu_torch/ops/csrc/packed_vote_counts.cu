// Per-coordinate ballot counts of the one-bit sign channel (signmv with
// --sign-bits 1).
//
// Replaces the TPU kernel byzantine_aircomp_tpu/ops/pallas_kernels.py
// packed_vote_counts / _popcount_kernel (:457-504):
//   counts[c] = #{k : bit (c % 32) of words[k, c / 32]},  c < d
// over a [K, W = ceil(d/32)] stack of 32-bit sign words, LSB-first (the
// wire format of ops/aggregators.py pack_signs).  The words arrive as int32
// tensors with the same bits and are read as unsigned here, so the shift
// below is logical.
//
// Layout: a block owns a strip of 32 word columns (one per lane, so each
// row's 32 words are one coalesced 128-byte read) and a slice of 64 rows,
// split over its 8 warps.  Each lane keeps 32 counters in registers, one per
// bit of its word column; the warps' counters meet in shared memory
// (pitch 33, so the 32 lanes of a warp hit 32 different banks) and the
// block adds its [32 words x 32 bits] counts into counts[] in coordinate
// order (c = word*32 + bit), so no transpose follows.  All sums are
// integer, so the atomics give the same bits in any order.  Padding bits
// past d are counted but never written.
//
// Bound on an H100: the words are read once (K*W*4 bytes) and the counts
// written once (d*4 bytes); the bit arithmetic is integer work far below
// the compute roof, so it is bound by bytes: 0.30 us at K=1000, W=246.

#include <cuda_runtime.h>

namespace packed_vote_counts {

constexpr int kBits = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;
constexpr int kPitch = kBits + 1;

__global__ void __launch_bounds__(kThreads)
count_kernel(const unsigned* __restrict__ words, long long k, long long w_cnt,
             long long d, int* __restrict__ counts) {
  __shared__ int strip[32 * kPitch];  // [word in strip][bit], pitch 33
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 32 * kPitch; i += kThreads) strip[i] = 0;
  __syncthreads();

  const long long col = static_cast<long long>(blockIdx.x) * 32 + lane;
  const long long r0 = static_cast<long long>(blockIdx.y) * kRowsPerBlock;
  const long long r1 = r0 + kRowsPerBlock < k ? r0 + kRowsPerBlock : k;
  int cnt[kBits];
#pragma unroll
  for (int j = 0; j < kBits; ++j) cnt[j] = 0;
  if (col < w_cnt) {
    for (long long r = r0 + warp; r < r1; r += kWarps) {
      const unsigned word = words[r * w_cnt + col];
#pragma unroll
      for (int j = 0; j < kBits; ++j) cnt[j] += static_cast<int>((word >> j) & 1u);
    }
  }
#pragma unroll
  for (int j = 0; j < kBits; ++j) {
    if (cnt[j] != 0) atomicAdd(&strip[lane * kPitch + j], cnt[j]);
  }
  __syncthreads();

  // strip entry i = (word i / 32, bit i % 32) is coordinate blockIdx.x*1024 + i
  for (int i = threadIdx.x; i < 32 * kBits; i += kThreads) {
    const long long c = static_cast<long long>(blockIdx.x) * 32 * kBits + i;
    const int v = strip[(i / kBits) * kPitch + (i % kBits)];
    if (c < d && v != 0) atomicAdd(&counts[c], v);
  }
}

}  // namespace packed_vote_counts

// counts [d] int32 is zeroed here (on the stream) before the blocks add
// into it.
extern "C" int packed_vote_counts_launch(const void* words, long long k,
                                         long long w_cnt, long long d,
                                         int* counts, void* stream) {
  using namespace packed_vote_counts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, static_cast<size_t>(d) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0) return 0;
  const dim3 grid(static_cast<unsigned>((w_cnt + 31) / 32),
                  static_cast<unsigned>((k + kRowsPerBlock - 1) / kRowsPerBlock));
  count_kernel<<<grid, kThreads, 0, s>>>(static_cast<const unsigned*>(words), k,
                                         w_cnt, d, counts);
  return static_cast<int>(cudaGetLastError());
}
