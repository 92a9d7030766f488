// Per-coordinate ballot counts of the one-bit sign channel (signmv with
// --sign-bits 1).
//
// Replaces the TPU kernel byzantine_aircomp_tpu/ops/pallas_kernels.py
// packed_vote_counts / _popcount_kernel (:457-504):
//   counts[c] = #{k : bit (c % 32) of words[k, c / 32]},  c < d
// over a [K, W = ceil(d/32)] stack of 32-bit sign words, LSB-first (the
// wire format of ops/aggregators.py pack_signs).  The words arrive as int32
// tensors with the same bits and are read as unsigned here.
//
// Bound on an H100: the words are read once (K*W*4 bytes) and the counts
// written once (d*4 bytes); the bit arithmetic is integer work far below
// the compute roof, so it is bound by bytes: 0.30 us at K=1000, W=246.  At
// 1 MB the time is launch latency and the chain of dependent steps, so the
// design keeps that chain short:
// - One launch, no memset, no atomics.  A block owns a strip of 4 word
//   columns over ALL K rows (of the two ways to avoid global atomics, this
//   one over a thread-block cluster that splits the rows and merges through
//   distributed shared memory: the strip gives 62 blocks at W=246, about
//   one per SM, so a cluster would only add a cluster barrier).  Its
//   threads split the rows, the warps' counters meet in shared memory and
//   are summed in a fixed order, and every count is written exactly once.
// - Bit-sliced vertical counters.  A thread keeps, for its word column,
//   the 32 per-bit counts as bit planes (plane i holds bit i of every
//   count) and adds a word by a carry ripple that stops when the carry is
//   0: a few logic ops per word instead of 32 shift-and-adds.  Two
//   threads' counters add as binary numbers, plane by plane (a ripple-carry
//   adder over __shfl_xor_sync); the 32 counts are read out once, at the
//   end, by one thread per count.
// - All 16 rows of a thread at K=1000 are loaded before any is added, so a
//   block has all of its 16 KB in flight at once.
// All sums are integer, so the counts are exact and the same on every run.

#include <cuda_runtime.h>

namespace packed_vote_counts {

constexpr int kStripWords = 4;                  // word columns per block
constexpr int kThreads = 256;                   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32 / kStripWords;        // rows a warp reads at once
constexpr int kGroups = kThreads / kStripWords; // rows the block reads at once
constexpr int kUnroll = 16;                     // loads in flight per thread
constexpr int kPlanes = 20;                     // counts below 2^20
constexpr unsigned kFull = 0xffffffffu;

// p += x, 32 one-bit counts at once
__device__ __forceinline__ void add_word(unsigned (&p)[kPlanes], unsigned carry) {
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    const unsigned t = p[i] & carry;
    p[i] ^= carry;
    carry = t;
    if (carry == 0) break;
  }
}

// p += the counters of lane ^ off, plane by plane with a ripple carry
__device__ __forceinline__ void add_lane(unsigned (&p)[kPlanes], int off, int nplanes) {
  unsigned carry = 0;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    if (i >= nplanes) break;  // warp-uniform: the planes above are 0
    const unsigned a = p[i];
    const unsigned o = __shfl_xor_sync(kFull, a, off);
    const unsigned s = a ^ o;
    p[i] = s ^ carry;
    carry = (a & o) | (carry & s);
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const unsigned* __restrict__ words, long long k, long long w_cnt, long long d,
             int nplanes, int* __restrict__ counts) {
  __shared__ unsigned planes[kWarps][kStripWords][kPlanes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = lane % kStripWords;
  const long long col = static_cast<long long>(blockIdx.x) * kStripWords + j;
  const long long g = warp * kSlots + lane / kStripWords;  // this thread's first row
  unsigned p[kPlanes];
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) p[i] = 0;
  if (col < w_cnt) {
    for (long long r0 = g; r0 < k; r0 += static_cast<long long>(kGroups) * kUnroll) {
      unsigned x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * kGroups;
        x[u] = r < k ? __ldg(words + r * w_cnt + col) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_word(p, x[u]);
    }
  }
  // the warp's row slots of one word column meet in lanes 0 .. kStripWords-1
#pragma unroll
  for (int off = kStripWords; off < 32; off <<= 1) add_lane(p, off, nplanes);
  if (lane < kStripWords) {
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) planes[warp][lane][i] = p[i];
  }
  __syncthreads();
  // one thread per count: word column t / 32, bit t % 32, warps in order
  const int t = threadIdx.x;
  if (t < kStripWords * 32) {
    const int wc = t / 32;
    const int bit = t % 32;
    const long long c = (static_cast<long long>(blockIdx.x) * kStripWords + wc) * 32 + bit;
    if (c < d) {
      int total = 0;  // unrolled, so the shared loads are all in flight at once
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int i = 0; i < kPlanes; ++i) {
          if (i < nplanes) total += static_cast<int>((planes[w][wc][i] >> bit) & 1u) << i;
        }
      }
      counts[c] = total;
    }
  }
}

}  // namespace packed_vote_counts

// Writes every counts[c], c < d (no zeroing beforehand).  K below 2^20.
extern "C" int packed_vote_counts_launch(const void* words, long long k,
                                         long long w_cnt, long long d,
                                         int* counts, void* stream) {
  using namespace packed_vote_counts;
  if (k < 0 || k >= (1LL << kPlanes) || w_cnt * 32 < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return 0;
  int nplanes = 0;  // bits of the largest count, K
  while (nplanes < kPlanes && (1LL << nplanes) <= k) ++nplanes;
  const unsigned blocks = static_cast<unsigned>((w_cnt + kStripWords - 1) / kStripWords);
  count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), k, w_cnt, d, nplanes, counts);
  return static_cast<int>(cudaGetLastError());
}
