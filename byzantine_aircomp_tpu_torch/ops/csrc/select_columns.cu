// Coordinatewise median and b-trimmed mean of a [K, d] f32 client stack,
// with the OMA channel optionally folded into the read (the median and
// trimmed_mean aggregators, with and without --var).
//
// Replaces the TPU kernel byzantine_aircomp_tpu/ops/pallas_kernels.py
// fused_median / fused_trimmed_mean -> _select_call / _select_kernel
// (:315-417):
//   received   v = w + ((h_r * n_r + h_i * n_i) / h_sq)   (channel fold only)
//   key        IEEE-754 total-order int32 key of v (-0.0 < +0.0, positive
//              NaN above +Inf; a negative NaN ranks below -Inf, the same
//              caveat as total_order_keys, pallas_kernels.py:268-271)
//   median     the value of sorted[(K - 1) / 2], the lower middle
//   trimmed    mean of sorted[b .. K - b - 1], K - 2b >= 1
//
// The TPU kernel peels maxima one row at a time over a [Kp, 128] VMEM tile.
// Here each column's order statistics are found by bisection on the key
// value: every step counts the keys <= mid, so the answer is the exact
// n-th smallest key, equal bit for bit to sorting the column.  The search
// starts from the column's min and max keys and stops once lo == hi.
//
// Layout: one block owns a strip of 32 adjacent columns.  Its warps read
// the strip row by row (a warp reads 32 neighbouring floats of one row, so
// the loads coalesce), turn each value into its key and stage the [K, 32]
// keys in dynamic shared memory with a row pitch of 33 words, so that a
// warp walking one column down the rows hits 32 different banks.  Then
// each warp selects its columns: a pass over the column is one key per
// lane per 32 rows and one warp reduction.  When [K, 33] keys do not fit
// the block's shared memory (K above ~1760 on an H100), a first kernel
// writes all keys to a global scratch [K, d] and the same selection reads
// them from there (L2-resident at the sizes this repo runs): there is no K
// above which the caller switches to another implementation.
//
// Exactness: the channel fold is written with __fmul_rn / __fadd_rn /
// __fdiv_rn, which nvcc never contracts into an FMA, so v is bitwise the
// v of channel.oma followed by the selection.  The median is a selected
// element, bit-identical to the plain version.  The trimmed mean sums the
// strict interior of the kept band per lane in row order, then across the
// warp in a fixed butterfly, and adds each boundary value times its kept
// copies (exact under ties, as _select_trimmed_mean does): same bits on
// every rerun, no atomics.
//
// Bound on an H100: the kernel must read the stack once (K*d*4 bytes; with
// the channel also n_r and n_i, 3*K*d*4 bytes) and write d floats; the
// comparisons are integer work far below the compute roof, so it is bound
// by bytes: 9.4 us at K=1000, d=7850 (28 us with the channel) at 3.35 TB/s.
// This design reads the stack once; its passes over the staged keys run
// from shared memory.

#include <climits>
#include <cuda_runtime.h>

namespace select_columns {

constexpr int kStrip = 32;          // columns per block
constexpr int kThreads = 512;       // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kStrip + 1;  // shared row pitch in words
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int to_key(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? (~i) + INT_MIN : i;
}

__device__ __forceinline__ float from_key(int key) {
  return __int_as_float(key < 0 ? ~(key - INT_MIN) : key);
}

// The received value of element idx (row r): the stack entry, plus the OMA
// residual (h_r*n_r + h_i*n_i)/h_sq in channel.oma's op order, rounded at
// every step.
template <bool kChannel>
__device__ __forceinline__ float received(
    const float* __restrict__ w, const float* __restrict__ n_r,
    const float* __restrict__ n_i, const float* __restrict__ h_r,
    const float* __restrict__ h_i, const float* __restrict__ h_sq,
    long long r, long long idx) {
  float v = w[idx];
  if (kChannel) {
    const float re = __fmul_rn(h_r[r], n_r[idx]);
    const float im = __fmul_rn(h_i[r], n_i[idx]);
    v = __fadd_rn(v, __fdiv_rn(__fadd_rn(re, im), h_sq[r]));
  }
  return v;
}

struct SharedKeys {
  const int* s;
  __device__ __forceinline__ int operator()(long long r, int c) const {
    return s[r * kPitch + c];
  }
};

struct GlobalKeys {
  const int* g;
  long long d;
  long long col0;
  __device__ __forceinline__ int operator()(long long r, int c) const {
    return g[r * d + col0 + c];
  }
};

// The n-th smallest (0-indexed) key of column c, given that it lies in
// [lo, hi].  Every lane returns it.
template <class Keys>
__device__ int nth_key(const Keys& keys, long long k, int c, long long n,
                       int lo, int hi, int lane) {
  while (lo < hi) {
    // floor((lo + hi) / 2) without overflow (>> on int is arithmetic)
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
    for (long long r = lane; r < k; r += 32) cnt += keys(r, c) <= mid;
    cnt = __reduce_add_sync(kFull, cnt);
    if (cnt <= n) {
      lo = mid + 1;  // fewer than n + 1 keys at or below mid
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Kept copies of a boundary key: entries equal to it occupy the rank run
// [#(< key), #(<= key) - 1], clipped to the kept band [b, K - b - 1].
__device__ __forceinline__ long long kept_copies(int n_lt, int n_le,
                                                 long long b, long long last) {
  const long long run = min(static_cast<long long>(n_le) - 1, last) -
                        max(static_cast<long long>(n_lt), b) + 1;
  return run > 0 ? run : 0;
}

// One warp: the median (want_mean = 0) or b-trimmed mean of column c.
template <class Keys>
__device__ void select_column(const Keys& keys, long long k, long long b,
                              int want_mean, int c, int lane, float* out_c) {
  int mn = INT_MAX;
  int mx = INT_MIN;
  for (long long r = lane; r < k; r += 32) {
    const int x = keys(r, c);
    mn = min(mn, x);
    mx = max(mx, x);
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if (!want_mean) {
    const int key = nth_key(keys, k, c, (k - 1) / 2, mn, mx, lane);
    if (lane == 0) *out_c = from_key(key);
    return;
  }
  const long long last = k - b - 1;
  const int lo_k = nth_key(keys, k, c, b, mn, mx, lane);
  const int hi_k = nth_key(keys, k, c, last, lo_k, mx, lane);
  float interior = 0.0f;
  int lt_lo = 0, le_lo = 0, lt_hi = 0, le_hi = 0;
  for (long long r = lane; r < k; r += 32) {
    const int x = keys(r, c);
    if (x > lo_k && x < hi_k) interior += from_key(x);
    lt_lo += x < lo_k;
    le_lo += x <= lo_k;
    lt_hi += x < hi_k;
    le_hi += x <= hi_k;
  }
  interior = warp_sum(interior);
  lt_lo = __reduce_add_sync(kFull, lt_lo);
  le_lo = __reduce_add_sync(kFull, le_lo);
  lt_hi = __reduce_add_sync(kFull, lt_hi);
  le_hi = __reduce_add_sync(kFull, le_hi);
  if (lane != 0) return;
  float total = interior;
  // only where copies exist: 0 * Inf and 0 * NaN stay out of the sum
  const long long c_lo = kept_copies(lt_lo, le_lo, b, last);
  if (c_lo > 0) total += static_cast<float>(c_lo) * from_key(lo_k);
  if (lo_k != hi_k) {
    const long long c_hi = kept_copies(lt_hi, le_hi, b, last);
    if (c_hi > 0) total += static_cast<float>(c_hi) * from_key(hi_k);
  }
  *out_c = total / static_cast<float>(k - 2 * b);
}

// The keys of the whole received stack, for stacks whose strip of keys
// does not fit shared memory.
template <bool kChannel>
__global__ void __launch_bounds__(256)
keys_kernel(const float* __restrict__ w, const float* __restrict__ n_r,
            const float* __restrict__ n_i, const float* __restrict__ h_r,
            const float* __restrict__ h_i, const float* __restrict__ h_sq,
            long long k, long long d, int* __restrict__ keys) {
  const long long n = k * d;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    keys[idx] = to_key(received<kChannel>(w, n_r, n_i, h_r, h_i, h_sq, idx / d, idx));
  }
}

template <bool kChannel, bool kShared>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ w, const float* __restrict__ n_r,
              const float* __restrict__ n_i, const float* __restrict__ h_r,
              const float* __restrict__ h_i, const float* __restrict__ h_sq,
              const int* __restrict__ gkeys, long long k, long long d,
              long long b, int want_mean, float* __restrict__ out) {
  extern __shared__ int skeys[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long col0 = static_cast<long long>(blockIdx.x) * kStrip;
  const int ncols = static_cast<int>(min(static_cast<long long>(kStrip), d - col0));
  if constexpr (kShared) {
    if (lane < ncols) {
      for (long long r = warp; r < k; r += kWarps) {
        skeys[r * kPitch + lane] = to_key(
            received<kChannel>(w, n_r, n_i, h_r, h_i, h_sq, r, r * d + col0 + lane));
      }
    }
    __syncthreads();
    const SharedKeys keys{skeys};
    for (int c = warp; c < ncols; c += kWarps) {
      select_column(keys, k, b, want_mean, c, lane, out + col0 + c);
    }
  } else {
    const GlobalKeys keys{gkeys, d, col0};
    for (int c = warp; c < ncols; c += kWarps) {
      select_column(keys, k, b, want_mean, c, lane, out + col0 + c);
    }
  }
}

long long shared_bytes(long long k) {
  return k * kPitch * static_cast<long long>(sizeof(int));
}

cudaError_t max_shared_bytes(long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = 0;
  err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = v;
  return err;
}

template <bool kChannel>
cudaError_t launch(const float* w, const float* n_r, const float* n_i,
                   const float* h_r, const float* h_i, const float* h_sq,
                   long long k, long long d, long long b, int want_mean,
                   int* scratch, float* out, cudaStream_t stream) {
  long long limit = 0;
  cudaError_t err = max_shared_bytes(&limit);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((d + kStrip - 1) / kStrip);
  const long long smem = shared_bytes(k);
  if (smem <= limit) {
    // raise the kernel's dynamic shared memory cap once per device (and
    // again only for a larger K), so a launch inside a CUDA-graph capture
    // makes no attribute call
    constexpr int kMaxDevices = 64;
    static long long cap[kMaxDevices] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || smem > cap[dev]) {
      err = cudaFuncSetAttribute(select_kernel<kChannel, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) cap[dev] = smem;
    }
    select_kernel<kChannel, true><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
        w, n_r, n_i, h_r, h_i, h_sq, nullptr, k, d, b, want_mean, out);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const long long n = k * d;
  const long long want_blocks = (n + 255) / 256;
  const unsigned key_blocks =
      static_cast<unsigned>(want_blocks < (1LL << 20) ? want_blocks : (1LL << 20));
  keys_kernel<kChannel><<<key_blocks, 256, 0, stream>>>(
      w, n_r, n_i, h_r, h_i, h_sq, k, d, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_kernel<kChannel, false><<<blocks, kThreads, 0, stream>>>(
      w, n_r, n_i, h_r, h_i, h_sq, scratch, k, d, b, want_mean, out);
  return cudaGetLastError();
}

}  // namespace select_columns

// Bytes of global scratch (int32 keys [K, d]) the launch needs for a stack
// of K rows and d columns: 0 when a strip's keys fit shared memory, else
// K*d*4.  Negative on a CUDA error (its code, negated).
extern "C" long long select_columns_scratch_bytes(long long k, long long d) {
  long long limit = 0;
  const cudaError_t err = select_columns::max_shared_bytes(&limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return select_columns::shared_bytes(k) <= limit ? 0 : k * d * 4;
}

// want_mean = 0: out[j] = the lower-middle median of column j; b unused.
// want_mean = 1: out[j] = the b-trimmed mean of column j (K - 2b >= 1).
// n_r == nullptr: no channel fold (n_i, h_r, h_i, h_sq unused).
extern "C" int select_columns_launch(const float* w, const float* n_r,
                                     const float* n_i, const float* h_r,
                                     const float* h_i, const float* h_sq,
                                     long long k, long long d, long long b,
                                     int want_mean, int* scratch, float* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n_r != nullptr
          ? select_columns::launch<true>(w, n_r, n_i, h_r, h_i, h_sq, k, d, b,
                                         want_mean, scratch, out, s)
          : select_columns::launch<false>(w, n_r, n_i, h_r, h_i, h_sq, k, d, b,
                                          want_mean, scratch, out, s);
  return static_cast<int>(err);
}
