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
// Bound on an H100: the kernel must read the stack once (K*d*4 bytes; with
// the channel also n_r and n_i, 3*K*d*4 bytes) and write d floats; the
// ranking is integer work far below the compute roof, so it is bound by
// bytes: 9.4 us at K=1000, d=7850 (28 us with the channel) at 3.35 TB/s.
//
// What held the first design back, and what this one does about it:
// - A bisection on the key value: 20-32 dependent column passes for a
//   median and 50-65 for a trimmed mean, each ending in a warp reduction.
//   A clock64 trace at K=50 put 92-95% of a block's time in that chain and
//   0.5-1.4 us in staging.  Now the number of passes is fixed:
//   * K <= 64: one warp per column keeps the column's keys in registers
//     (two per lane) and ranks by counting: every lane compares its keys
//     with all K keys, broadcast by __shfl_sync, and gets #(<=); the n-th
//     smallest is the least key whose #(<=) exceeds n (a warp min), and
//     its #(<) and #(==) come from two ballots.  One pass, exact under
//     ties; the trimmed mean's boundaries, their kept copies and the
//     interior sum come from the same registers.
//   * K > 64: an exact radix select on the unsigned form of the key (key ^
//     0x80000000), 8-bit digits, most significant first: 4 histogram passes
//     per rank, each a 256-bin histogram in shared memory (16-bit bins, two
//     to a word), the bin holding rank n found by a warp scan, then the
//     prefix narrowed.  The first digit's histogram is built while the keys
//     are staged, so the read and pass 1 are one sweep (each lane tallies
//     its run of equal first digits in registers: on real stacks nearly all
//     of a column's keys share it, and an atomic per key queued on one
//     word).  The trimmed mean's
//     two ranks (b and K-b-1) share each pass while their prefixes agree and
//     take their own passes after they part: at most 7 column passes, then
//     one for the interior sum.  #(<) and #(==) of each selected key fall
//     out of the scans, so the kept copies need no further pass.
//   Once a bin holds at most 64 keys, the next pass sets its candidates
//   aside in the warp's shared buffer while it sweeps, and the passes after
//   it sweep only those: on realistic stacks the second digit already
//   leaves a few dozen keys, so a median sweeps the column twice.
// - One 132 KB block per SM at K=1000 (32-column strips of [K, 33] keys)
//   and a two-wave tail.  A block now owns 16 columns: at K=1000 its keys
//   (column-major, unsigned, pitch 1004 words), histograms and candidate
//   buffers take 74 KB, so 3 blocks (48 columns) share an SM, the most its
//   shared memory holds at that K.
// - A latency-bound staging loop (one 4-byte load per lane per row, a few
//   rows in flight per warp).  Each lane now loads a column pair as one
//   8-byte load (two 4-byte loads where d is odd or a pointer is not 8-byte
//   aligned: a row of 7850 f32 starts 8 bytes off 16 on every odd row, so
//   16-byte loads, 16-byte cp.async and TMA cannot take the stack), 8 lanes
//   cover a row of the strip, and each warp has 32 rows (16 with the
//   channel) in flight.  The passes read 4 keys per 16-byte shared load.
//
// Measured on an H100 (PERF.md): 7.6-9.3 us at K=50 and 50-125 us at
// K=1000, 3.4-18x the bound.  At K=1000 the keys of all columns (31 MB)
// exceed the card's shared memory, so the 491 blocks run as 1.24 waves;
// staging reads about half the card's memory rate, and the second digit's
// pass (a full sweep with shared atomics) is the costliest of a column.
//
// Above ~3470 rows a strip's keys no longer fit shared memory: a first
// kernel writes all keys to a global scratch [K, d], and the radix select
// reads them from there with 32-bit bins.  The path follows from K
// (select_columns_plan); there is no K at which the caller switches to
// another implementation.
//
// Exactness: the channel fold is written with __fmul_rn / __fadd_rn /
// __fdiv_rn, which nvcc never contracts into an FMA, so v is bitwise the
// v of channel.oma followed by the selection.  The median is a selected
// element, bit-identical to the plain version.  The trimmed mean sums the
// strict interior of the kept band per lane in a fixed order, then across
// the warp in a fixed butterfly, and adds each boundary value times its
// kept copies (exact under ties, as _select_trimmed_mean does): the same
// bits on every rerun, no atomics on floats.
//
// Built with -DSELECT_COLUMNS_CLOCK (byzantine_aircomp_tpu_torch/tools/
// select_clock.py), each block records clock64() at its start, after
// staging and at its end, %globaltimer at its start and end, and clock64()
// around the digit passes of one radix column, into g_clock[11 * block].

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#ifdef SELECT_COLUMNS_CLOCK
constexpr int kClockBlocks = 65536;
constexpr int kClockSlots = 11;
__device__ long long g_clock[kClockSlots * kClockBlocks];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// slots 0 start, 1 staged, 2 end (clock64); 3 start, 4 end (globaltimer);
// 5 a radix column's start, 6-9 after each of its digit passes, 10 after
// its interior sum (thread 0's last column)
#define CLOCK_MARK(slot)                                                      \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {                      \
      g_clock[kClockSlots * blockIdx.x + (slot)] = clock64();                 \
      if ((slot) == 0 || (slot) == 2) {                                       \
        g_clock[kClockSlots * blockIdx.x + 3 + ((slot) == 2)] = global_ns();  \
      }                                                                       \
    }                                                                         \
  } while (0)
extern "C" int select_columns_clock_read(long long* host, long long blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_clock, static_cast<size_t>(kClockSlots * blocks) * sizeof(long long)));
}
#else
#define CLOCK_MARK(slot)
#endif

namespace select_columns {

constexpr int kStrip = 16;          // columns per block
constexpr int kThreads = 256;       // 8 warps, two columns each
constexpr int kWarps = kThreads / 32;
constexpr int kSmallK = 64;         // up to here: rank by count in registers
constexpr int kCap = 64;            // candidates a warp sets aside (a multiple of 4)
constexpr unsigned kFull = 0xffffffffu;

enum Path : int { kPathSmall = 0, kPathShared = 1, kPathGlobal = 2 };

// histogram words per column: 256 bins, 16-bit (two to a word) while K
// stays below 2^16 (the shared-memory path), else 32-bit
__host__ __device__ constexpr int hist_words(bool wide) { return wide ? 256 : 128; }

// The unsigned form of the total-order key (key ^ 0x80000000): unsigned
// order is the IEEE-754 total order.
__device__ __forceinline__ unsigned to_ukey(float v) {
  const unsigned i = __float_as_uint(v);
  return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}

__device__ __forceinline__ float from_ukey(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// pitch of a staged column in words: >= K, 4 mod 8 (so a column starts 16
// bytes aligned and a warp's staging stores spread over 16 banks)
__host__ __device__ inline long long pitch(long long k) { return (k + 3) / 8 * 8 + 4; }

// v + (h_r*n_r + h_i*n_i)/h_sq in channel.oma's op order, rounded at every
// step
__device__ __forceinline__ float fold(float v, float nr, float ni, float hr, float hi,
                                      float hs) {
  return __fadd_rn(v, __fdiv_rn(__fadd_rn(__fmul_rn(hr, nr), __fmul_rn(hi, ni)), hs));
}

struct Stack {
  const float* w;
  const float* n_r;  // the channel terms, unused without it
  const float* n_i;
  const float* h_r;
  const float* h_i;
  const float* h_sq;
  long long k;
  long long d;
};

// The received values of elements idx and idx + 1 of row r (the second
// only where `two`), as one 8-byte load of each array where `pairs`.
template <bool kChannel>
__device__ __forceinline__ void received_pair(const Stack& s, long long r, long long idx,
                                              bool pairs, bool two, float& a, float& b) {
  float2 x = make_float2(0.0f, 0.0f), nr = x, ni = x;
  if (pairs && two) {
    x = __ldg(reinterpret_cast<const float2*>(s.w + idx));
    if (kChannel) {
      nr = __ldg(reinterpret_cast<const float2*>(s.n_r + idx));
      ni = __ldg(reinterpret_cast<const float2*>(s.n_i + idx));
    }
  } else {
    x.x = __ldg(s.w + idx);
    if (kChannel) {
      nr.x = __ldg(s.n_r + idx);
      ni.x = __ldg(s.n_i + idx);
    }
    if (two) {
      x.y = __ldg(s.w + idx + 1);
      if (kChannel) {
        nr.y = __ldg(s.n_r + idx + 1);
        ni.y = __ldg(s.n_i + idx + 1);
      }
    }
  }
  a = x.x;
  b = x.y;
  if (kChannel) {
    const float hr = __ldg(s.h_r + r), hi = __ldg(s.h_i + r), hs = __ldg(s.h_sq + r);
    a = fold(a, nr.x, ni.x, hr, hi, hs);
    b = fold(b, nr.y, ni.y, hr, hi, hs);
  }
}

__device__ __forceinline__ void hist_add16(unsigned* h, unsigned digit) {
  atomicAdd(&h[digit >> 1], 1u << ((digit & 1u) * 16));
}

template <bool kWide>
__device__ __forceinline__ void hist_add(unsigned* h, unsigned digit) {
  if (kWide) {
    atomicAdd(&h[digit], 1u);
  } else {
    hist_add16(h, digit);
  }
}

// One first digit for the histogram, tallied in registers while a lane's
// run of equal digits lasts (on real stacks a column's first digits are
// nearly all equal, and an atomic per key would queue on one word).
struct Tally {
  unsigned digit = 256;
  unsigned n = 0;
  __device__ __forceinline__ void flush(unsigned* h) {
    if (n != 0) atomicAdd(&h[digit >> 1], n << ((digit & 1u) * 16));
  }
  __device__ __forceinline__ void add(unsigned* h, unsigned d) {
    if (d != digit) {
      flush(h);
      digit = d;
      n = 0;
    }
    ++n;
  }
};

// Stage the strip's keys column-major (column c at skeys + c * pitch) and,
// with `hist`, the first digit's histogram of every column.  Lane l loads
// the column pair 2*(l % 8) of row 4*warp + l/8 (+ 32 per unrolled step).
template <bool kChannel>
__device__ void stage(const Stack& s, long long col0, int ncols, bool pairs, long long p,
                      unsigned* skeys, unsigned* hist) {
  constexpr int kUnroll = kChannel ? 4 : 8;  // warp loads in flight
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = 2 * (lane & 7);
  if (c >= ncols) return;
  const bool two = c + 1 < ncols;
  unsigned* col_a = skeys + c * p;
  unsigned* col_b = col_a + p;
  unsigned* h_a = hist == nullptr ? nullptr : hist + c * hist_words(false);
  unsigned* h_b = hist == nullptr ? nullptr : h_a + hist_words(false);
  Tally tally_a, tally_b;
  for (long long r0 = warp * 4 + (lane >> 3); r0 < s.k; r0 += kWarps * 4 * kUnroll) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * kWarps * 4;
      if (r < s.k) received_pair<kChannel>(s, r, r * s.d + col0 + c, pairs, two, a[u], b[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * kWarps * 4;
      if (r < s.k) {
        const unsigned ua = to_ukey(a[u]), ub = to_ukey(b[u]);
        col_a[r] = ua;
        if (hist != nullptr) tally_a.add(h_a, ua >> 24);
        if (two) {
          col_b[r] = ub;
          if (hist != nullptr) tally_b.add(h_b, ub >> 24);
        }
      }
    }
  }
  if (hist != nullptr) {
    tally_a.flush(h_a);
    tally_b.flush(h_b);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Kept copies of a boundary key: entries equal to it occupy the rank run
// [#(< key), #(<= key) - 1], clipped to the kept band [b, K - b - 1].
__device__ __forceinline__ long long kept_copies(long long n_lt, long long n_le,
                                                 long long b, long long last) {
  const long long run = min(n_le - 1, last) - max(n_lt, b) + 1;
  return run > 0 ? run : 0;
}

// The trimmed mean from the interior sum and the two boundary keys with
// their #(<) and #(<=).  Only where copies exist: 0 * Inf and 0 * NaN stay
// out of the sum.
__device__ __forceinline__ float trimmed_total(float interior, unsigned lo, long long lt_lo,
                                               long long le_lo, unsigned hi, long long lt_hi,
                                               long long le_hi, long long k, long long b) {
  const long long last = k - b - 1;
  float total = interior;
  const long long c_lo = kept_copies(lt_lo, le_lo, b, last);
  if (c_lo > 0) total += static_cast<float>(c_lo) * from_ukey(lo);
  if (lo != hi) {
    const long long c_hi = kept_copies(lt_hi, le_hi, b, last);
    if (c_hi > 0) total += static_cast<float>(c_hi) * from_ukey(hi);
  }
  return total / static_cast<float>(k - 2 * b);
}

// ---------------------------------------------------------------------------
// K <= 64: rank by count, two keys per lane

struct Ranked {
  unsigned key;
  int lt;
  int le;
};

// The n-th smallest key of the column: the least key with #(<=) > n.
// With `counts`, also its #(<) and #(<=).  Every lane returns it.
__device__ __forceinline__ Ranked pick(int n, unsigned ka, unsigned kb, bool has_a, bool has_b,
                                       int le_a, int le_b, bool counts) {
  const unsigned ca = has_a && le_a > n ? ka : 0xffffffffu;
  const unsigned cb = has_b && le_b > n ? kb : 0xffffffffu;
  const unsigned key = __reduce_min_sync(kFull, min(ca, cb));
  Ranked out{key, 0, 0};
  if (counts) {
    out.lt = __popc(__ballot_sync(kFull, has_a && ka < key)) +
             __popc(__ballot_sync(kFull, has_b && kb < key));
    out.le = out.lt + __popc(__ballot_sync(kFull, has_a && ka == key)) +
             __popc(__ballot_sync(kFull, has_b && kb == key));
  }
  return out;
}

__device__ void small_column(const unsigned* col, int k, long long b, int want_mean, int lane,
                             float* out_c) {
  const bool has_a = lane < k;
  const bool has_b = lane + 32 < k;
  const unsigned ka = has_a ? col[lane] : 0u;
  const unsigned kb = has_b ? col[lane + 32] : 0u;
  int le_a = 0, le_b = 0;
  if (k <= 32) {
#pragma unroll 4
    for (int j = 0; j < k; ++j) le_a += __shfl_sync(kFull, ka, j) <= ka;
  } else {
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const unsigned x = __shfl_sync(kFull, ka, j);
      le_a += x <= ka;
      le_b += x <= kb;
    }
#pragma unroll 4
    for (int j = 32; j < k; ++j) {
      const unsigned x = __shfl_sync(kFull, kb, j - 32);
      le_a += x <= ka;
      le_b += x <= kb;
    }
  }
  if (!want_mean) {
    const Ranked m = pick((k - 1) / 2, ka, kb, has_a, has_b, le_a, le_b, false);
    if (lane == 0) *out_c = from_ukey(m.key);
    return;
  }
  const Ranked lo = pick(static_cast<int>(b), ka, kb, has_a, has_b, le_a, le_b, true);
  const Ranked hi = pick(static_cast<int>(k - b - 1), ka, kb, has_a, has_b, le_a, le_b, true);
  float interior = 0.0f;
  if (has_a && ka > lo.key && ka < hi.key) interior += from_ukey(ka);
  if (has_b && kb > lo.key && kb < hi.key) interior += from_ukey(kb);
  interior = warp_sum(interior);
  if (lane == 0) {
    *out_c = trimmed_total(interior, lo.key, lo.lt, lo.le, hi.key, hi.lt, hi.le, k, b);
  }
}

// ---------------------------------------------------------------------------
// K > 64: radix select, 8-bit digits, most significant first

// Keys in shared memory (a staged column or a warp's candidates), 16-byte
// aligned and readable up to a multiple of 4.
struct SharedKeys {
  const unsigned* s;
  __device__ __forceinline__ uint4 get4(int i, int) const {
    return reinterpret_cast<const uint4*>(s)[i];
  }
};

// A column of the [K, d] global scratch of keys.
struct GlobalKeys {
  const unsigned* g;  // the column's first key
  long long d;
  __device__ __forceinline__ uint4 get4(int i, int n) const {
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = 4LL * i + e;
      v[e] = r < n ? g[r * d] : 0u;
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// One rank's search: the candidates are the keys whose bits above `shift`
// + 8 equal the prefix's; n is the rank among them, below the number of
// keys under every candidate, eq the number of candidates.
struct Target {
  unsigned prefix;
  int n;
  int below;
  int eq;
};

__device__ __forceinline__ bool matches(unsigned u, unsigned prefix, int shift) {
  return shift >= 24 || (u >> (shift + 8)) == (prefix >> (shift + 8));
}

// Add the digit at `shift` of every candidate among the n keys into the
// histogram; with `buf`, also write the candidates there, in a fixed order.
template <bool kWide, class Keys>
__device__ void sweep(const Keys& keys, int n, int lane, unsigned* h, unsigned prefix,
                      int shift, unsigned* buf) {
  const int groups = (n + 3) / 4;
  int base = 0;
  for (int i0 = 0; i0 < groups; i0 += 32) {
    const int i = i0 + lane;
    const uint4 v = i < groups ? keys.get4(i, n) : make_uint4(0, 0, 0, 0);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = i < groups && 4 * i + e < n && matches(u[e], prefix, shift);
      if (in) hist_add<kWide>(h, (u[e] >> shift) & 0xffu);
      if (buf != nullptr) {
        const unsigned m = __ballot_sync(kFull, in);
        if (in) buf[base + __popc(m & ((1u << lane) - 1u))] = u[e];
        base += __popc(m);
      }
    }
  }
  __syncwarp();
}

// Read (and zero) the lane's 8 bins, 8*lane .. 8*lane + 7, and scan them
// over the warp: excl is the count in the bins below the lane's.
template <bool kWide>
__device__ __forceinline__ void read_hist(unsigned* h, int lane, unsigned (&cnt)[8],
                                          int& excl) {
  if (kWide) {
    uint4* v = reinterpret_cast<uint4*>(h) + 2 * lane;
    const uint4 a = v[0], b = v[1];
    v[0] = make_uint4(0, 0, 0, 0);
    v[1] = make_uint4(0, 0, 0, 0);
    cnt[0] = a.x; cnt[1] = a.y; cnt[2] = a.z; cnt[3] = a.w;
    cnt[4] = b.x; cnt[5] = b.y; cnt[6] = b.z; cnt[7] = b.w;
  } else {
    uint4* v = reinterpret_cast<uint4*>(h) + lane;
    const uint4 a = *v;
    *v = make_uint4(0, 0, 0, 0);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cnt[2 * i] = w[i] & 0xffffu;
      cnt[2 * i + 1] = w[i] >> 16;
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += static_cast<int>(cnt[j]);
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  excl = incl - sum;
  __syncwarp();  // every lane has read and zeroed before the next sweep adds
}

// Narrow t to the bin that holds its rank.
__device__ __forceinline__ void take_bin(const unsigned (&cnt)[8], int excl, int lane,
                                         Target& t, int shift) {
  int acc = excl, below = 0, eq = 0;
  int bin = 0;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = static_cast<int>(cnt[j]);
    if (!found && acc + c > t.n) {
      found = true;
      bin = 8 * lane + j;
      below = acc;
      eq = c;
    }
    acc += c;
  }
  const int src = __ffs(__ballot_sync(kFull, found && excl <= t.n)) - 1;
  bin = __shfl_sync(kFull, bin, src);
  below = __shfl_sync(kFull, below, src);
  eq = __shfl_sync(kFull, eq, src);
  t.n -= below;
  t.below += below;
  t.eq = eq;
  t.prefix |= static_cast<unsigned>(bin) << shift;
}

// One digit pass of t: its candidates are swept from buf where they are
// all there (held), else from the column, and set aside into buf on the
// way when they fit (then held).
template <bool kWide, class Keys>
__device__ __forceinline__ void digit_pass(const Keys& col, int k, unsigned* h, unsigned* buf,
                                           int lane, int shift, const Target& t, bool& held,
                                           int& held_n) {
  if (held) {
    sweep<kWide>(SharedKeys{buf}, held_n, lane, h, t.prefix, shift, nullptr);
  } else if (t.eq <= kCap) {
    sweep<kWide>(col, k, lane, h, t.prefix, shift, buf);
    held = true;
    held_n = t.eq;
  } else {
    sweep<kWide>(col, k, lane, h, t.prefix, shift, nullptr);
  }
}

// t's remaining passes, from `pass` on, after the two ranks parted.
template <bool kWide, class Keys>
__device__ void finish(const Keys& col, int k, unsigned* h, unsigned* buf, int lane, int pass,
                       Target& t, bool held, int held_n) {
  for (; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    digit_pass<kWide>(col, k, h, buf, lane, shift, t, held, held_n);
    unsigned cnt[8];
    int excl;
    read_hist<kWide>(h, lane, cnt, excl);
    take_bin(cnt, excl, lane, t, shift);
  }
}

// Resolve a (and, with `two`, b) in 4 digit passes each.  With `prebuilt`
// the first pass's histogram is already in h (built while staging).
template <bool kWide, class Keys>
__device__ void radix_select(const Keys& col, int k, bool prebuilt, unsigned* h, unsigned* buf,
                             int lane, Target& a, Target& b, bool two) {
  bool held = false;  // buf holds every candidate of the shared prefix
  int held_n = 0;
  bool split = false;
  int pass = 0;
  for (; pass < 4 && !split; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0 || !prebuilt) digit_pass<kWide>(col, k, h, buf, lane, shift, a, held, held_n);
    unsigned cnt[8];
    int excl;
    read_hist<kWide>(h, lane, cnt, excl);
    take_bin(cnt, excl, lane, a, shift);
    if (two) {
      take_bin(cnt, excl, lane, b, shift);
      split = a.prefix != b.prefix;
    }
    CLOCK_MARK(6 + pass);
  }
  if (split) {
    // a set-aside shared candidate set serves both; else each sets aside
    // its own in turn
    finish<kWide>(col, k, h, buf, lane, pass, a, held, held_n);
    finish<kWide>(col, k, h, buf, lane, pass, b, held, held_n);
  }
}

template <bool kWide, class Keys>
__device__ void radix_column(const Keys& col, int k, long long b, int want_mean, bool prebuilt,
                             unsigned* h, unsigned* buf, int lane, float* out_c) {
  Target lo{0u, static_cast<int>(want_mean ? b : (k - 1) / 2), 0, k};
  Target hi{0u, static_cast<int>(k - b - 1), 0, k};
  CLOCK_MARK(5);
  radix_select<kWide>(col, k, prebuilt, h, buf, lane, lo, hi, want_mean != 0);
  if (!want_mean) {
    if (lane == 0) *out_c = from_ukey(lo.prefix);
    return;
  }
  float interior = 0.0f;
  const int groups = (k + 3) / 4;
  for (int i = lane; i < groups; i += 32) {
    const uint4 v = col.get4(i, k);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * i + e < k && u[e] > lo.prefix && u[e] < hi.prefix) interior += from_ukey(u[e]);
    }
  }
  interior = warp_sum(interior);
  CLOCK_MARK(10);
  if (lane == 0) {
    *out_c = trimmed_total(interior, lo.prefix, lo.below, lo.below + lo.eq, hi.prefix,
                           hi.below, hi.below + hi.eq, k, b);
  }
}

// ---------------------------------------------------------------------------
// kernels

// The keys of the whole received stack, for stacks whose strip of keys does
// not fit shared memory.
template <bool kChannel>
__global__ void __launch_bounds__(256) keys_kernel(Stack s, unsigned* __restrict__ keys) {
  const long long n = s.k * s.d;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < n;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = s.w[idx];
    if (kChannel) {
      const long long r = idx / s.d;
      v = fold(v, s.n_r[idx], s.n_i[idx], s.h_r[r], s.h_i[r], s.h_sq[r]);
    }
    keys[idx] = to_ukey(v);
  }
}

template <bool kChannel, int kPath>
__global__ void __launch_bounds__(kThreads)
select_kernel(Stack s, const unsigned* __restrict__ gkeys, long long b, int want_mean,
              int pairs, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long col0 = static_cast<long long>(blockIdx.x) * kStrip;
  const int ncols = static_cast<int>(min(static_cast<long long>(kStrip), s.d - col0));
  const long long p = pitch(s.k);
  const int k = static_cast<int>(s.k);
  CLOCK_MARK(0);
  if constexpr (kPath == kPathSmall) {
    stage<kChannel>(s, col0, ncols, pairs != 0, p, smem, nullptr);
    __syncthreads();
    CLOCK_MARK(1);
    for (int c = warp; c < ncols; c += kWarps) {
      small_column(smem + c * p, k, b, want_mean, lane, out + col0 + c);
    }
  } else {
    // shared path: keys [kStrip][p] | histograms | candidates [kWarps][kCap];
    // global path: histograms | candidates
    constexpr bool kWide = kPath == kPathGlobal;
    unsigned* hist = kWide ? smem : smem + kStrip * p;
    unsigned* buf = hist + kStrip * hist_words(kWide) + warp * kCap;
    for (int i = threadIdx.x; i < kStrip * hist_words(kWide); i += kThreads) hist[i] = 0;
    __syncthreads();
    if constexpr (!kWide) stage<kChannel>(s, col0, ncols, pairs != 0, p, smem, hist);
    __syncthreads();
    CLOCK_MARK(1);
    for (int c = warp; c < ncols; c += kWarps) {
      unsigned* h = hist + c * hist_words(kWide);
      if constexpr (kWide) {
        radix_column<true>(GlobalKeys{gkeys + col0 + c, s.d}, k, b, want_mean, false, h, buf,
                           lane, out + col0 + c);
      } else {
        radix_column<false>(SharedKeys{smem + c * p}, k, b, want_mean, true, h, buf, lane,
                            out + col0 + c);
      }
    }
  }
#ifdef SELECT_COLUMNS_CLOCK
  __syncthreads();
  CLOCK_MARK(2);
#endif
}

long long shared_bytes(int path, long long k) {
  const long long keys = kStrip * pitch(k) * 4;
  const long long cands = kWarps * kCap * 4;
  if (path == kPathSmall) return keys;
  if (path == kPathShared) return keys + kStrip * hist_words(false) * 4 + cands;
  return kStrip * hist_words(true) * 4 + cands;
}

template <bool kChannel>
const void* kernel_of(int path) {
  if (path == kPathSmall) {
    return reinterpret_cast<const void*>(select_kernel<kChannel, kPathSmall>);
  }
  if (path == kPathShared) {
    return reinterpret_cast<const void*>(select_kernel<kChannel, kPathShared>);
  }
  return reinterpret_cast<const void*>(select_kernel<kChannel, kPathGlobal>);
}

// The dynamic shared memory each path's kernels may use, per device, as
// raised by select_columns_plan.  Internal linkage: a second build of this
// source loaded into the same process keeps its own.
constexpr int kMaxDevices = 64;
static long long g_allowed[kMaxDevices][3] = {};

template <bool kChannel>
cudaError_t launch(const Stack& s, long long b, int want_mean, int path, unsigned* scratch,
                   float* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((s.d + kStrip - 1) / kStrip);
  const size_t smem = static_cast<size_t>(shared_bytes(path, s.k));
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 7u) == 0;
  };
  const int pairs =
      s.d % 2 == 0 && aligned(s.w) && (!kChannel || (aligned(s.n_r) && aligned(s.n_i)));
  if (s.k > INT_MAX) return cudaErrorInvalidValue;
  if (path == kPathSmall) {
    if (s.k > kSmallK) return cudaErrorInvalidValue;
    select_kernel<kChannel, kPathSmall><<<blocks, kThreads, smem, stream>>>(
        s, nullptr, b, want_mean, pairs, out);
  } else if (path == kPathShared) {
    if (s.k >= (1LL << 16)) return cudaErrorInvalidValue;  // 16-bit bins
    select_kernel<kChannel, kPathShared><<<blocks, kThreads, smem, stream>>>(
        s, nullptr, b, want_mean, pairs, out);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const long long n = s.k * s.d;
    const long long want_blocks = (n + 255) / 256;
    const unsigned key_blocks =
        static_cast<unsigned>(want_blocks < (1LL << 20) ? want_blocks : (1LL << 20));
    keys_kernel<kChannel><<<key_blocks, 256, 0, stream>>>(s, scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    select_kernel<kChannel, kPathGlobal><<<blocks, kThreads, smem, stream>>>(
        s, scratch, b, want_mean, pairs, out);
  }
  return cudaGetLastError();
}

}  // namespace select_columns

// The launch configuration for a stack of K rows and d columns on the
// current device, and the one-time setup it needs (the kernels' dynamic
// shared memory cap, raised here and never inside a launch):
//   plan[0] path (0: K <= 64, keys in registers; 1: keys in shared memory;
//           2: keys in a global scratch), plan[1] columns per block,
//   plan[2] threads per block, plan[3] dynamic shared bytes per block,
//   plan[4] global scratch bytes (K*d*4 on path 2, else 0),
//   plan[5] / plan[6] resident blocks per SM without / with the channel,
//   plan[7] blocks in the grid.
// Returns 0 or a CUDA error code.
extern "C" int select_columns_plan(long long k, long long d, long long* plan) {
  using namespace select_columns;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int path = kPathGlobal;
  if (k <= kSmallK) {
    path = kPathSmall;
  } else if (shared_bytes(kPathShared, k) <= limit) {
    path = kPathShared;
  }
  const long long smem = shared_bytes(path, k);
  const void* fns[2] = {kernel_of<false>(path), kernel_of<true>(path)};
  if (smem > g_allowed[dev][path]) {
    for (const void* fn : fns) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    g_allowed[dev][path] = smem;
  }
  int per_sm[2] = {0, 0};
  for (int ch = 0; ch < 2; ++ch) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[ch], fns[ch], kThreads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plan[0] = path;
  plan[1] = kStrip;
  plan[2] = kThreads;
  plan[3] = smem;
  plan[4] = path == kPathGlobal ? k * d * 4 : 0;
  plan[5] = per_sm[0];
  plan[6] = per_sm[1];
  plan[7] = (d + kStrip - 1) / kStrip;
  return 0;
}

// want_mean = 0: out[j] = the lower-middle median of column j; b unused.
// want_mean = 1: out[j] = the b-trimmed mean of column j (K - 2b >= 1).
// n_r == nullptr: no channel fold (n_i, h_r, h_i, h_sq unused).
// path: plan[0] of select_columns_plan(k, d) on this device, which must
// have run first; scratch: plan[4] bytes on path 2, else unused.  Makes no
// CUDA call but the launches and cudaGetLastError.
extern "C" int select_columns_launch(const float* w, const float* n_r,
                                     const float* n_i, const float* h_r,
                                     const float* h_i, const float* h_sq,
                                     long long k, long long d, long long b,
                                     int want_mean, int path, void* scratch, float* out,
                                     void* stream) {
  const select_columns::Stack s{w, n_r, n_i, h_r, h_i, h_sq, k, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* keys = static_cast<unsigned*>(scratch);
  const cudaError_t err =
      n_r != nullptr
          ? select_columns::launch<true>(s, b, want_mean, path, keys, out, st)
          : select_columns::launch<false>(s, b, want_mean, path, keys, out, st);
  return static_cast<int>(err);
}
