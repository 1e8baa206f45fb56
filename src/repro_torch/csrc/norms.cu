// RMSNorm and LayerNorm for Hopper (sm_90a), plain C interface.
//
// Replaces: _rmsnorm_kernel, src/repro/kernels/norms.py:32 (pallas_call at
// :44), and _layernorm_kernel, :92 (pallas_call at :105): the Pallas TPU
// kernels the reference's kernel mode runs on every norm of a layer (and
// on qwen3's q and k heads).
//
// Computes, for x (rows, d) of f32 or bf16 with rows x_stride elements
// apart, gamma and beta (d,) of x's dtype, every value in f32:
//   RMSNorm:   var = sum(x^2) / d;  y = x * rsqrt(var + eps) * gamma
//   LayerNorm: mu = sum(x) / d;  xc = x - mu;  var = sum(xc^2) / d;
//              y = xc * rsqrt(var + eps) * gamma + beta
// each output rounded once to x's dtype; out is contiguous (rows, d).
//
// These are the operations of the Triton kernels these replaced (deleted
// since; PERF.md keeps their times), rounding for rounding, and the sums in
// the same order, so that the two gave the same bits (chip_smoke.py held
// every path launch to that).  From their PTX and SASS (triton 3.6,
// sm_90a):
//
// * Layout.  A Triton program holds BLOCK_R rows of BLOCK_D = next_pow2(d)
//   columns; each thread holds V consecutive columns (V from Triton's
//   divisibility-by-16 view of the pointers and row strides), repeated
//   every V * L columns, where the row is spread over L = lanes * warps
//   threads.  norms.block_plan derives V, lanes and warps as Triton does;
//   this kernel takes them as they are.  A lane's E = BLOCK_D / L elements
//   are its register order: the V of a repetition, then the next one.
// * A lane's sum, in that order: LayerNorm's sum(x) is e0 + e1 + ... + e(E-1)
//   by adds; a sum of squares is fma(e0, e0, e1 * e1) (LLVM contracts the
//   first add into the first square, keeping e1 * e1 as its addend), then
//   fma(ek, ek, acc) for k = 2, ...  Columns past d (masked) hold +0.0 and
//   are summed like the rest.
// * Across a row's lanes of one warp: a shfl.sync.bfly butterfly, offsets
//   lanes / 2 down to 1, acc + other.  Across its warps (warps > 1):
//   Triton writes each warp's sum to shared memory and runs the same
//   butterfly over `warps` lanes: for 4 warps (p0 + p2) + (p1 + p3), for 8
//   ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).
// * var = div.rn.f32(sum, (float)d); r = rsqrt.approx.ftz.f32(var + eps);
//   RMSNorm's y = (x * r) * gamma, two products; LayerNorm's xc = x - mu
//   (0 on a masked column) and y = fma(xc * r, gamma, beta).  The intrinsics
//   below spell each of these, so nvcc cannot contract them otherwise.
// * The cast: cvt.rn.bf16.f32.
//
// Bound on this card: the bytes.  x read once, out written once: 8.4 MB at
// qwen3's (16384, 128) bf16 qk-norm rows, 2.5 us at 3.35 TB/s; 25.2 MB at
// nemotron's (1024, 6144) prefill, 7.5 us.  A decode step's rows (4 of 2048
// or 6144, 64 of 128) move 16-48 KB: their time is latency, an empty
// kernel's launch (0.8-1.0 us in a graph replay) plus the kernel's own
// critical path.  The Triton kernels load gamma (and beta) after the row
// reduction, whose cross-warp exchange ends in a barrier, so their path
// holds two dependent memory round trips, and each cross-warp exchange
// two barriers.  Here:
//
// * Loads first.  Every thread issues its 16-byte loads of x, gamma and
//   beta before any arithmetic: one round trip.
// * One barrier per cross-warp exchange.  Each warp's lane 0 writes its
//   partial sum; after the barrier every thread adds the row's partials
//   itself, in the butterfly's order above, instead of one warp adding
//   them and a second barrier handing the result out.  A row inside one
//   warp (d = 128: 16 lanes) takes no barrier at all.
// * The paths' layouts fixed at compile time.  With V 16 bytes' worth,
//   Triton's layout is a function of BLOCK_D alone, so norm_fixed takes
//   lanes, warps, E and the block's threads as constants: no run-time
//   layout arithmetic, unrolled butterflies, no cross-warp code for a row
//   in one warp.  The same kernel with the layout read at run time issued
//   some 30 % more instructions and ran 5-15 % slower than Triton at
//   prefill (PERF.md).  norm_any takes every other operand (any V, one
//   element a load).
// * LayerNorm's gamma and beta early where the grid is small.  A grid of
//   at most one block an SM (a decode step's rows) is latency: they load
//   with x.  A larger grid is throughput: they load after the reductions,
//   as in the Triton kernel, and take no registers through them (the
//   wrapper's plan picks; the bits are the same).  RMSNorm's gamma always
//   loads with x: late was no faster at any path operand.
// * A block runs rows side by side, 128 threads at least, one row a
//   thread; giving a thread 2 or 4 rows' loads in flight was slower or no
//   faster at every path operand (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;  // a block's threads
constexpr int kMaxSlots = 64;     // rows x warps partial sums a block
constexpr unsigned kFull = 0xffffffffu;

// refusals of the C entry points, negative so they never meet a cudaError_t
constexpr int kBadDtype = -2;
constexpr int kBadShape = -3;
constexpr int kBadPlan = -4;

struct Args {
  const void* x;
  const void* g;
  const void* b;
  void* out;
  long long rows, stride;
  int d;
  int vec;    // V: a lane's consecutive columns
  int lanes;  // a row's lanes in one warp
  int warps;  // a row's warps
  int vlog, llog, wlog;  // their log2
  float eps;
};

__device__ __forceinline__ float rsqrt_approx_ftz(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A row's values held as loaded, 16 bytes a word (8 bf16 or 4 f32), and
// read out as f32 where the arithmetic needs them.
template <typename T, int N>
struct Packed {
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kWords = (N + kV - 1) / kV;
  uint4 w[kWords];

  // the 32-bit word holding element e
  __device__ __forceinline__ unsigned& word(int e) {
    uint4& u = w[e / kV];
    switch ((e % kV) * sizeof(T) / 4) {
      case 0: return u.x;
      case 1: return u.y;
      case 2: return u.z;
      default: return u.w;
    }
  }
  __device__ __forceinline__ unsigned word(int e) const {
    const uint4& u = w[e / kV];
    switch ((e % kV) * sizeof(T) / 4) {
      case 0: return u.x;
      case 1: return u.y;
      case 2: return u.z;
      default: return u.w;
    }
  }
  // element e as f32
  __device__ __forceinline__ float operator[](int e) const {
    if constexpr (std::is_same_v<T, float>)
      return __uint_as_float(word(e));
    else
      return __uint_as_float(e % 2 ? word(e) & 0xffff0000u : word(e) << 16);
  }
  // element e from one load of T
  __device__ __forceinline__ void load(int e, const T* p) {
    if constexpr (std::is_same_v<T, float>) {
      word(e) = __float_as_uint(*p);
    } else {
      const unsigned h = __bfloat16_as_ushort(*p);
      word(e) = e % 2 ? (word(e) & 0xffffu) | (h << 16)
                      : (word(e) & 0xffff0000u) | h;
    }
  }
};

// the lane's E values of a row, at columns col(e); past d (or on an
// invalid row) 0.  kFast: every 16-byte chunk whole and aligned, loaded
// with one 16-byte load each, issued back to back (predicated, no branch);
// else one element a load
template <typename T, int E, bool kFast, typename Col>
__device__ __forceinline__ void load_row(Packed<T, E>& v, const T* src,
                                         Col col, int d, bool valid) {
  constexpr int kV = 16 / sizeof(T);
  if constexpr (kFast) {
#pragma unroll
    for (int k = 0; k < Packed<T, E>::kWords; ++k) {
      const int c = col(k * kV);
      v.w[k] = valid && c < d ? *reinterpret_cast<const uint4*>(src + c)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < Packed<T, E>::kWords; ++k)
      v.w[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (valid && col(e) < d) v.load(e, src + col(e));
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same_v<T, float>) {
      w[k] = __float_as_uint(f[k]);
    } else {
      w[k] = static_cast<unsigned>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(
                  __float2bfloat16_rn(f[2 * k + 1]))) << 16);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// a lane's sum of squares in Triton's order: fma(e0, e0, e1 * e1), then
// fma(ek, ek, acc)
template <int E>
__device__ __forceinline__ float lane_squares(const float* v) {
  if constexpr (E == 1) {
    return __fmul_rn(v[0], v[0]);
  } else {
    float acc = __fmaf_rn(v[0], v[0], __fmul_rn(v[1], v[1]));
#pragma unroll
    for (int e = 2; e < E; ++e) acc = __fmaf_rn(v[e], v[e], acc);
    return acc;
  }
}

// a lane's sum in Triton's order: e0 + e1 + ... by adds
template <int E>
__device__ __forceinline__ float lane_sum(const float* v) {
  float acc = v[0];
#pragma unroll
  for (int e = 1; e < E; ++e) acc = __fadd_rn(acc, v[e]);
  return acc;
}

// the butterfly of Triton's cross-warp step over n partials, lane 0's value
__device__ __forceinline__ float warp_tree(const float* p, int n) {
  if (n == 2) return __fadd_rn(p[0], p[1]);
  if (n == 4) return __fadd_rn(__fadd_rn(p[0], p[2]), __fadd_rn(p[1], p[3]));
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[4]), __fadd_rn(p[2], p[6])),
                   __fadd_rn(__fadd_rn(p[1], p[5]), __fadd_rn(p[3], p[7])));
}

// A row's layout: V consecutive columns a lane, `lanes` lanes of a warp
// and `warps` warps a row, at run time (Any: every operand) or fixed at
// compile time (Fixed: a 16-byte-vector layout, which Triton's layout rule
// gives as a function of BLOCK_D alone, so the kernel for the paths'
// operands carries no run-time layout arithmetic).
struct AnyLayout {
  int v, vlog, lanes, llog, warps, wlog;
  __device__ __forceinline__ int vec() const { return v; }
  __device__ __forceinline__ int vec_log() const { return vlog; }
  __device__ __forceinline__ int row_lanes() const { return lanes; }
  __device__ __forceinline__ int lanes_log() const { return llog; }
  __device__ __forceinline__ int row_warps() const { return warps; }
  __device__ __forceinline__ int warps_log() const { return wlog; }
};

constexpr int clog2(int n) { return n <= 1 ? 0 : 1 + clog2(n / 2); }

// Triton's layout of a BLOCK_D of 2^kLogD at V = 16 bytes' worth: a row
// over min(32 * num_warps, BLOCK_D / V) threads, lanes first, num_warps 8
// past 2048 columns (a program of one row), else 4
template <typename T, int kLogD>
struct FixedLayout {
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kD = 1 << kLogD;
  static constexpr int kNumWarps = kD > 2048 ? 8 : 4;
  static constexpr int kRow = kD / kV < 32 * kNumWarps ? kD / kV
                                                       : 32 * kNumWarps;
  static constexpr int kLanes = kRow < 32 ? kRow : 32;
  static constexpr int kWarps = kRow / kLanes;
  static constexpr int kElems = kD / kRow;
  static constexpr int kThreads = kRow > 128 ? kRow : 128;
  static constexpr int kVLog = clog2(kV), kLLog = clog2(kLanes),
                       kWLog = clog2(kWarps);
  __device__ __forceinline__ static constexpr int vec() { return kV; }
  __device__ __forceinline__ static constexpr int vec_log() { return kVLog; }
  __device__ __forceinline__ static constexpr int row_lanes() { return kLanes; }
  __device__ __forceinline__ static constexpr int lanes_log() { return kLLog; }
  __device__ __forceinline__ static constexpr int row_warps() { return kWarps; }
  __device__ __forceinline__ static constexpr int warps_log() { return kWLog; }
};

// a row's total from its lanes' sums: the in-warp butterfly, then (warps
// > 1) one barrier and the cross-warp tree from shared memory (`part`:
// the block's rows x warps partial sums)
template <typename L>
__device__ __forceinline__ float row_total(float acc, float* part,
                                           const L& l, int slot, int wr,
                                           int ln) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < l.row_lanes())
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
  if (l.row_warps() == 1) return acc;
  if (ln == 0) part[slot * l.row_warps() + wr] = acc;
  __syncthreads();
  return warp_tree(part + slot * l.row_warps(), l.row_warps());
}

// One block: rows side by side, lanes * warps threads each, row s of the
// block at blockIdx.x * (blockDim.x / (lanes * warps)) + s.  kFast: V is
// 16 bytes' worth and x, gamma, beta and out are 16-byte aligned with d a
// multiple of V (16-byte loads and stores); else any V, one element a
// load and a store.  kEarly: gamma and beta load with x, else after the
// reductions.
template <typename T, int E, bool kFast, bool kEarly, bool kLN, typename L>
__device__ __forceinline__ void norm_row(const Args& a, const L& l) {
  __shared__ float part[2][kMaxSlots];
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* b = static_cast<const T*>(a.b);
  T* out = static_cast<T*>(a.out);

  constexpr int kV = 16 / sizeof(T);
  const int V = l.vec(), vlog = l.vec_log();
  const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
  int q, slot, wr;  // lane index in the row, row in the block, warp in row
  if (l.row_warps() > 1) {
    wr = w & (l.row_warps() - 1);
    q = (wr << 5) + ln;
    slot = w >> l.warps_log();
  } else {
    wr = 0;
    q = ln & (l.row_lanes() - 1);
    slot = (w << (5 - l.lanes_log())) + (ln >> l.lanes_log());
  }
  const int c0 = q * V, step = V << (l.lanes_log() + l.warps_log());
  const auto col = [&](int e) {
    return c0 + (e >> vlog) * step + (e & (V - 1));
  };
  // column e lies in the row (kFast: d is a multiple of V, so a chunk is
  // in or out as a whole)
  const auto in_row = [&](int e) {
    return (kFast ? col(e & ~(kV - 1)) : col(e)) < a.d;
  };
  const int groups = blockDim.x >> (l.lanes_log() + l.warps_log());
  const long long row = static_cast<long long>(blockIdx.x) * groups + slot;
  const bool valid = row < a.rows;

  Packed<T, E> xs, gs, bs;
  load_row<T, E, kFast>(xs, x + (valid ? row : 0) * a.stride, col, a.d,
                        valid);
  if constexpr (kEarly) {
    load_row<T, E, kFast>(gs, g, col, a.d, true);
    if constexpr (kLN) load_row<T, E, kFast>(bs, b, col, a.d, true);
  }

  // x as f32 (0 past d), then LayerNorm's xc = x - mu (0 past d)
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = xs[e];
  if constexpr (kLN) {
    const float mu = __fdiv_rn(row_total(lane_sum<E>(v), part[0], l, slot,
                                         wr, ln),
                               static_cast<float>(a.d));
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = in_row(e) ? __fsub_rn(v[e], mu) : 0.f;
  }
  const float var = __fdiv_rn(
      row_total(lane_squares<E>(v), part[1], l, slot, wr, ln),
      static_cast<float>(a.d));
  if constexpr (!kEarly) {
    load_row<T, E, kFast>(gs, g, col, a.d, true);
    if constexpr (kLN) load_row<T, E, kFast>(bs, b, col, a.d, true);
  }
  if (!valid) return;
  const float r = rsqrt_approx_ftz(__fadd_rn(var, a.eps));
  // y = (x * r) * gamma, or fma(xc * r, gamma, beta)
  const auto y = [&](int e) {
    const float t = __fmul_rn(v[e], r);
    if constexpr (kLN)
      return __fmaf_rn(t, gs[e], bs[e]);
    else
      return __fmul_rn(t, gs[e]);
  };
  T* dst = out + row * a.d;
  if constexpr (kFast) {
#pragma unroll
    for (int k = 0; k < E / kV; ++k) {
      if (!in_row(k * kV)) continue;
      float f[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) f[j] = y(k * kV + j);
      store16<T>(dst + col(k * kV), f);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (in_row(e)) put(dst + col(e), y(e));
  }
}

// the paths' operands: Triton's 16-byte-vector layout of BLOCK_D =
// 2^kLogD, fixed; x, gamma, beta and out 16-byte aligned, d a multiple of
// the vector
template <typename T, int kLogD, bool kEarly, bool kLN>
__global__ void __launch_bounds__(FixedLayout<T, kLogD>::kThreads)
    norm_fixed(const Args a) {
  using L = FixedLayout<T, kLogD>;
  norm_row<T, L::kElems, true, kEarly, kLN>(a, L());
}

// every other operand: any layout, one element a load and a store, E
// elements a lane
template <typename T, int E, bool kLN>
__global__ void __launch_bounds__(kMaxThreads) norm_any(const Args a) {
  const AnyLayout l{a.vec, a.vlog, a.lanes, a.llog, a.warps, a.wlog};
  norm_row<T, E, false, true, kLN>(a, l);
}

// the fixed kernel of BLOCK_D = 2^log_d (128 to 16384) for the plan's
// layout and threads, LayerNorm's gamma and beta early or late (RMSNorm's
// gamma always early: late was no faster at any path operand); false where
// there is none
template <typename T, bool kLN>
bool launch_fixed(int log_d, bool early, const Args& a, int threads,
                  int blocks, cudaStream_t st, cudaError_t* err) {
#define NORM_FIXED(n)                                                    \
  if (log_d == n) {                                                      \
    using L = FixedLayout<T, n>;                                         \
    if (threads != L::kThreads || a.lanes != L::kLanes ||                \
        a.warps != L::kWarps)                                            \
      return false;                                                      \
    if constexpr (kLN) {                                                 \
      if (!early) {                                                      \
        norm_fixed<T, n, false, kLN><<<blocks, threads, 0, st>>>(a);     \
        *err = cudaGetLastError();                                       \
        return true;                                                     \
      }                                                                  \
    }                                                                    \
    norm_fixed<T, n, true, kLN><<<blocks, threads, 0, st>>>(a);          \
    *err = cudaGetLastError();                                           \
    return true;                                                         \
  }
  NORM_FIXED(7) NORM_FIXED(8) NORM_FIXED(9) NORM_FIXED(10) NORM_FIXED(11)
  NORM_FIXED(12) NORM_FIXED(13) NORM_FIXED(14)
#undef NORM_FIXED
  return false;
}

// the any-layout kernel of E elements a lane (1 to 64); false where there
// is none
template <typename T, bool kLN>
bool launch_any(int E, const Args& a, int threads, int blocks,
                cudaStream_t st, cudaError_t* err) {
#define NORM_ANY(e)                                                      \
  if (E == e) {                                                          \
    norm_any<T, e, kLN><<<blocks, threads, 0, st>>>(a);                  \
    *err = cudaGetLastError();                                           \
    return true;                                                         \
  }
  NORM_ANY(1) NORM_ANY(2) NORM_ANY(4) NORM_ANY(8) NORM_ANY(16) NORM_ANY(32)
  NORM_ANY(64)
#undef NORM_ANY
  return false;
}

bool pow2(long long n) { return n > 0 && (n & (n - 1)) == 0; }

int ilog2(long long n) {
  int k = 0;
  while ((1LL << k) < n) ++k;
  return k;
}

int run(bool ln, const void* x, const void* g, const void* b, void* out,
        int dtype, long long rows, int d, long long stride, float eps,
        int vec, int lanes, int warps, int threads, int early, void* stream) {
  if (dtype != 0 && dtype != 1) return kBadDtype;
  if (rows < 1 || d < 1 || stride < d) return kBadShape;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int full = 16 / itemsize;
  long long block_d = 1;
  while (block_d < d) block_d <<= 1;
  const int row_threads = lanes * warps;
  if (!pow2(vec) || vec > full || !pow2(lanes) || lanes > 32 ||
      !pow2(warps) || warps > 8 || (warps > 1 && lanes != 32) ||
      block_d % (static_cast<long long>(vec) * row_threads) ||
      !pow2(threads) || threads < row_threads || threads < 32 ||
      threads > kMaxThreads)
    return kBadPlan;
  const int E = static_cast<int>(block_d / row_threads);
  const int groups = threads / row_threads;
  if (warps > 1 && groups * warps > kMaxSlots) return kBadPlan;
  const long long blocks = (rows + groups - 1) / groups;
  if (blocks > 0x7fffffffLL) return kBadPlan;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t ba = reinterpret_cast<uintptr_t>(ln ? b : g);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const Args a{x, g, ln ? b : g, out, rows, stride, d, vec, lanes, warps,
               ilog2(vec), ilog2(lanes), ilog2(warps), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log_d = ilog2(block_d);
  // the fixed kernel where the layout is the 16-byte one of BLOCK_D and
  // every address is 16-byte aligned, with the threads it is built for
  const bool fast = vec == full && d % full == 0 && xa % 16 == 0 &&
                    (stride * itemsize) % 16 == 0 && ga % 16 == 0 &&
                    ba % 16 == 0 && oa % 16 == 0 && log_d >= 7 &&
                    log_d <= 14;
  cudaError_t err = cudaSuccess;
  const int nb = static_cast<int>(blocks);
  bool ok = false;
  if (fast) {
    if (dtype == 0)
      ok = ln ? launch_fixed<float, true>(log_d, early, a, threads, nb, st,
                                          &err)
              : launch_fixed<float, false>(log_d, early, a, threads, nb, st,
                                           &err);
    else
      ok = ln ? launch_fixed<__nv_bfloat16, true>(log_d, early, a, threads,
                                                  nb, st, &err)
              : launch_fixed<__nv_bfloat16, false>(log_d, early, a, threads,
                                                   nb, st, &err);
  }
  if (!ok) {
    if (dtype == 0)
      ok = ln ? launch_any<float, true>(E, a, threads, nb, st, &err)
              : launch_any<float, false>(E, a, threads, nb, st, &err);
    else
      ok = ln ? launch_any<__nv_bfloat16, true>(E, a, threads, nb, st, &err)
              : launch_any<__nv_bfloat16, false>(E, a, threads, nb, st,
                                                 &err);
  }
  if (!ok) return kBadPlan;
  return static_cast<int>(err);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (gamma, beta and out take x's).  x is
// (rows, d) with rows x_stride elements apart and unit column stride;
// gamma and beta (d,) contiguous; out contiguous (rows, d).  vec, lanes and
// warps are the Triton program's layout (norms.block_plan): V consecutive
// columns a lane, a row over `lanes` lanes of `warps` warps (lanes 32
// where warps > 1); threads (a power of two from a row's threads to 256)
// the block's, one row each lanes * warps of them; early (0 or 1) loads
// gamma and beta with x.  Refused before any launch, with a negative code
// that repro_cuda_error_string names: a dtype code other than those (-2),
// an empty or inconsistent shape (-3), a plan that does not divide
// next_pow2(d) into whole chunks, needs more than 256 threads or 64
// partial sums a block, or holds more than 64 elements a lane (-4).
// Otherwise returns the launch's cudaError_t (0 on success); the kernel
// runs asynchronously on `stream`.
extern "C" int repro_rmsnorm(const void* x, const void* g, void* out,
                             int x_dtype, long long rows, int d,
                             long long x_stride, float eps, int vec,
                             int lanes, int warps, int threads, int early,
                             void* stream) {
  return run(false, x, g, nullptr, out, x_dtype, rows, d, x_stride, eps, vec,
             lanes, warps, threads, early, stream);
}

extern "C" int repro_layernorm(const void* x, const void* g, const void* b,
                               void* out, int x_dtype, long long rows, int d,
                               long long x_stride, float eps, int vec,
                               int lanes, int warps, int threads, int early,
                               void* stream) {
  return run(true, x, g, b, out, x_dtype, rows, d, x_stride, eps, vec, lanes,
             warps, threads, early, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  switch (code) {
    case kBadDtype:
      return "x must be float32 or bfloat16";
    case kBadShape:
      return "empty or inconsistent shape: rows and d >= 1, the row stride "
             "at least d";
    case kBadPlan:
      return "block plan refused: the row's lanes and chunks must divide "
             "next_pow2(d), a power-of-two block of at most 256 threads and "
             "64 partial sums, at most 64 elements a lane";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
