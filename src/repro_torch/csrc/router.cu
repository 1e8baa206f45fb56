// MoE top-k router for Hopper (sm_90a), plain C interface.
//
// Replaces: _router_kernel, src/repro/kernels/router.py:19 (the Pallas TPU
// kernel the reference's kernel mode runs in every MoE layer, prefill and
// decode, on the router logits).
//
// Computes, for logits x (T, E) in f32 or bf16, k and renormalize:
//   p = softmax(x) in f32 (max subtracted, accurate expf, IEEE division);
//   the k largest p in order, w_r and i_r for r = 0..k-1, equal values
//   taken lowest index first (the TPU kernel's k rounds of max, first
//   argmax and mask);
//   with renormalize, w / max(sum(w), 1e-30), the sum taken in slot order
//   ((w_0 + w_1) + w_2) + ... and an IEEE division;
//   weights (T, k) in x's dtype, ids (T, k) int32.
//
// Bound on this card: bytes.  A launch reads T*E logits and writes 2*T*k
// values once: 131 KB in and 64 KB out at T=1024, E=32, k=8 in f32, 0.06 us
// at 3.35 TB/s; a decode step's T=4 moves under 1 KB.  So latency sets its
// time: the launch (0.8-1.0 us in a graph replay) and the kernel's own
// critical path.
//
// The kernel it replaced (since retired; PERF.md keeps its times) ran k
// argmax rounds one after another, each a 5-step (value, index) shuffle
// butterfly: 1.3-1.4 us of a 2.8-3.1 us launch.  Here no step waits on a
// previous pick:
//
// * Layout.  One warp a row, 8 rows a block, lane q holding column q and,
//   past 32 experts, q + 32: the round kernel's layout, so its softmax tree
//   (each lane's (0 + p[0]) + p[1], then the xor butterfly 16..1) and its
//   bits.
// * Rank by count.  Each lane writes its probabilities to shared memory and
//   counts, for each of its columns i, the row's columns j that beat it: a
//   larger p, or an equal p at a lower index.  As p >= +0, the order of
//   (p, -j) is the unsigned order of the 64-bit key bits(p) << 32 | ~j, so
//   each count is one 64-bit compare a column, independent of every other
//   (past 32 experts, a column of the other group of 32 than i's is one
//   32-bit compare of bits(p): which index is lower is known).  The
//   counts are a permutation of 0..E-1: column i's count is its slot.
// * The lanes whose column's slot r is below k write (p, i) to slot r in
//   shared memory; then lane q reads slot q (and q + 32), sums slots 0..k-1
//   in order and writes its weight and id.
//
// A row whose probabilities are NaN (a NaN or +inf logit, or every logit
// -inf) is outside what either kernel defines: here its ids come in index
// order, as the plain version's argmax gives them; the round kernel
// repeated id 0.  Every other row got the round kernel's ids and weights
// bit for bit (chip_smoke.py held every path launch and sample to that
// while the round kernel stayed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxExperts = 64;
constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the key of column j with probability p: larger p first, then lower j
__device__ __forceinline__ unsigned long long rank_key(float p, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(p)) << 32) |
         static_cast<unsigned>(~j);
}

// kPer columns a lane: q and, at kPer 2 (E past 32), q + 32
template <typename T, int kPer>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rank_kernel(const T* __restrict__ x, T* __restrict__ w,
            int* __restrict__ ids, int rows, int e, int k, long long x_rs,
            int renorm) {
  constexpr int kCols = 32 * kPer;  // a row's columns, E or more
  __shared__ __align__(16) float ps[kRowsPerBlock][kCols];
  __shared__ __align__(16) float ws[kRowsPerBlock][kCols];
  __shared__ int is[kRowsPerBlock][kCols];
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * x_rs;

  float p[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = q + 32 * j;
    p[j] = c < e ? to_f32(xr[c]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    p[j] = q + 32 * j < e ? expf(p[j] - mx) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  // columns past E hold +0 with an index past every column's: they beat
  // none
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = q + 32 * j;
    p[j] = c < e ? p[j] / s : 0.f;
    ps[warp][c] = p[j];
  }
  __syncwarp();

  // each column's count in 4 partial counts (short add chains)
  constexpr int kStep = 4;
  unsigned long long mine[kPer];
  int cnt[kPer][kStep];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    mine[j] = rank_key(p[j], q + 32 * j);
#pragma unroll
    for (int t = 0; t < kStep; ++t) cnt[j][t] = 0;
  }
  // a column of another group of 32 than the lane's own column j has a
  // higher index (a later group: it beats it only by a larger p) or a
  // lower one (an earlier group: an equal p beats it too), known at
  // compile time: one 32-bit compare of the keys' high words
  const auto beats = [&](float v, int c, int j) {
    const int group = c / 32;
    if (group == j) return rank_key(v, c) > mine[j];
    const unsigned hi = __float_as_uint(v), own = mine[j] >> 32;
    return group > j ? hi > own : hi >= own;
  };
#pragma unroll
  for (int c = 0; c < kCols; c += kStep) {
    const float4 f = *reinterpret_cast<const float4*>(&ps[warp][c]);
    const float v[kStep] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) cnt[j][t] += beats(v[t], c + t, j);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = q + 32 * j;
    int r = 0;
#pragma unroll
    for (int t = 0; t < kStep; ++t) r += cnt[j][t];
    if (c < e && r < k) {
      ws[warp][r] = p[j];
      is[warp][r] = c;
    }
  }
  __syncwarp();

  float wsum = 0.f;
  if (renorm && k <= 8) {
    // slots 0..7 read at once, added in order
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = ws[warp][r];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < k) wsum += v[r];
  } else if (renorm) {
    for (int r = 0; r < k; ++r) wsum += ws[warp][r];
  }
  const float denom = renorm ? fmaxf(wsum, 1e-30f) : 1.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = q + 32 * j;
    if (r < k) {
      const float wr = ws[warp][r];
      store(w + (long long)row * k + r, renorm ? wr / denom : wr);
      ids[(long long)row * k + r] = is[warp][r];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* w, void* ids, int rows, int e, int k,
                   long long x_rs, int renorm, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const auto xt = static_cast<const T*>(x);
  const auto wt = static_cast<T*>(w);
  const auto it = static_cast<int*>(ids);
  if (e > 32)
    rank_kernel<T, 2><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        xt, wt, it, rows, e, k, x_rs, renorm);
  else
    rank_kernel<T, 1><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        xt, wt, it, rows, e, k, x_rs, renorm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the logits' and the weights' type).
// x_rs and x_cs are the logits' row and column strides in elements; the
// columns must be contiguous (x_cs == 1).  Refused with
// cudaErrorInvalidValue: E < 1 or E > 64, k < 1 or k > E, x_cs != 1, any
// other dtype.  Returns the launch's cudaError_t (0 on success); the kernel
// runs asynchronously on `stream`, on the current device.
extern "C" int repro_topk_router(const void* x, void* w, void* ids, int dtype,
                                 int rows, int e, int k, long long x_rs,
                                 long long x_cs, int renorm, void* stream) {
  if (rows < 0 || e < 1 || e > kMaxExperts || k < 1 || k > e || x_cs != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, w, ids, rows, e, k, x_rs, renorm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, w, ids, rows, e, k, x_rs, renorm, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
