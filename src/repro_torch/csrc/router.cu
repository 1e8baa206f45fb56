// MoE top-k router for Hopper (sm_90a), plain C interface.
//
// Replaces: _router_kernel, src/repro/kernels/router.py:19 (the Pallas TPU
// kernel the reference's kernel mode runs in every MoE layer, prefill and
// decode, on the router logits).
//
// Computes, for logits x (T, E) in f32 or bf16, k and renormalize:
//   p = softmax(x) in f32 (max subtracted, accurate expf, IEEE division);
//   then k rounds: w_r = max(p), i_r = argmax(p) -- the LOWEST index among
//   equal maxima -- and column i_r set to -1.0;
//   with renormalize, w / max(sum(w), 1e-30);
//   weights (T, k) in x's dtype, ids (T, k) int32.
//
// Bound on this card: bytes.  A launch reads T*E logits and writes 2*T*k
// values once: 131 KB in and 64 KB out at T=1024, E=32, k=8 in f32, 0.06 us
// at 3.35 TB/s; a decode step's T=4 moves under 1 KB.  So launch latency
// sets its time, and the design is the simplest right one.
//
// Design: one warp per token row, kRowsPerBlock rows per block.  With
// E <= 64, lane l holds columns l and l + 32 in registers; columns past E
// hold -inf and never win a round (a masked column holds -1.0, above
// them).  Max and sum are __shfl_xor_sync butterflies.  Each argmax round
// reduces (value, index) pairs across the warp: a pair wins on a larger
// value, or on an equal value with a smaller index, so every lane ends the
// round with the same winner, and the lane that owns its column masks it.
// Round r's weight and id stay in the registers of lane r % 32, which
// writes them after the last round.  No shared memory and no atomics;
// rows are independent, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxExperts = 64;
constexpr int kPerLane = kMaxExperts / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
router_kernel(const T* __restrict__ x, T* __restrict__ w,
              int* __restrict__ ids, int rows, int e, int k,
              long long x_rs, int renorm) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * x_rs;

  float p[kPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    p[j] = c < e ? to_f32(xr[c]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    p[j] = lane + 32 * j < e ? expf(p[j] - mx) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    p[j] = lane + 32 * j < e ? p[j] / s : -INFINITY;

  float my_w[kPerLane] = {};
  int my_i[kPerLane] = {};
  float wsum = 0.f;
  for (int r = 0; r < k; ++r) {
    // the lane's own best, lowest column first, then the warp's
    float bv = p[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < kPerLane; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (lane + 32 * j == bi) p[j] = -1.0f;
    }
    wsum += bv;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (r == lane + 32 * j) {
        my_w[j] = bv;
        my_i[j] = bi;
      }
    }
  }
  const float denom = renorm ? fmaxf(wsum, 1e-30f) : 1.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int r = lane + 32 * j;
    if (r < k) {
      store(w + (long long)row * k + r, renorm ? my_w[j] / denom : my_w[j]);
      ids[(long long)row * k + r] = my_i[j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* w, void* ids, int rows, int e, int k,
                   long long x_rs, int renorm, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  router_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(w), static_cast<int*>(ids),
      rows, e, k, x_rs, renorm);
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
