// Mamba-1 selective scan for Hopper (sm_90a), plain C interface.
//
// Replaces: _mamba_kernel, src/repro/kernels/mamba_scan.py:23 (the Pallas
// TPU kernel the reference's kernel mode runs once a layer in the ssm
// family's full-sequence forward, ``train_forward`` and ``block_fn``).
//
// Computes, for x and delta (Bb, L, Dm) in f32 or bf16 (one dtype), A
// (Dm, N) f32, B and C (Bb, L, N) f32 and D (Dm,) f32, per (b, d), with an
// f32 state h[n] = 0 and every value in f32:
//   h[n] = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n] + D[d] * x[b,t,d]   (rounded once)
// for t = 0 .. L-1; y (Bb, L, Dm) in x's dtype, contiguous.
//
// Bound on this card: the exponentials.  At the scoring shape (Bb 4, L 256,
// Dm 8192, N 16, bf16) a launch moves 50.9 MB (15.2 us at 3.35 TB/s) but
// takes Bb*L*Dm*N = 134.2 M accurate expf, each one MUFU.EX2 result on the
// SFU (16 a clock per SM): about 32 us on 132 SMs at 1.98 GHz.
//
// Design, simple and right first: the recurrence is sequential in t and
// nothing carries a state from one block to the next, so a block owns
// kThreads neighbouring channels of one batch row and walks all of L.
// One thread per channel holds its N <= 16 states and A[d, :] in
// registers: the n loop is unrolled, so the 16 state updates of a step are
// independent work that hides the SFU's latency, and the sum over n is a
// plain loop in a fixed order (no shuffles, no atomics: deterministic).
// Time advances in chunks of kChunk steps: each thread loads its channel's
// x and delta for the chunk into registers first (neighbouring channels on
// neighbouring threads, so every load and every y store coalesces), and
// the block stages the chunk's B_t and C_t, shared by all its channels, in
// shared memory between two __syncthreads().  B and C are read through
// their strides: the model hands them as column views of one (Bb, L,
// dt_rank + 2N) projection.  The accurate expf, not __expf, because the
// f32 check's limit is tight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;    // channels a block
constexpr int kChunk = 16;       // time steps staged at a time
constexpr int kMaxState = 16;    // the widest d_state the kernel takes

// refusals of the C entry point, negative so they never meet a cudaError_t
constexpr int kStateTooWide = -1;
constexpr int kMixedDtypes = -2;
constexpr int kBadDtype = -3;
constexpr int kEmpty = -4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element strides: x and delta by (batch, time) with unit channel stride;
// B and C by (batch, time, state)
struct Strides {
  long long x_b, x_t, d_b, d_t, b_b, b_t, b_n, c_b, c_t, c_n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dv,
                  T* __restrict__ y, int L, int dm, int n_state, Strides s) {
  __shared__ float sB[kChunk][kMaxState];
  __shared__ float sC[kChunk][kMaxState];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < dm;   // a dead thread still joins the barriers

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    a[n] = (live && n < n_state) ? A[(long long)c * n_state + n] : 0.f;
    h[n] = 0.f;
  }
  const float d_skip = live ? Dv[c] : 0.f;
  const T* xb = x + b * s.x_b + c;
  const T* db = dt + b * s.d_b + c;
  const float* Bb = Bm + b * s.b_b;
  const float* Cb = Cm + b * s.c_b;
  T* yb = y + (long long)b * L * dm + c;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = min(kChunk, L - t0);
    float xs[kChunk], ds[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool in = live && j < steps;
      xs[j] = in ? to_f32(xb[(t0 + j) * s.x_t]) : 0.f;
      ds[j] = in ? to_f32(db[(t0 + j) * s.d_t]) : 0.f;
    }
    __syncthreads();  // the previous chunk's B and C are no longer read
    for (int i = threadIdx.x; i < steps * n_state; i += kThreads) {
      const int j = i / n_state;
      const int n = i - j * n_state;
      sB[j][n] = Bb[(t0 + j) * s.b_t + n * s.b_n];
      sC[j][n] = Cb[(t0 + j) * s.c_t + n * s.c_n];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < steps) {
        const float dx = ds[j] * xs[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < kMaxState; ++n) {
          if (n < n_state) {
            h[n] = expf(ds[j] * a[n]) * h[n] + dx * sB[j][n];
            acc += h[n] * sC[j][n];
          }
        }
        if (live) store(yb + (long long)(t0 + j) * dm, acc + d_skip * xs[j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* delta, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   int batch, int L, int dm, int n_state, const Strides& s,
                   cudaStream_t stream) {
  const dim3 grid((dm + kThreads - 1) / kThreads, batch);
  mamba_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), L, dm, n_state, s);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, delta_dtype: 0 = float32, 1 = bfloat16 (y takes x's).  A is
// (dm, n_state) and D (dm,), both contiguous; y is written contiguous.
// The strides are in elements.  Refused before any launch, with a negative
// code that repro_cuda_error_string names: n_state outside 1..16 (-1),
// x_dtype != delta_dtype (-2), a dtype other than those two (-3), L, batch
// or dm below 1, or batch above the grid's 65535 rows (-4).  Otherwise
// returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`, on the current device.
extern "C" int repro_mamba_scan(const void* x, const void* delta,
                                const void* A, const void* B, const void* C,
                                const void* D, void* y, int x_dtype,
                                int delta_dtype, int batch, int L, int dm,
                                int n_state, long long x_bs, long long x_ts,
                                long long d_bs, long long d_ts, long long b_bs,
                                long long b_ts, long long b_ns, long long c_bs,
                                long long c_ts, long long c_ns, void* stream) {
  if (n_state < 1 || n_state > kMaxState) return kStateTooWide;
  if (x_dtype != delta_dtype) return kMixedDtypes;
  if (x_dtype != 0 && x_dtype != 1) return kBadDtype;
  if (L < 1 || batch < 1 || dm < 1 || batch > 65535) return kEmpty;
  const Strides s{x_bs, x_ts, d_bs, d_ts, b_bs, b_ts, b_ns, c_bs, c_ts, c_ns};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch<float>(x, delta, A, B, C, D, y, batch, L, dm, n_state, s, st);
  else
    err = launch<__nv_bfloat16>(x, delta, A, B, C, D, y, batch, L, dm,
                                n_state, s, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  switch (code) {
    case kStateTooWide:
      return "d_state outside 1..16, the widths the scan kernel takes";
    case kMixedDtypes:
      return "x and delta differ in dtype";
    case kBadDtype:
      return "x and delta must be float32 or bfloat16";
    case kEmpty:
      return "empty or oversized scan: L, batch and channels must be >= 1, "
             "batch <= 65535";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
