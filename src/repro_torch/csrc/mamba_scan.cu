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
// takes Bb*L*Dm*N = 134.2 M exponentials, each one MUFU.EX2 result on the
// SFU (16 a clock per SM): about 32 us on 132 SMs at 1.98 GHz.
//
// The recurrence is sequential in t and nothing carries a state from one
// block to the next, so a block owns neighbouring channels of one batch
// row and walks all of L.  A channel's N states are spread over kLanes
// neighbouring lanes of a warp, states kPer * g .. kPer * g + kPer - 1 on
// lane g, so at the scoring shape 131072 threads (512 blocks of 256, 4
// resident an SM at 64 registers a thread: 32 warps an SM) keep the SFU
// fed where one thread a channel (the first design) left 8 warps an SM
// waiting on latency.
//   Time advances in chunks of kChunk steps.  Lane g of a channel loads x
//   and delta of steps g, g + kLanes, ... of the chunk (a shuffle hands
//   each step's value to the channel's lanes) and owns y of those steps.
//   The next chunk's x, delta, B_t and C_t are loaded while the current
//   one computes: x and delta into registers, B_t and C_t into registers
//   and then into the second of two shared buffers, so one
//   __syncthreads() a chunk suffices and no load waits on the critical
//   path.  A chunk runs in groups of kLanes steps: each lane advances its
//   states through the group's steps and leaves each step's h in its
//   warp's shared rows; after a __syncwarp() the lane that owns a step
//   adds sum_n h[n] * C[n] from those rows one state at a time in
//   increasing n, as one thread adds it.  So y is bit for bit the first
//   design's (no atomics, no other order of sums), and the model's bf16
//   readings against the eager oracle stay those it gave, at four
//   multiply-adds a lane a step.  The rows are swizzled (block b
//   of step jj at slot jj * kLanes + (b ^ jj), rows 80 floats apart) so
//   neither the writes of a step nor the owners' reads meet a bank
//   conflict.  A full chunk is one straight run of steps (no per-step
//   test), which the compiler schedules across.  The exponential is the
//   accurate expf of dt * A, and the state update is spelled as in the
//   first design.
//
// B and C are read through their strides: the model hands them as column
// views of one (Bb, L, dt_rank + 2N) projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 16;       // time steps staged at a time
constexpr int kMaxState = 16;    // the widest d_state the kernels take
constexpr int kLanes = 4;        // lanes a channel
constexpr int kPer = kMaxState / kLanes;       // states a lane
constexpr int kLaneThreads = 256;              // threads a block
constexpr int kLaneChannels = kLaneThreads / kLanes;
constexpr int kLaneBlocks = 4;   // blocks an SM: 64 registers a thread
constexpr int kWarps = kLaneThreads / 32;
constexpr int kWarpChannels = 32 / kLanes;     // channels a warp
constexpr int kHRow = 80;        // floats a channel's row of h (64 + pad)
constexpr int kCRow = kMaxState + 4;           // floats a step's row of C
static_assert(kChunk * kMaxState == kLaneThreads,
              "a thread stages one B and one C value a chunk");
static_assert(kChunk % kLanes == 0, "a lane owns kChunk / kLanes steps");
static_assert(kPer == 4, "a lane's states of a step load as one float4");
static_assert(kChunk / kLanes == kPer, "a lane owns one step of each group");
static_assert(kHRow >= kLanes * kLanes * kPer && kHRow % 32 == 16,
              "a channel's row holds a group; rows sit half a bank row apart");

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

// kAllStates: n_state == kMaxState, so no state of a lane is tested
template <typename T, bool kAllStates>
__global__ void __launch_bounds__(kLaneThreads, kLaneBlocks)
mamba_scan_lanes_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ Dv, T* __restrict__ y,
                        int L, int dm, int n_state, Strides s) {
  // a row of B holds a step's states; lane g's kPer states load as one
  // float4.  C's rows are padded so that the owners of a group's kLanes
  // steps read theirs from different banks.
  __shared__ __align__(16) float sB[2][kChunk][kMaxState];
  __shared__ __align__(16) float sC[2][kChunk][kCRow];
  // h of a group's kLanes steps, a row a channel of each warp
  __shared__ __align__(16) float sH[kWarps][kWarpChannels][kHRow];
  const int g = threadIdx.x % kLanes;                 // lane in the channel
  const int c = blockIdx.x * kLaneChannels + threadIdx.x / kLanes;
  const int b = blockIdx.y;
  const bool live = c < dm;   // a dead thread still joins barriers, shuffles
  const int lane0 = (threadIdx.x % 32) - g;           // the channel's lane 0
  float* hrow = sH[threadIdx.x / 32][(threadIdx.x % 32) / kLanes];
  const unsigned full = 0xffffffffu;

  // state n = kPer * g + i of the channel
  float a[kPer], h[kPer];
  bool on[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = kPer * g + i;
    on[i] = n < n_state;
    a[i] = (live && on[i]) ? A[(long long)c * n_state + n] : 0.f;
    h[i] = 0.f;
  }
  const float d_skip = live ? Dv[c] : 0.f;
  const T* xb = x + b * s.x_b + c;
  const T* db = dt + b * s.d_b + c;
  const float* Bb = Bm + b * s.b_b;
  const float* Cb = Cm + b * s.c_b;
  T* yb = y + (long long)b * L * dm + c;
  // the B/C value this thread stages: step sj, state sn of a chunk
  const int sj = threadIdx.x / kMaxState;
  const int sn = threadIdx.x % kMaxState;

  // registers of the chunk being fetched: x, delta of steps g + kLanes * k
  float xn[kPer], dn[kPer], bn, cn;
  auto fetch = [&](int t0) {
    const int steps = min(kChunk, L - t0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = g + kLanes * k;
      const bool in = live && j < steps;
      xn[k] = in ? to_f32(xb[(long long)(t0 + j) * s.x_t]) : 0.f;
      dn[k] = in ? to_f32(db[(long long)(t0 + j) * s.d_t]) : 0.f;
    }
    const bool in = sj < steps && sn < n_state;
    bn = in ? Bb[(long long)(t0 + sj) * s.b_t + sn * s.b_n] : 0.f;
    cn = in ? Cb[(long long)(t0 + sj) * s.c_t + sn * s.c_n] : 0.f;
  };

  fetch(0);
  sB[0][sj][sn] = bn;
  sC[0][sj][sn] = cn;
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int n_steps = min(kChunk, L - t0);   // the same in the whole block
    float xc[kPer], dc[kPer], yk[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      xc[k] = xn[k];
      dc[k] = dn[k];
      yk[k] = 0.f;
    }
    const bool more = t0 + kChunk < L;
    if (more) fetch(t0 + kChunk);   // in flight while this chunk computes
    // step j of the chunk: the lane's states advance and land in its row,
    // block g of step jj = j % kLanes at slot jj * kLanes + (g ^ jj)
    auto step = [&](int j) {
      const int jj = j % kLanes;
      const float xj = __shfl_sync(full, xc[j / kLanes], lane0 + jj);
      const float dj = __shfl_sync(full, dc[j / kLanes], lane0 + jj);
      const float dx = dj * xj;
      const float4 bv =
          *reinterpret_cast<const float4*>(&sB[buf][j][g * kPer]);
      const float bs[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (kAllStates || on[i]) h[i] = expf(dj * a[i]) * h[i] + dx * bs[i];
      *reinterpret_cast<float4*>(&hrow[(jj * kLanes + (g ^ jj)) * kPer]) =
          make_float4(h[0], h[1], h[2], h[3]);
    };
    // y of step q * kLanes + g, the one the lane owns in group q:
    // sum_n h[n] * C[n] in increasing n, then the skip term
    auto sum = [&](int q) {
      const int j = q * kLanes + g;
      float acc = 0.f;
#pragma unroll
      for (int blk = 0; blk < kLanes; ++blk) {
        const float4 hv = *reinterpret_cast<const float4*>(
            &hrow[(g * kLanes + (blk ^ g)) * kPer]);
        const float4 cv =
            *reinterpret_cast<const float4*>(&sC[buf][j][blk * kPer]);
        const float hs[kPer] = {hv.x, hv.y, hv.z, hv.w};
        const float cs[kPer] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (kAllStates || blk * kPer + i < n_state) acc += hs[i] * cs[i];
      }
      yk[q] = acc + d_skip * xc[q];
    };
    // a full chunk is one straight run of kChunk steps the compiler can
    // schedule across; only the last chunk of a ragged L tests each step
#pragma unroll
    for (int q = 0; q < kChunk / kLanes; ++q) {
      if (n_steps == kChunk) {
#pragma unroll
        for (int jj = 0; jj < kLanes; ++jj) step(q * kLanes + jj);
      } else {
#pragma unroll
        for (int jj = 0; jj < kLanes; ++jj)
          if (q * kLanes + jj < n_steps) step(q * kLanes + jj);
      }
      __syncwarp();   // the group's rows are written
      if (q * kLanes + g < n_steps) sum(q);
      __syncwarp();   // and read, before the next group writes them
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = g + kLanes * k;
      if (live && j < n_steps) store(yb + (long long)(t0 + j) * dm, yk[k]);
    }
    if (more) {
      sB[buf ^ 1][sj][sn] = bn;
      sC[buf ^ 1][sj][sn] = cn;
    }
    __syncthreads();  // the next buffer is written; this one is read
    buf ^= 1;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* delta, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   int batch, int L, int dm, int n_state, const Strides& s,
                   cudaStream_t stream) {
  const dim3 grid((dm + kLaneChannels - 1) / kLaneChannels, batch);
  auto kernel = n_state == kMaxState ? mamba_scan_lanes_kernel<T, true>
                                     : mamba_scan_lanes_kernel<T, false>;
  kernel<<<grid, kLaneThreads, 0, stream>>>(
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
    err = launch<float>(x, delta, A, B, C, D, y, batch, L, dm, n_state, s,
                        st);
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
