// Single-token GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: _decode_attn_kernel, src/repro/kernels/decode_attention.py:29
// (the Pallas TPU kernel the reference's kernel mode runs for every decode
// step's cache attention).
//
// Computes, for q (B, Hq, 1, Dh) and k/v (B, Hkv, Smax, Dh) given as strided
// views of the (B, Smax, Hkv, Dh) cache, positions (B, 1) int32 and scale:
//   key j of row b is valid when j <= pos[b] (and pos[b] - j < window when a
//   window is set); out = softmax(q k^T * scale over valid keys) v, with the
//   online softmax's m, l and acc in f32, l clamped at 1e-30, and one cast of
//   the result to q's dtype.  Under GQA, q head h reads kv head h / (Hq/Hkv).
//
// Bound on this card: the K and V bytes of the valid keys over 3.35 TB/s
// (2 MiB a layer at B=4, Hkv=8, Smax=128, Dh=128 in bf16 when every key is
// valid).  The q, positions and output bytes are noise beside them.
//
// Design: one block of kWarps warps per (b, kv head).  The block handles the
// `group` q heads that share the kv head, so K and V are read once, not
// `group` times.  The warps take the valid keys in turn (warp w: keys lo+w,
// lo+w+kWarps, ...); each lane holds DPL consecutive elements of a key row,
// a dot product is a per-lane partial sum plus a warp-shuffle reduction, and
// each warp keeps its own online softmax state in registers.  The loop runs
// from the first to the last valid key only: a masked key would contribute
// exp(-1e30 - m) = 0, so skipping it changes nothing while one valid key
// exists (key pos[b] always is).  The warps' states are merged once through
// shared memory at the end.  No tensor cores, TMA or split over blocks:
// those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   T* __restrict__ out, int hkv, int smax, int dh, int group,
                   long long q_sb, long long q_sh, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb,
                   long long v_sh, long long v_ss, long long pos_sb,
                   float scale, int window) {
  // shared: m and l per (warp, q head), then acc per (warp, q head, dim)
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = smem + kWarps * group;
  float* sm_acc = smem + 2 * kWarps * group;

  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = pos[b * pos_sb];
  const int hi = min(p, smax - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;

  float qr[kMaxGroup][DPL];
  float acc[kMaxGroup][DPL];
  float m[kMaxGroup];
  float l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const T* qp = q + b * q_sb + (long long)(hk * group + g) * q_sh;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane * DPL + j;
      acc[g][j] = 0.f;
      qr[g][j] = (g < group && d < dh) ? to_f32(qp[d]) : 0.f;
    }
  }

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int key = lo + warp; key <= hi; key += kWarps) {
    const T* kp = kb + (long long)key * k_ss;
    const T* vp = vb + (long long)key * v_ss;
    float kr[DPL];
    float vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane * DPL + j;
      kr[j] = d < dh ? to_f32(kp[d]) : 0.f;
      vr[j] = d < dh ? to_f32(vp[d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) s += qr[g][j] * kr[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * alpha + pr;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = acc[g][j] * alpha + pr * vr[j];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      if (lane == 0) {
        sm_m[warp * group + g] = m[g];
        sm_l[warp * group + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane * DPL + j;
        if (d < dh) sm_acc[(warp * group + g) * dh + d] = acc[g][j];
      }
    }
  }
  __syncthreads();

  const int hq = hkv * group;
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x) {
    const int g = i / dh;
    const int d = i % dh;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * group + g]);
    float lsum = 0.f;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * group + g] - mx);
      lsum += sm_l[w * group + g] * e;
      a += sm_acc[(w * group + g) * dh + d] * e;
    }
    store(out + ((long long)b * hq + hk * group + g) * dh + d,
          a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(int dpl, dim3 grid, size_t shmem, cudaStream_t stream,
                   const void* q, const void* k, const void* v,
                   const void* pos, void* out, int hkv, int smax, int dh,
                   int group, long long q_sb, long long q_sh, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb,
                   long long v_sh, long long v_ss, long long pos_sb,
                   float scale, int window) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(pos);
  T* ot = static_cast<T*>(out);
  const dim3 block(kWarps * 32);
#define REPRO_LAUNCH(D)                                                     \
  decode_attn_kernel<T, D><<<grid, block, shmem, stream>>>(                 \
      qt, kt, vt, pt, ot, hkv, smax, dh, group, q_sb, q_sh, k_sb, k_sh,     \
      k_ss, v_sb, v_sh, v_ss, pos_sb, scale, window)
  switch (dpl) {
    case 1: REPRO_LAUNCH(1); break;
    case 2: REPRO_LAUNCH(2); break;
    case 4: REPRO_LAUNCH(4); break;
    case 8: REPRO_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every stride is in elements; the last
// dimension of q, k and v must be contiguous.  window <= 0 means no window.
// Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`, on the current device.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    int dtype, int batch, int hq, int hkv, int smax, int dh,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long pos_sb, float scale, int window, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup ||
      smax <= 0 || dh <= 0 || dh > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int group = hq / hkv;
  const int lanes = (dh + 31) / 32;
  const int dpl = lanes <= 1 ? 1 : lanes <= 2 ? 2 : lanes <= 4 ? 4 : 8;
  const dim3 grid(batch * hkv);
  const size_t shmem = sizeof(float) * kWarps * group * (2 + dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(dpl, grid, shmem, s, q, k, v, pos, out, hkv, smax, dh,
                        group, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                        pos_sb, scale, window);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(dpl, grid, shmem, s, q, k, v, pos, out, hkv,
                                smax, dh, group, q_sb, q_sh, k_sb, k_sh, k_ss,
                                v_sb, v_sh, v_ss, pos_sb, scale, window);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
