// Causal / local-window GQA flash attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces: _flash_kernel, src/repro/kernels/flash_attention.py:27
// (pallas_call at :94; the Pallas TPU kernel the reference's kernel mode
// runs for every prefill whose bucket is a multiple of 128).
//
// Computes, for qt (B, Hq, Lq, Dh) and kt/vt (B, Hkv, Lkv, Dh) given as
// strided views of the (B, L, H, Dh) activations, scale, causal, an optional
// window and q_offset: query row i sits at qpos = q_offset + i, key j at
// kpos = j; the key is valid when qpos >= kpos (if causal) and
// qpos - kpos < window (if a window is set).  Scores are q.k * scale, a
// masked score is the finite -1e30, the softmax is online with m, l and acc
// in f32, l is clamped at 1e-30, and the result is cast once to q's dtype,
// contiguous (B, Hq, Lq, Dh).  Under GQA, q head h reads kv head
// h / (Hq/Hkv).
//
// Bound on this card: at the prefill's (B=4, L=256, Hq/Hkv=16/8, Dh=128) in
// bf16, q, k, v and the output are 12.6 MB, 3.8 us at 3.35 TB/s; the causal
// QK^T and PV products are 1.08 GFLOP, 1.1 us at the bf16 tensor-core rate.
// At recurrentgemma's (B=4, L=256, Hq/Hkv=16/1, Dh=256) in bf16: 17.8 MB,
// 5.3 us; 2.16 GFLOP causal, 2.2 us on the tensor cores.
// So the work is bound by bytes, but this kernel is not: it runs its
// products as f32 FMAs on the CUDA cores (see below; 32 us for the Dh=256
// products at the f32 rate), where shared-memory loads feeding the FMAs set
// its pace.
//
// Design: one block of 128 threads per (tile of q rows, q head, batch): 64
// rows at head widths up to 128, 32 rows at head widths 129..256.
// A loop inside the block walks the kv tiles of 64 keys; it takes the place
// of the TPU's sequential fourth grid axis, and the block keeps its own m, l
// and acc in registers across it.  The q tile and each K and V tile are
// staged in shared memory as f32 (rows padded to one more than the head
// width, so neighbouring rows fall in other banks).  Thread (ty, tx) of a
// 16 x 8 layout owns rows R*ty..R*ty+R-1 (R = 4, or 2 above head width
// 128): it scores keys tx + 8j of the tile,
// the row's max and sum are reduced over its 8 lanes by warp shuffles, and
// it accumulates output dims tx + 8j, reading the tile's probabilities back
// from shared memory.  Scores and the PV product are f32 FMAs, and exp is
// the accurate expf, as the reference keeps q, k, v and p in f32: tensor
// cores would round p to bf16 (or f32 inputs to TF32).  Those, TMA and
// splitting long kv ranges over blocks are later work.
//
// Head width 256 (recurrentgemma, 16 q heads on one kv head): the 64-row
// tile would take 214 KB of shared memory and 128 f32 accumulators a
// thread, where ptxas spills.  So above 128 a block holds 32 q rows, 2 a
// thread: 172.8 KB of shared memory (one block an SM) and 64 accumulators
// a thread.  The instances up to 128 keep their 64-row tile.
//
// Only the kv tiles that can hold a valid key of the block's rows are
// walked: from the window's first key of the block's first row to the
// causal diagonal of its last.  A fully masked key contributes
// p = exp(-1e30 - m) = 0 with alpha = 1 once its row has seen a valid key,
// and what it adds before that is wiped by alpha = exp(-1e30 - m) = 0 when
// the first valid key arrives, so skipping it is exact.  A row with no valid
// key at all (a window, and qpos >= Lkv - 1 + window) is the exception: the
// reference's scores there are all -1e30, every p is exp(0) = 1, and the
// row comes out as the mean of V over all Lkv keys.  This kernel gives that
// too: a block holding such a row walks every kv tile, so the row sums all
// Lkv keys with p = 1, and the block's other rows stay exact as above.
// Keys past Lkv in the last tile get p = 0 outright (score -inf), never
// -1e30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockK = 64;            // keys per kv tile
constexpr int kLanes = 8;              // threads sharing one group of rows
constexpr int kThreads = 128;
constexpr int kGroups = kThreads / kLanes;  // 16 groups of rows
constexpr int kKeys = kBlockK / kLanes;  // keys per thread and tile
constexpr int kMaxHeadDim = 256;

// rows per thread, and q rows per block, at padded head width DH
template <int DH>
__host__ __device__ constexpr int rows_per_thread() {
  return DH <= 128 ? 4 : 2;
}
template <int DH>
__host__ __device__ constexpr int block_q() {
  return rows_per_thread<DH>() * kGroups;
}
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// smem bytes of a block: the q, k and v tiles at row stride DH + 1, and the
// probabilities at row stride kBlockK + 1
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((block_q<DH>() + 2 * kBlockK) * (DH + 1) +
                          block_q<DH>() * (kBlockK + 1));
}

// DH: the head width padded up to a multiple of kLanes (dims dh..DH-1 are
// staged as zeros and never stored)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int hq,
                  int lq, int lkv, int dh, int group, long long q_sb,
                  long long q_sh, long long q_ss, long long k_sb,
                  long long k_sh, long long k_ss, long long v_sb,
                  long long v_sh, long long v_ss, float scale, int causal,
                  int window, int q_offset) {
  constexpr int kRows = rows_per_thread<DH>();
  constexpr int kBlockQ = block_q<DH>();
  constexpr int SD = DH + 1;
  constexpr int SP = kBlockK + 1;
  constexpr int DPT = DH / kLanes;     // output dims per thread
  extern __shared__ float smem[];
  float* sq = smem;                    // (kBlockQ, SD)
  float* sk = sq + kBlockQ * SD;       // (kBlockK, SD)
  float* sv = sk + kBlockK * SD;       // (kBlockK, SD)
  float* sp = sv + kBlockK * SD;       // (kBlockQ, SP)

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kLanes;
  const int r0 = threadIdx.x / kLanes * kRows;   // the thread's first row
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int i = threadIdx.x; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    sq[r * SD + d] = (q0 + r < lq && d < dh)
                         ? to_f32(qb[(q0 + r) * q_ss + d]) : 0.f;
  }

  // the keys the block walks (see the note at the top)
  const long long qpos_lo = (long long)q_offset + q0;
  const long long qpos_hi = qpos_lo + min(kBlockQ, lq - q0) - 1;
  long long key_lo = 0, key_hi = lkv - 1;
  if (!(window > 0 && qpos_hi >= (long long)lkv - 1 + window)) {
    if (window > 0) key_lo = max(0LL, qpos_lo - window + 1);
    if (causal) key_hi = min(key_hi, qpos_hi);
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (int)(key_lo / kBlockK) * kBlockK; k0 <= key_hi;
       k0 += kBlockK) {
    __syncthreads();   // the last tile's readers are done
    for (int i = threadIdx.x; i < kBlockK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < lkv && d < dh;
      sk[r * SD + d] = in ? to_f32(kb[(k0 + r) * k_ss + d]) : 0.f;
      sv[r * SD + d] = in ? to_f32(vb[(k0 + r) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qr[kRows], kr[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = sq[(r0 + i) * SD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kr[j] = sk[(tx + kLanes * j) * SD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qpos = qpos_lo + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + kLanes * j;
        float x = -INFINITY;   // past Lkv: p = 0 outright
        if (key < lkv) {
          const bool valid = (!causal || qpos >= key) &&
                             (window <= 0 || qpos - key < window);
          x = valid ? s[i][j] * scale : kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], lanes_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        sp[(r0 + i) * SP + tx + kLanes * j] = s[i][j];
      }
      l[i] = l[i] * alpha + lanes_sum(rs);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();   // the tile's probabilities are in shared memory

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = sp[(r0 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sv[kk * SD + tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* op = out + (((long long)b * hq + h) * lq + row) * dh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + kLanes * j;
      if (d < dh) store(op + d, acc[i][j] / lc);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(int batch, cudaStream_t stream, const void* q,
                   const void* k, const void* v, void* out, int hq, int lq,
                   int lkv, int dh, int group, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh,
                   long long k_ss, long long v_sb, long long v_sh,
                   long long v_ss, float scale, int causal, int window,
                   int q_offset) {
  constexpr size_t shmem = smem_bytes<DH>();
  static_assert(shmem <= 232448, "a block's shared memory exceeds the card's");
  const dim3 grid((lq + block_q<DH>() - 1) / block_q<DH>(), hq, batch);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  flash_attn_kernel<T, DH><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, lq, lkv, dh, group,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, int batch, cudaStream_t stream, const void* q,
                     const void* k, const void* v, void* out, int hq, int lq,
                     int lkv, int group, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, float scale, int causal, int window,
                     int q_offset) {
#define REPRO_LAUNCH(D)                                                      \
  return launch<T, D>(batch, stream, q, k, v, out, hq, lq, lkv, dh, group,    \
                      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,  \
                      scale, causal, window, q_offset)
  if (dh <= 16) REPRO_LAUNCH(16);
  if (dh <= 32) REPRO_LAUNCH(32);
  if (dh <= 64) REPRO_LAUNCH(64);
  if (dh <= 128) REPRO_LAUNCH(128);
  REPRO_LAUNCH(256);
#undef REPRO_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every stride is in elements; the last
// dimension of q, k and v must be contiguous.  window <= 0 means no window;
// q_offset must be >= 0.  The output is contiguous (B, Hq, Lq, Dh).  Returns
// the launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`, on the current device.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int hq, int hkv, int lq, int lkv, int dh, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int window, int q_offset, void* stream) {
  if (batch <= 0 || batch > 65535 || hq <= 0 || hq > 65535 || hkv <= 0 ||
      hq % hkv != 0 || lq <= 0 || lkv <= 0 || dh <= 0 || dh > kMaxHeadDim ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(dh, batch, s, q, k, v, out, hq, lq, lkv, hq / hkv,
                          q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                          v_ss, scale, causal, window, q_offset);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(dh, batch, s, q, k, v, out, hq, lq, lkv,
                                  hq / hkv, q_sb, q_sh, q_ss, k_sb, k_sh,
                                  k_ss, v_sb, v_sh, v_ss, scale, causal,
                                  window, q_offset);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
