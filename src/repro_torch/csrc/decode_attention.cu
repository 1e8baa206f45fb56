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
//   softmax's m, l and acc in f32, l clamped at 1e-30, and one cast of the
//   result to q's dtype.  Under GQA, q head h reads kv head h / (Hq/Hkv).  A
//   row with no valid key (pos[b] < 0, or a window ending before key 0 or
//   after Smax - 1) scores every key at the reference's -1e30 and comes out
//   as the mean of V, as the reference's does.
//
// Bound on this card: the K and V bytes of the valid keys over 3.35 TB/s
// (2 MiB a layer at B=4, Hkv=8, Smax=128, Dh=128 in bf16 when every key is
// valid).  The q, positions and output bytes are noise beside them.
//
// Design (repro_decode_attention): the keys are split over the card.
// - Split: the cache's Smax keys are cut into chunks of kChunk, a number
//   fixed by Smax (a static shape: the positions, a device tensor, are never
//   read on the host), and one block of 128 threads takes one (chunk, kv
//   head, batch row) and up to kHeads of the q heads that share the kv head,
//   so K and V are read once for them.  At B=4, Hkv=8 and Smax=512 that is
//   512 blocks, where one block per (batch row, kv head) gave 32 on 132 SMs.
//   A GQA group above kHeads takes more blocks, each its own kHeads heads.
// - Inside a chunk: 8 teams of 16 lanes, a team a key at a time; each lane
//   reads a run of the key row (16-byte vectors where aligned), a score is
//   a per-lane partial dot product and 4 shuffles.  A team loads all its
//   keys' K rows and copies their V rows to shared memory (cp.async)
//   before it computes, so the loads share one latency.  The scores go to
//   shared memory; a warp per head takes their max m_c, p = exp(s - m_c)
//   and l_c; then a thread per (head, column) sums p v over the chunk's
//   keys in order.
//   Only the chunk's valid keys are walked: a masked key contributes
//   exp(-1e30 - m) = 0 while the row has a valid key.  A chunk without a
//   valid key writes the sentinel partial m = -inf, l = 0, acc = 0.
// - Combine (a second kernel): each (batch row, q head) folds its chunks'
//   partials in chunk order, 16 loaded at a time, each weighted by
//   exp(m_c - M) against the running max, a sentinel by 0 (never
//   exp(-inf - -inf)).  No atomics: the sums are the same on every run.
// The partials are f32 scratch the wrapper allocates.  No tensor cores: the
// f32 and bf16 paths share the kernel, and f32 stays exact to its gates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 4;
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

constexpr int kChunk = 32;                    // keys a block
constexpr int kTeamLanes = 16;                // lanes sharing one key row
constexpr int kTeams = kWarps * 32 / kTeamLanes;
constexpr int kKeysPerTeam = kChunk / kTeams;
constexpr int kHeads = 8;                     // q heads a block

// EPL consecutive elements of `row` from column d0 as f32 (zeros past dh):
// 16-byte vector loads when VEC (then dh % EPL == 0, the row is 16-byte
// aligned and EPL elements are a whole number of vectors)
template <typename T, int EPL, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int d0,
                                         int dh, float (&out)[EPL]) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(EPL % kPer == 0, "a run is whole vectors");
#pragma unroll
    for (int i = 0; i < EPL / kPer; ++i) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (d0 < dh) u = __ldg(reinterpret_cast<const uint4*>(row + d0) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      out[j] = d0 + j < dh ? to_f32(row[d0 + j]) : 0.f;
  }
}

// V's run of `row` from column d0 into shared memory: 16-byte cp.async
// copies when VEC (see load_run), else loads and stores
template <typename T, int EPL, bool VEC>
__device__ __forceinline__ void stage_run(T* dst, const T* __restrict__ row,
                                          int d0, int dh) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    if (d0 < dh) {
#pragma unroll
      for (int i = 0; i < EPL / kPer; ++i) {
        const uint32_t s = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + d0 + i * kPer));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(row + d0 + i * kPer) : "memory");
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      if (d0 + j < dh) dst[d0 + j] = row[d0 + j];
  }
}

// grid (chunks, kv heads x head blocks, batch); partial (m, l, acc) of each
// (batch row, q head, chunk) at ((b * hq + h) * chunks + c)
template <typename T, int EPL, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int hq, int smax, int dh,
                    int group, int head_blocks, long long q_sb,
                    long long q_sh, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss, long long pos_sb, float scale,
                    int window) {
  constexpr int kRow = kTeamLanes * EPL;                   // dh, padded
  __shared__ float s_p[kHeads][kChunk];                    // scores, then p
  __shared__ __align__(16) T s_v[kChunk * kRow];           // the V rows

  const int c = blockIdx.x;
  const int chunks = gridDim.x;
  const int hk = blockIdx.y / head_blocks;
  const int g0 = (blockIdx.y % head_blocks) * kHeads;
  const int heads = min(kHeads, group - g0);
  const int b = blockIdx.z;
  const int c0 = c * kChunk;
  const int p = pos[b * pos_sb];
  const int hi = min(p, smax - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  // a row without a valid key scores every key at -1e30: the mean of V
  const bool none = lo > hi;
  const int klo = none ? c0 : max(lo, c0);
  const int khi = min(none ? smax - 1 : hi, c0 + kChunk - 1);
  const long long part = ((long long)b * hq + hk * group + g0) * chunks + c;

  if (klo > khi) {   // the sentinel partial: m = -inf, l = 0, acc = 0
    if (threadIdx.x < heads) {
      part_m[part + threadIdx.x * chunks] = -INFINITY;
      part_l[part + threadIdx.x * chunks] = 0.f;
    }
    for (int i = threadIdx.x; i < heads * dh; i += blockDim.x)
      part_acc[(part + (i / dh) * chunks) * dh + i % dh] = 0.f;
    return;
  }

  const int team = threadIdx.x / kTeamLanes;
  const int d0 = (threadIdx.x % kTeamLanes) * EPL;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // each team stages its keys' V rows (asynchronously where aligned) and
  // loads their K rows, so the loads share one latency
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  float kr[kKeysPerTeam][EPL];
#pragma unroll
  for (int i = 0; i < kKeysPerTeam; ++i) {
    const int key = klo + team + kTeams * i;
    if (key <= khi) {
      stage_run<T, EPL, VEC>(s_v + (key - c0) * kRow,
                             vb + (long long)key * v_ss, d0, dh);
      load_run<T, EPL, VEC>(kb + (long long)key * k_ss, d0, dh, kr[i]);
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j) kr[i][j] = 0.f;
    }
  }
  if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");

  float qr[kHeads][EPL];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < heads)
      load_run<T, EPL, VEC>(
          q + b * q_sb + (long long)(hk * group + g0 + g) * q_sh, d0, dh,
          qr[g]);
    else
#pragma unroll
      for (int j = 0; j < EPL; ++j) qr[g][j] = 0.f;
  }

  // scores: a per-lane partial dot product, summed over the team's lanes
#pragma unroll
  for (int i = 0; i < kKeysPerTeam; ++i) {
    const int key = klo + team + kTeams * i;
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (g < heads) {
        float sd = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) sd = fmaf(qr[g][j], kr[i][j], sd);
#pragma unroll
        for (int off = kTeamLanes / 2; off > 0; off >>= 1)
          sd += __shfl_xor_sync(0xffffffffu, sd, off);
        if (d0 == 0 && key <= khi)
          s_p[g][key - c0] = none ? kNegInf : sd * scale;
      }
    }
  }
  __syncthreads();

  // a warp per head: the chunk's max, p and sum
  for (int g = warp; g < heads; g += kWarps) {
    const int key = c0 + lane;
    const bool in = key >= klo && key <= khi;
    const float x = in ? s_p[g][lane] : -INFINITY;
    float mx = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e = in ? expf(x - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    s_p[g][lane] = e;
    if (lane == 0) {
      part_m[part + g * chunks] = mx;
      part_l[part + g * chunks] = sum;
    }
  }
  if constexpr (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // p v: a thread per (head, column), over the chunk's valid keys in order
  for (int i = threadIdx.x; i < heads * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    float a = 0.f;
    for (int key = klo - c0; key <= khi - c0; ++key)
      a = fmaf(s_p[g][key], to_f32(s_v[key * kRow + d]), a);
    part_acc[(part + g * chunks) * dh + d] = a;
  }
}

// one block per (batch row, q head), a thread per column: its chunks'
// partials folded in chunk order, kFold chunks at a time.  A thread loads a
// fold's m_c, l_c and acc_c all at once (one round trip to L2), then folds
// them against the running max M: the earlier sums rescaled by
// exp(M_old - M), each partial weighted by exp(m_c - M), a sentinel
// (m_c = -inf) by 0, so no exp(-inf - -inf) is ever taken.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int chunks, int dh) {
  constexpr int kFold = 16;
  const long long bh = blockIdx.x;
  const float* pm = part_m + bh * chunks;
  const float* pl = part_l + bh * chunks;
  const float* pa = part_acc + bh * chunks * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float mx = -INFINITY, l = 0.f, acc = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += kFold) {
      float m[kFold], lv[kFold], a[kFold];
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        const bool in = c0 + j < chunks;
        m[j] = in ? pm[c0 + j] : -INFINITY;
        lv[j] = in ? pl[c0 + j] : 0.f;
        a[j] = in ? pa[(long long)(c0 + j) * dh + d] : 0.f;
      }
      float mn = mx;
#pragma unroll
      for (int j = 0; j < kFold; ++j) mn = fmaxf(mn, m[j]);
      if (mn == -INFINITY) continue;    // sentinels only, so far
      const float r = expf(mx - mn);
      float wl = 0.f, wa = 0.f;
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        const float w = m[j] == -INFINITY ? 0.f : expf(m[j] - mn);
        wl += lv[j] * w;
        wa += a[j] * w;
      }
      l = l * r + wl;
      acc = acc * r + wa;
      mx = mn;
    }
    store(out + bh * dh + d, acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int EPL>
void launch_split_kernel(bool vec, dim3 grid, cudaStream_t stream,
                         const T* q, const T* k, const T* v, const int* pos,
                         float* pm, float* pl, float* pa, int hq, int smax,
                         int dh, int group, int head_blocks, long long q_sb,
                         long long q_sh, long long k_sb, long long k_sh,
                         long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, long long pos_sb, float scale,
                         int window) {
  if constexpr (EPL * sizeof(T) % 16 == 0) {
    if (vec) {
      decode_split_kernel<T, EPL, true><<<grid, kWarps * 32, 0, stream>>>(
          q, k, v, pos, pm, pl, pa, hq, smax, dh, group, head_blocks, q_sb,
          q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, pos_sb, scale, window);
      return;
    }
  }
  decode_split_kernel<T, EPL, false><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, pos, pm, pl, pa, hq, smax, dh, group, head_blocks, q_sb, q_sh,
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, pos_sb, scale, window);
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* pos, void* out, void* partials,
                         int batch, int hq, int hkv, int smax, int dh,
                         long long q_sb, long long q_sh, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, long long pos_sb,
                         float scale, int window, cudaStream_t stream) {
  const int group = hq / hkv;
  const int head_blocks = (group + kHeads - 1) / kHeads;
  const int chunks = (smax + kChunk - 1) / kChunk;
  const int runs = (dh + kTeamLanes - 1) / kTeamLanes;
  const int epl = runs <= 1 ? 1 : runs <= 2 ? 2 : runs <= 4 ? 4
                  : runs <= 8 ? 8 : 16;
  // 16-byte vectors: aligned rows, and runs of whole vectors inside dh
  constexpr long long kPer = 16 / sizeof(T);
  bool vec = dh % epl == 0 && epl % kPer == 0;
  for (const void* p : {q, k, v})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long st : {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss})
    vec = vec && st % kPer == 0;
  const long long n = (long long)batch * hq * chunks;
  float* pm = static_cast<float*>(partials);
  float* pl = pm + n;
  float* pa = pl + n;
  const dim3 grid(chunks, hkv * head_blocks, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(pos);
#define REPRO_SPLIT(E)                                                       \
  launch_split_kernel<T, E>(vec, grid, stream, qt, kt, vt, pt, pm, pl, pa,  \
                            hq, smax, dh, group, head_blocks, q_sb, q_sh,   \
                            k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, pos_sb,     \
                            scale, window)
  switch (epl) {
    case 1: REPRO_SPLIT(1); break;
    case 2: REPRO_SPLIT(2); break;
    case 4: REPRO_SPLIT(4); break;
    case 8: REPRO_SPLIT(8); break;
    default: REPRO_SPLIT(16); break;
  }
#undef REPRO_SPLIT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<(unsigned)((long long)batch * hq), kWarps * 32,
                             0, stream>>>(pm, pl, pa, static_cast<T*>(out),
                                          chunks, dh);
  return cudaGetLastError();
}

}  // namespace

// The split kernel's keys a chunk: the partials scratch holds
// batch * hq * ceil(smax / chunk) * (dh + 2) floats.
extern "C" int repro_decode_attention_chunk(void) { return kChunk; }

// dtype: 0 = float32, 1 = bfloat16.  Every stride is in elements; the last
// dimension of q, k and v must be contiguous.  window <= 0 means no window.
// `partials` is f32 scratch of repro_decode_attention_chunk's size.  Any GQA
// group; dh <= 256.  Returns the first launch error
// (0 on success); the two kernels run asynchronously on `stream`, on the
// current device.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* partials, int dtype, int batch, int hq, int hkv, int smax, int dh,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long pos_sb, float scale, int window, void* stream) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hq % hkv != 0 ||
      (long long)hkv * ((hq / hkv + kHeads - 1) / kHeads) > 65535 ||
      smax <= 0 || dh <= 0 || dh > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_split<float>(q, k, v, pos, out, partials, batch, hq, hkv,
                              smax, dh, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb,
                              v_sh, v_ss, pos_sb, scale, window, s);
  else if (dtype == 1)
    err = launch_split<__nv_bfloat16>(q, k, v, pos, out, partials, batch, hq,
                                      hkv, smax, dh, q_sb, q_sh, k_sb, k_sh,
                                      k_ss, v_sb, v_sh, v_ss, pos_sb, scale,
                                      window, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
