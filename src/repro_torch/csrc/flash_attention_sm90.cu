// Causal / local-window GQA flash attention for Hopper (sm_90a) on the
// tensor cores: wgmma fed by TMA.  Plain C interface.
//
// Replaces: _flash_kernel, src/repro/kernels/flash_attention.py:27
// (pallas_call at :94), for bf16 inputs at head widths 64, 128 and 256.
// f32 inputs and every other bf16 shape run the CUDA-core kernel of
// flash_attention.cu: wgmma on f32 inputs computes in TF32, which the f32
// gates cannot pass.
//
// Computes what flash_attention.cu computes: for qt (B, Hq, Lq, Dh) and
// kt/vt (B, Hkv, Lkv, Dh), query row i at qpos = q_offset + i sees key j
// when qpos >= j (if causal) and qpos - j < window (if a window is set); a
// masked score is the finite -1e30, keys past Lkv get p = 0; the softmax is
// online with m, l and acc in f32, l is clamped at 1e-30, and the result is
// cast once to bf16, contiguous (B, Hq, Lq, Dh).  Under GQA, q head h reads
// kv head h / (Hq/Hkv).  The walked key range is flash_attention.cu's, so a
// row with no valid key comes out as the mean of V over all Lkv keys.
//
// Bound on this card: at qwen3's prefill (B=4, L=256, Hq/Hkv=16/8, Dh=128)
// q, k, v and the output are 12.6 MB, 3.8 us at 3.35 TB/s, and the causal
// products 1.1 us at 989 TFLOP/s; at recurrentgemma's (16/1 heads, Dh=256)
// 5.3 us of bytes.  Bytes bound it; the CUDA-core kernel ran 50-160x over.
//
// Design: one CTA per (tile of 128 q rows, q head, batch): two consumer
// warpgroups of 64 rows each and a producer warpgroup.
// - Loads: one producer thread issues TMA loads: Q once, then K and V
//   tiles of 64 keys into a ring of 2 stages, each stage with a full
//   barrier for K, one for V, and an empty barrier the 256 consumer threads
//   arrive at.  The tensor maps are 4-D over the (B, L, H, Dh) activations
//   that the views stride through, innermost first: (Dh, H, L, B), or
//   (Dh, L, H, B) when the L stride is the smaller; so rows past L are
//   zero-filled and never read from the next batch row.  A 128-byte
//   swizzled row holds 64 bf16 values, so each box is 64 columns wide and
//   a tile of Dh columns is Dh/64 boxes, each its own 1024-byte-aligned
//   chunk of shared memory.
// - S = Q K^T: wgmma.m64n64k16 with both operands K-major in shared memory
//   (128-byte swizzle; a k-step of 16 moves the descriptor's start by 32
//   bytes inside a chunk).  Each k-step is a wgmma of its own into a
//   fragment it overwrites, added to S in order by f32 adds: with the
//   tensor core's own accumulation over the head width (its adds are not
//   f32's round-to-nearest) the kernel was off an f64 attention on more
//   outputs than the CUDA-core kernel (examples/torch_hybrid_loss_noise.py).
//   The k-steps run through a ring of fragments (pipeline), the next one
//   in flight while one is added, so the order of the adds is fixed.
// - Softmax: f32, with exp2f and log2(e) folded into the scale, in the
//   accumulator fragment (each row's max and sum over its 4 lanes).  The
//   masking is skipped on tiles whose every key is valid for every row.
// - O += P V: P converted to bf16 in registers, in the A-fragment layout
//   the S accumulator already has, as three parts, each the bf16 rounding
//   of what the ones before left out: their sum is the f32 p, which the
//   reference keeps (one bf16 p moved recurrentgemma's scoring loss past
//   its bf16 gate).  V is read from shared memory as an MN-major B operand
//   through the descriptor's transpose bit, one m64n64k16 per part, 16
//   keys and 64-column chunk of V.  A tile's P V over each chunk goes into
//   a fragment of its own and is added to O by f32 adds: O summed over the
//   key tiles inside the tensor core, like S over the head width, left the
//   kernel less accurate than the CUDA-core one against f64.  The chunks
//   run through a ring as S's k-steps do.
// - Order: each tile takes its P V, then the next tile's scores, then its
//   softmax; the two warpgroups of a CTA interleave on the SM's tensor
//   cores.  (Issuing the next tile's scores beside P V paid with the
//   tensor core's own accumulation; examples/torch_flash_depths.py times
//   the rings' depths.)
// - Registers: O stays in registers (Dh/2 floats a thread: 128 at Dh=256,
//   with S 32, P's three parts 16 each, and the rings' fragments of 32: at
//   Dh=256 one of P V's and two of S's).  384 threads start at 168
//   registers; the producer warpgroup drops to 40 (setmaxnreg) so the
//   consumers rise to 232, where Dh=256 spills a few bytes (ptxas's
//   report, in chip_smoke.py's build lines; zeroing each fragment before
//   its wgmma spilled 368).  Shared memory: 32 KB of Q and
//   64 KB of K and V stages at Dh=128, 64 KB and 128 KB at Dh=256; one CTA
//   an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kChunkCols = 64;          // bf16 columns in a 128-byte row
constexpr int kChunkRowBytes = 128;
constexpr int kBlockN = 64;             // keys per kv tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;           // warpgroups of 64 q rows
constexpr int kBlockM = 64 * kConsumers;
// and a producer warpgroup; its registers go to the consumers (setmaxnreg):
// 384 threads start at 168 registers, 128 x 40 + 256 x 232 = 384 x 168
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int kChunks = DH / kChunkCols;
  static constexpr int kQChunk = kBlockM * kChunkRowBytes;    // one q chunk
  static constexpr int kKVChunk = kBlockN * kChunkRowBytes;   // one k/v chunk
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;       // a K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // the tiles, 3 barriers a stage and the q barrier, and 1024 bytes of
  // slack to align the base to the 128-byte swizzle's 1024-byte period
  static constexpr int kSmem = kBarOffset + 8 * (3 * kStages + 1) + 1024;
};

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a shared-memory matrix descriptor with the 128-byte swizzle; byte
// offsets in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// wait until at most n (0-3) wgmma groups are in flight; n is a constant
// once the caller's loop is unrolled
__device__ __forceinline__ void wgmma_wait_upto(int n) {
  if (n <= 0)
    wgmma_wait<0>();
  else if (n == 1)
    wgmma_wait<1>();
  else if (n == 2)
    wgmma_wait<2>();
  else
    wgmma_wait<3>();
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the same for P's fragments, which a wgmma reads from registers after its
// issue
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4][3]) {
#pragma unroll
  for (int i = 0; i < 48; ++i)
    asm volatile("" : "+r"(a[i / 12][i / 3 % 4][i % 3]) :: "memory");
}

// N jobs through a ring of D accumulator fragments, up to D - 1 of them
// in flight while the oldest is taken: issue(j, f) puts job j's wgmmas
// into f (one commit group a job; its first wgmma ignores what f held),
// take(j, f) reads job j's result once its group is done.  Jobs are taken
// in order, so a sum the takes make has the order it would have with one
// job in flight.
template <int N, int D, class Issue, class Take>
__device__ __forceinline__ void pipeline(float (&ring)[D][32], Issue&& issue,
                                         Take&& take) {
#pragma unroll
  for (int j = 0; j < N + D - 1; ++j) {
    if (j < N) {
      wgmma_fence();
      issue(j, ring[j % D]);
      wgmma_commit();
    }
    const int k = j - (D - 1);
    if (k >= 0) {
      wgmma_wait_upto(N - 1 - k < D - 1 ? N - 1 - k : D - 1);
      fence_regs(ring[k % D]);
      take(k, ring[k % D]);
    }
  }
}

#define REPRO_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])
#define REPRO_ACC32_LIST                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      REPRO_ACC32_LIST ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 fragments in registers) B (16 x 64,
// MN-major in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      REPRO_ACC32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// a pair of f32 values as three bf16 pairs, each the rounding of what the
// ones before left out: their sum is the f32 pair itself (8 + 8 + 8 bits
// of mantissa; every subtraction is exact)
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    part[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// Fragment layout of a 64 x 64 f32 accumulator in a warpgroup: thread t
// (warp w = t / 32, lane) holds d[4 n + 2 h + j] = element (16 w + lane / 4
// + 8 h, 8 n + 2 (lane % 4) + j), n < 8, h, j < 2.

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, int hq, int lq, int lkv,
                  int group, int q_heads_first, int kv_heads_first,
                  float scale_log2, int causal, int window, int q_offset) {
  using L = Layout<DH>;
  extern __shared__ uint8_t smem_raw[];
  // align the tiles to the swizzle's 1024-byte period
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* sq = smem;
  uint8_t* sk = smem + L::kQBytes;                       // kStages K tiles
  uint8_t* sv = sk + kStages * L::kTileBytes;            // kStages V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  // the keys the CTA walks (flash_attention.cu's range)
  const long long qpos_lo = (long long)q_offset + q0;
  const long long qpos_hi = qpos_lo + min(kBlockM, lq - q0) - 1;
  long long key_lo = 0, key_hi = lkv - 1;
  if (!(window > 0 && qpos_hi >= (long long)lkv - 1 + window)) {
    if (window > 0) key_lo = max(0LL, qpos_lo - window + 1);
    if (causal) key_hi = min(key_hi, qpos_hi);
  }
  const int first = (int)(key_lo / kBlockN);
  const int n_tiles = key_hi < key_lo ? 0 : (int)(key_hi / kBlockN) - first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      // coordinates innermost first: (col, head, row, batch) or
      // (col, row, head, batch)
      auto load = [](void* dst, const CUtensorMap* map, uint64_t* bar,
                     int col, int row, int head, int batch, int heads_first) {
        if (heads_first)
          tma_load(dst, map, bar, col, head, row, batch);
        else
          tma_load(dst, map, bar, col, row, head, batch);
      };
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        load(sq + c * L::kQChunk, &qmap, q_full, c * kChunkCols, q0, h, b,
             q_heads_first);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + s, ((t / kStages) - 1) & 1);
        const int k0 = (first + t) * kBlockN;
        mbar_expect_tx(k_full + s, L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          load(sk + s * L::kTileBytes + c * L::kKVChunk, &kmap, k_full + s,
               c * kChunkCols, k0, hk, b, kv_heads_first);
        mbar_expect_tx(v_full + s, L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          load(sv + s * L::kTileBytes + c * L::kKVChunk, &vmap, v_full + s,
               c * kChunkCols, k0, hk, b, kv_heads_first);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int row_a = (warp % 4) * 16 + lane / 4;     // and row_a + 8
  const int col0 = 2 * (lane % 4);
  // q_offset + Lq fits in int32 (the wrapper checks)
  const int qpos_a = (int)qpos_lo + 64 * wg + row_a;
  const int qpos_b = qpos_a + 8;
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * kChunkRowBytes;

  float o[L::kChunks][32];
  // wgmma groups in flight: S's k-steps kSDepth - 1 beside the one taken,
  // P V's 64-column chunks kPvDepth - 1.  At Dh=256, O's 128 registers and
  // P's 48 leave room for one P V fragment, and, once P is spent, two of S
  constexpr int kSDepth = L::kChunks >= 4 ? 2 : 3;
  constexpr int kPvDepth = L::kChunks >= 4 ? 1 : 2;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float alpha_a = 1.f, alpha_b = 1.f;

  // S = Q K^T of tile t over Dh, each k-step of 16 a wgmma into a
  // fragment of its own, added to S in order by f32 adds
  auto scores = [&](float (&sc)[32], int t) {
    const uint32_t k_addr = smem_u32(sk + (t % kStages) * L::kTileBytes);
    float st[kSDepth][32];
    pipeline<DH / 16>(
        st,
        [&](int kk, float (&f)[32]) {
          wgmma_ss(f,
                   desc(q_addr + (kk / 4) * L::kQChunk + (kk % 4) * 32, 16,
                        1024),
                   desc(k_addr + (kk / 4) * L::kKVChunk + (kk % 4) * 32, 16,
                        1024),
                   0);
        },
        [&](int kk, float (&f)[32]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = (kk == 0 ? 0.f : sc[i]) + f[i];
        });
  };

  // tile t's scores, in the log2 domain (masked -1e30, past Lkv -inf), to
  // P as bf16 A fragments in three parts (one set per 16 keys: the S
  // fragment's layout); the rows' max and sums, and alpha, the rescale of
  // what came before
  auto softmax = [&](float (&sc)[32], uint32_t (&pa)[4][4][3], int t) {
    const int k0 = (first + t) * kBlockN;
    const bool all_valid =
        k0 + kBlockN <= lkv &&
        (!causal || (long long)k0 + kBlockN - 1 <= qpos_lo) &&
        (window <= 0 || qpos_hi - k0 < window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (!all_valid) {
        const int key = k0 + 8 * (i / 4) + col0 + (i % 2);
        const int qpos = (i / 2) % 2 ? qpos_b : qpos_a;
        const bool valid = (!causal || qpos >= key) &&
                           (window <= 0 || qpos - key < window);
        x = key >= lkv ? -INFINITY : (valid ? x : kNegInf);
      }
      sc[i] = x;
      if ((i / 2) % 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    alpha_a = exp2f(m_a - mn_a);
    alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool rb = (i / 2) % 2;
      sc[i] = exp2f(sc[i] - (rb ? mn_b : mn_a));
      if (rb) rs_b += sc[i]; else rs_a += sc[i];
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1], pa[ks][r]);
  };

  // Each step takes this tile's O += P V, then the next tile's scores and
  // softmax.  (A softmax while P V runs, after waiting for the scores
  // alone, made ptxas serialize the wgmmas and ran slower on the card.)
  float sc[32];
  uint32_t pa[4][4][3];
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    mbar_wait(k_full, 0);
    scores(sc, 0);
    softmax(sc, pa, 0);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    // O += P V: V's rows are keys (K), its 64-column chunks N, MN-major.
    // Each chunk's product over the tile's keys is summed in the tensor
    // core into a fragment of its own, then added to O by f32 adds
    mbar_wait(v_full + s, (t / kStages) & 1);
    const uint32_t v_addr = smem_u32(sv + s * L::kTileBytes);
    float pv[kPvDepth][32];
    pipeline<L::kChunks>(
        pv,
        [&](int c, float (&f)[32]) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t dv =
                desc(v_addr + c * L::kKVChunk + ks * 16 * kChunkRowBytes,
                     L::kKVChunk, 1024);
#pragma unroll
            for (int i = 0; i < 3; ++i)
              wgmma_rs(f, pa[ks][0][i], pa[ks][1][i], pa[ks][2][i],
                       pa[ks][3][i], dv, ks > 0 || i > 0);
          }
        },
        [&](int c, float (&f)[32]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] += f[i];
        });
    // P V is done with this tile's P, K and V
    fence_frags(pa);
    mbar_arrive(empty + s);
    if (t + 1 < n_tiles) {
      mbar_wait(k_full + (t + 1) % kStages, ((t + 1) / kStages) & 1);
      scores(sc, t + 1);
      softmax(sc, pa, t + 1);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i / 2) % 2 ? alpha_b : alpha_a;
    }
  }

  // each row's sum over its 4 lanes; one division, one cast
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  const int ra = q0 + 64 * wg + row_a, rb = ra + 8;
  __nv_bfloat16* oa = out + (((long long)b * hq + h) * lq + ra) * DH;
  __nv_bfloat16* ob = oa + 8 * DH;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = c * kChunkCols + 8 * n + col0;
      if (ra < lq)
        *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
            o[c][4 * n] / lc_a, o[c][4 * n + 1] / lc_a);
      if (rb < lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
            o[c][4 * n + 2] / lc_b, o[c][4 * n + 3] / lc_b);
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// libraries link no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (batch, heads, rows, dh) view with element strides
// s_b, s_h, s_r (the last dimension contiguous), boxes of 64 columns by
// `box_rows` rows of one head and one batch row, 128-byte swizzled.  The
// heads and rows dimensions go innermost-first in the order of their
// strides; *heads_first says which came first.
bool make_map(CUtensorMap* map, const void* base, int dh, int heads, int rows,
              int batch, long long s_b, long long s_h, long long s_r,
              int box_rows, int* heads_first) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  *heads_first = s_h <= s_r;
  const cuuint64_t hd = heads, rd = rows;
  const cuuint64_t hs = s_h * 2, rs = s_r * 2;
  cuuint64_t dims[4] = {(cuuint64_t)dh, *heads_first ? hd : rd,
                        *heads_first ? rd : hd, (cuuint64_t)batch};
  cuuint64_t strides[3] = {*heads_first ? hs : rs, *heads_first ? rs : hs,
                           (cuuint64_t)s_b * 2};
  cuuint32_t box[4] = {kChunkCols, *heads_first ? 1u : (cuuint32_t)box_rows,
                       *heads_first ? (cuuint32_t)box_rows : 1u, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* out, int batch, int hq,
                   int lq, int lkv, int group, int q_heads_first,
                   int kv_heads_first, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  constexpr int shmem = Layout<DH>::kSmem;
  static_assert(shmem <= 232448, "a CTA's shared memory exceeds the card's");
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockM - 1) / kBlockM, hq, batch);
  flash_sm90_kernel<DH><<<grid, kThreads, shmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), hq, lq, lkv, group,
      q_heads_first, kv_heads_first, scale * kLog2e, causal, window,
      q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, the only one taken.  dh must be 64, 128 or 256;
// q, k and v 16-byte aligned, every stride (in elements) a positive
// multiple of 8 and the last dimension contiguous.  window <= 0 means no
// window; q_offset >= 0.  The output is contiguous (B, Hq, Lq, Dh).
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a shape
// the kernel does not take or a tensor map the driver refuses); the kernel
// runs asynchronously on `stream`, on the current device.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int hq,
    int hkv, int lq, int lkv, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, int q_offset, void* stream) {
  if (dtype != 1 || batch <= 0 || batch > 65535 || hq <= 0 || hq > 65535 ||
      hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 || q_offset < 0 ||
      !(dh == 64 || dh == 128 || dh == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  for (long long st : strides)
    if (st <= 0 || st % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  int q_hf = 0, k_hf = 0, v_hf = 0;
  if (!make_map(&qm, q, dh, hq, lq, batch, q_sb, q_sh, q_ss, kBlockM, &q_hf) ||
      !make_map(&km, k, dh, hkv, lkv, batch, k_sb, k_sh, k_ss, kBlockN,
                &k_hf) ||
      !make_map(&vm, v, dh, hkv, lkv, batch, v_sb, v_sh, v_ss, kBlockN,
                &v_hf) ||
      k_hf != v_hf)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int group = hq / hkv;
  if (dh == 64)
    err = launch<64>(qm, km, vm, out, batch, hq, lq, lkv, group, q_hf, k_hf,
                     scale, causal, window, q_offset, s);
  else if (dh == 128)
    err = launch<128>(qm, km, vm, out, batch, hq, lq, lkv, group, q_hf, k_hf,
                      scale, causal, window, q_offset, s);
  else
    err = launch<256>(qm, km, vm, out, batch, hq, lq, lkv, group, q_hf, k_hf,
                      scale, causal, window, q_offset, s);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
