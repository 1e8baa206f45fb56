// Rotary position embedding for Hopper (sm_90a), plain C interface.
//
// Replaces: _rope_kernel, src/repro/kernels/rope.py:19 (pallas_call at
// :44; the Pallas TPU kernel the reference's kernel mode runs on q and on k
// in every attention layer).
//
// Computes, for x (rows, H * head_dim) of f32 or bf16 with rows of stride
// x_stride and positions (rows,) of int32 or int64, half = head_dim / 2 and
// every value in f32:
//   e = i / half                      (IEEE division)
//   freq = (float)pow((double)theta, -(double)e)
//   ang = (float)pos * freq
//   c = (float)cos((double)ang);  s = (float)sin((double)ang)
//   out[row, h, i]        = x1 * c - x2 * s
//   out[row, h, half + i] = x2 * c + x1 * s
// with x1 = x[row, h, i], x2 = x[row, h, half + i], each output rounded once
// to x's dtype; out is contiguous (rows, H * head_dim).  These are the
// reference's f32 steps as XLA compiles them (its 1 / theta^e becomes
// theta^-e, one rounding; the power and the trig functions through f64, so
// that their f32 values are correctly rounded), and the operations of the
// Triton kernel this one replaced (since retired), rounding for rounding:
// the two gave the same bits.  rope_plain (kernels/rope.py) computes the
// same steps.
//
// Bound on this card: the bytes.  x read once, out written once: at
// nemotron-4-15b's prefill (1024 rows of 48 q heads of 128, bf16) 25.2 MB,
// 7.5 us at 3.35 TB/s.  The angles are compute, but in f64 (half the f32
// rate on an H100) and latency: pow, and cos and sin, are each a chain of
// some hundred dependent f64 operations and table loads, about half a
// microsecond, on the path of every output.
//
// The Triton kernel gave each token row one program: 4 programs at a decode
// step on 132 SMs, heads padded to a power of two, and each program's trig
// chain ahead of its row's loads.  Here:
//
// * freq depends on theta and i alone, so repro_rope_freq computes the
//   half values once (the wrapper keeps them on the card by theta and
//   half), with the operations above; pow leaves every launch's path.
// * A block takes R rows and a chunk of Hc heads, chosen by the wrapper
//   (rope.block_plan): the heads of a row whole where they fit, split
//   where a decode step's few rows would leave the card idle; no head is
//   padded.  Its threads, three phases:
// * Loads: each rotating thread owns V elements of x1 and the matching V of
//   x2 for one (row, head): 16 bytes of each (8 bf16 or 4 f32) where the
//   wrapper found the rows 16-byte aligned, one element else (the scalar
//   path of the same kernel).  Both loads are issued first, as read-only
//   loads, and stay in registers through the table.
// * Table: every thread of the block computes c and s of (row, i) pairs
//   into shared memory, R x half of them, once for the block's rows and not
//   once a head (a block has at least as many threads as pairs, up to
//   kMaxThreads); sincos shares one range reduction between the two and
//   gives cos's and sin's bits.
// * Rotate: each rotating thread reads the V (c, s) pairs of its row and
//   rotates its elements with the Triton kernel's operations (below), then
//   one 16-byte store of each half.
//
// The Triton kernel's PTX (triton 3.6, sm_90a) contracts each product pair
// into one FMA: x1 * c - x2 * s as fma(x1, c, -(x2 * s)) and x2 * c + x1 * s
// as fma(x1, s, x2 * c).  The rotation below spells exactly those with
// __fmaf_rn / __fmul_rn, so nvcc cannot contract them otherwise; each of
// the four other ways to round the pair differs from the Triton kernel in
// about a third of the f32 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;        // a block's threads
constexpr int kMaxShared = 48 * 1024;   // static-launch shared memory

// refusals of the C entry points, negative so they never meet a cudaError_t
constexpr int kBadDtype = -2;
constexpr int kBadShape = -3;
constexpr int kBadPlan = -4;
constexpr int kMisaligned = -5;

// V elements of T from one load: a 16-byte read-only load where V makes 16
// bytes, else one element
template <typename T, int V>
struct Chunk {
  using Raw = std::conditional_t<V * sizeof(T) == 16, uint4, T>;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (std::is_same_v<Raw, uint4>)
      raw = __ldg(reinterpret_cast<const uint4*>(p));
    else
      raw = p[0];
  }
  __device__ __forceinline__ void floats(float* f) const {
    if constexpr (std::is_same_v<Raw, uint4>) {
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (std::is_same_v<T, float>) {
          f[k] = __uint_as_float(w[k]);
        } else {
          f[2 * k] = __uint_as_float(w[k] << 16);
          f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
      }
    } else if constexpr (std::is_same_v<T, float>) {
      f[0] = raw;
    } else {
      f[0] = __bfloat162float(raw);
    }
  }
};

// V floats rounded once to T, stored as one 16-byte store where V makes 16
// bytes, else one element
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (V * sizeof(T) == 16) {
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
  } else if constexpr (std::is_same_v<T, float>) {
    p[0] = f[0];
  } else {
    p[0] = __float2bfloat16_rn(f[0]);
  }
}

struct Shape {
  long long rows, x_stride, pos_stride;
  int H, half, R, Hc;
};

// freq[i] = (float)pow((double)theta, -(double)(i / half))
__global__ void freq_kernel(float* __restrict__ freq, int half, float theta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= half) return;
  const float e = __fdiv_rn(static_cast<float>(i), static_cast<float>(half));
  freq[i] = static_cast<float>(
      pow(static_cast<double>(theta), -static_cast<double>(e)));
}

// one block: rows [blockIdx.x * R, + R) and heads [blockIdx.y * Hc, + Hc);
// the first R * Hc * (half / V) threads rotate, all compute the table
template <typename T, typename P, int V>
__global__ void __launch_bounds__(kMaxThreads)
rope_kernel(const T* __restrict__ x, const P* __restrict__ pos,
            const float* __restrict__ freq, T* __restrict__ out, Shape a) {
  extern __shared__ float2 cs[];   // [R][half]: (cos, sin)

  const int tid = threadIdx.x;
  const int lanes = a.half / V;
  const int lane = tid % lanes;
  const int hh = tid / lanes % a.Hc;
  const int r = tid / (lanes * a.Hc);
  const long long row0 = static_cast<long long>(blockIdx.x) * a.R;
  const long long row = row0 + r;
  const int head = blockIdx.y * a.Hc + hh;
  const bool rotates = r < a.R && row < a.rows;

  // loads first: in flight through the table
  Chunk<T, V> c1, c2;
  const long long col = static_cast<long long>(head) * 2 * a.half + lane * V;
  if (rotates) {
    const T* src = x + row * a.x_stride + col;
    c1.load(src);
    c2.load(src + a.half);
  }

  // (cos, sin) of every (row, i) of the block's rows
  const int n = static_cast<int>(min(static_cast<long long>(a.R),
                                     a.rows - row0)) * a.half;
  for (int k = tid; k < n; k += blockDim.x) {
    const int rr = k / a.half;
    const float pf = static_cast<float>(pos[(row0 + rr) * a.pos_stride]);
    const float ang = __fmul_rn(pf, __ldg(freq + k - rr * a.half));
    double s, c;
    sincos(static_cast<double>(ang), &s, &c);
    cs[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
  __syncthreads();
  if (!rotates) return;

  const float2* t = cs + r * a.half + lane * V;
  float x1[V], x2[V], y1[V], y2[V];
  c1.floats(x1);
  c2.floats(x2);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float c = t[j].x, s = t[j].y;
    y1[j] = __fmaf_rn(x1[j], c, -__fmul_rn(x2[j], s));
    y2[j] = __fmaf_rn(x1[j], s, __fmul_rn(x2[j], c));
  }
  T* dst = out + row * (static_cast<long long>(a.H) * 2 * a.half) + col;
  store<T, V>(dst, y1);
  store<T, V>(dst + a.half, y2);
}

template <typename T, typename P, int V>
cudaError_t launch(const void* x, const void* pos, const float* freq,
                   void* out, const Shape& a, int threads,
                   cudaStream_t stream) {
  const dim3 grid((a.rows + a.R - 1) / a.R, a.H / a.Hc);
  rope_kernel<T, P, V><<<grid, threads, sizeof(float2) * a.R * a.half,
                         stream>>>(static_cast<const T*>(x),
                                   static_cast<const P*>(pos), freq,
                                   static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch(int vec, const void* x, const void* pos,
                     const float* freq, void* out, const Shape& a,
                     int threads, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch<T, P, kVec>(x, pos, freq, out, a, threads, stream);
  return launch<T, P, 1>(x, pos, freq, out, a, threads, stream);
}

__global__ void empty_kernel() {}

}  // namespace

// freq (half,) f32: theta^-(i / half) with the operations of the note
// above, which repro_rope takes.  Refuses half < 1 (-3); else returns the
// launch's cudaError_t.
extern "C" int repro_rope_freq(void* freq, int half, float theta,
                               void* stream) {
  if (half < 1) return kBadShape;
  freq_kernel<<<(half + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(freq), half, theta);
  return static_cast<int>(cudaGetLastError());
}

// x_dtype: 0 = float32, 1 = bfloat16 (out takes x's); pos_dtype: 0 = int32,
// 1 = int64.  x is (rows, H * 2 * half) with rows x_stride elements apart
// and unit column stride; pos (rows,) with pos_stride; freq is
// repro_rope_freq's (half,) table for theta; out contiguous.
// rows_per_block (R), heads_per_block (Hc, a divisor of H) and vec (V: 1,
// or 16 / itemsize for 16-byte loads) are the wrapper's plan; the kernel
// runs max(R * Hc * half / V, R * half) threads a block, at most 512,
// rounded up to a warp.  Refused before any launch, with a negative code
// that repro_cuda_error_string names: a dtype code other than those (-2),
// an empty or inconsistent shape (-3), a plan that leaves heads out, pads
// a head (half not a multiple of V) or needs more than 512 rotating
// threads or 48 KB of shared memory a block (-4), V > 1 with x, out or the
// row stride not 16-byte aligned (-5).  Otherwise returns the launch's
// cudaError_t (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int repro_rope(const void* x, const void* pos, const void* freq,
                          void* out, int x_dtype, int pos_dtype,
                          long long rows, int H, int half, long long x_stride,
                          long long pos_stride, int rows_per_block,
                          int heads_per_block, int vec, void* stream) {
  if (x_dtype != 0 && x_dtype != 1) return kBadDtype;
  if (pos_dtype != 0 && pos_dtype != 1) return kBadDtype;
  if (rows < 1 || H < 1 || half < 1 || x_stride < 2LL * half * H)
    return kBadShape;
  const Shape a{rows, x_stride, pos_stride, H, half, rows_per_block,
                heads_per_block};
  const int itemsize = x_dtype == 0 ? 4 : 2;
  if (a.R < 1 || a.Hc < 1 || H % a.Hc || (vec != 1 && vec != 16 / itemsize) ||
      half % vec || (rows + a.R - 1) / a.R > 0x7fffffffLL ||
      H / a.Hc > 65535)
    return kBadPlan;
  const long long rotating = 1LL * a.R * a.Hc * (half / vec);
  const long long pairs = 1LL * a.R * half;
  if (rotating > kMaxThreads || 8 * pairs > kMaxShared) return kBadPlan;
  long long threads = rotating > pairs ? rotating : pairs;
  threads = threads > kMaxThreads ? kMaxThreads : (threads + 31) / 32 * 32;
  if (vec != 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                         (x_stride * itemsize) % 16 == 0;
    if (!aligned) return kMisaligned;
  }
  const float* f = static_cast<const float*>(freq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = static_cast<int>(threads);
  cudaError_t err;
  if (x_dtype == 0)
    err = pos_dtype == 0
              ? dispatch<float, int>(vec, x, pos, f, out, a, nt, st)
              : dispatch<float, long long>(vec, x, pos, f, out, a, nt, st);
  else
    err = pos_dtype == 0
              ? dispatch<__nv_bfloat16, int>(vec, x, pos, f, out, a, nt, st)
              : dispatch<__nv_bfloat16, long long>(vec, x, pos, f, out, a, nt,
                                                   st);
  return static_cast<int>(err);
}

// An empty kernel, `blocks` blocks of one warp: the floor of a launch, which
// the card check times back to back and in a CUDA-graph replay.  Returns
// the launch's cudaError_t.
extern "C" int repro_empty_kernel(int blocks, void* stream) {
  empty_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  switch (code) {
    case kBadDtype:
      return "x must be float32 or bfloat16 and positions int32 or int64";
    case kBadShape:
      return "empty or inconsistent shape: rows, heads and half >= 1, the "
             "row stride at least the row";
    case kBadPlan:
      return "block plan refused: heads a block must divide the heads, half "
             "a multiple of the vector, at most 512 rotating threads and 48 "
             "KB of shared memory a block";
    case kMisaligned:
      return "16-byte loads need x, out and the row stride 16-byte aligned";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
