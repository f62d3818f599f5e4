// The factor-2 block-layout permutations of the port on channels-last
// volumes, written by hand for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   L     anatomix_tpu/ops/pallas/reshuffle.py  space_to_depth  (:620)
//   L     anatomix_tpu/ops/pallas/reshuffle.py  depth_to_space  (:90)
//   L-il  anatomix_tpu/ops/pallas/reshuffle.py  depth_to_space_interleave
//         (:194, its optional f32 subtract and output cast)
//   L-fold anatomix_tpu/ops/pallas/reshuffle.py depth_to_space_fold (:305)
//   L-c1  anatomix_tpu/ops/pallas/reshuffle.py  space_to_depth_c1  (:580)
// computing, for x (B, 2d, 2h, 2w, C) and its block layout xb (B, d, h, w,
// 8 C) with sub-position-major channels,
//   xb[b, i, j, k, ((ad * 2 + ah) * 2 + aw) * C + c]
//     = x[b, 2 i + ad, 2 j + ah, 2 k + aw, c].
// space_to_depth2 / depth_to_space2 move any 2- or 4-byte element type and
// are each other's inverse and adjoint (the backward of one is the other).
// depth_to_space2_sub reads bf16 or f32, subtracts sub[b, lane] (B, 8 C) f32
// in f32 when given, and rounds once to bf16 or f32 (round to nearest even,
// as torch's `.to`). The TPU's interleave and fold kernels differ only in the
// minor layout they store, `(2w, C)` rows or `(2w C / 128, 128)` rows; on
// this card both are the same row-major bytes of the channels-last volume,
// so one kernel serves both and the fold form is a view of its output.
// space_to_depth_c1 packs a channel-less (B, 2d, 2h, 2w) volume into (B, d,
// h, w, 8) in the same lane order (`conv3x3.space_to_depth_4d`'s).
//
// What bounds them on an H100: bytes. Each element is read once and written
// once, with at most one subtract (the ViT's fold exit, B2 64^3 x 256 bf16
// -> 128^3 x 32 bf16: 268 MB each way, 0.080 ms at 3.35 TB/s each way). The
// design uses the block layout's one contiguity: the two W-neighbours
// (2k, 2k + 1) of an output row are one contiguous run of 2 C elements in
// the block layout (aw sits directly above c), so every kernel walks the
// OUTPUT in order, one thread per unit of such a run (16 bytes where the run
// length and both pointers allow, else the largest power of two that
// divides them; an odd C such as the ViT decoder's 99 still moves 4-byte
// units of its 198-element runs). Stores are fully coalesced and each
// thread's load is a unit of a run its neighbours continue, so every byte is
// read once in runs of 2 C elements. The c1 kernel writes one 8-lane voxel
// per thread from four 2-element pairs. Indices are 32-bit (the launchers
// refuse more than 2^31 - 1 units).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// S2D: out is the block layout (B, d, h, w, 4 planes (ad, ah), R units),
//      in is spatial (B, 2d, 2h, w, R units): one unit row = the 2 C run of
//      W-voxels (2k, 2k + 1).
// D2S: out is spatial (B, 2d, 2h, w, R units), in is the block layout.
template <typename U, bool S2D>
__global__ void __launch_bounds__(NTHREADS)
reshuffle2_kernel(const U* __restrict__ in, U* __restrict__ out,
                  uint32_t n_units, uint32_t d, uint32_t h, uint32_t w,
                  uint32_t R) {
  const uint32_t e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= n_units) return;
  const uint32_t r = e % R;
  uint32_t t = e / R;
  uint32_t src;
  if constexpr (S2D) {
    const uint32_t p = t % 4;
    t /= 4;
    const uint32_t k = t % w;
    t /= w;
    const uint32_t j = t % h;
    t /= h;
    const uint32_t i = t % d;
    const uint32_t b = t / d;
    const uint32_t Z = 2 * i + (p >> 1), Y = 2 * j + (p & 1);
    src = (((b * 2 * d + Z) * 2 * h + Y) * w + k) * R + r;
  } else {
    const uint32_t k = t % w;
    t /= w;
    const uint32_t Y = t % (2 * h);
    t /= 2 * h;
    const uint32_t Z = t % (2 * d);
    const uint32_t b = t / (2 * d);
    const uint32_t p = (Z & 1) * 2 + (Y & 1);
    src = ((((b * d + (Z >> 1)) * h + (Y >> 1)) * w + k) * 4 + p) * R + r;
  }
  out[e] = in[src];
}

// out spatial (B, 2d, 2h, w, C2 = 2 C) in To, from the block layout in Ti,
// minus sub (B, 4 * C2) f32 when SUB; V elements per thread.
template <typename Ti, typename To, int V, bool SUB>
__global__ void __launch_bounds__(NTHREADS)
d2s2_sub_kernel(const Ti* __restrict__ in, const float* __restrict__ sub,
                To* __restrict__ out, uint32_t n_vec, uint32_t d, uint32_t h,
                uint32_t w, uint32_t C2) {
  const uint32_t e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= n_vec) return;
  const uint32_t R = C2 / V;
  const uint32_t r = e % R;
  uint32_t t = e / R;
  const uint32_t k = t % w;
  t /= w;
  const uint32_t Y = t % (2 * h);
  t /= 2 * h;
  const uint32_t Z = t % (2 * d);
  const uint32_t b = t / (2 * d);
  const uint32_t p = (Z & 1) * 2 + (Y & 1);
  const uint32_t src =
      ((((b * d + (Z >> 1)) * h + (Y >> 1)) * w + k) * 4 + p) * C2 + r * V;
  const Vec<Ti, V> x = *reinterpret_cast<const Vec<Ti, V>*>(in + src);
  Vec<To, V> y;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    float f = to_f32(x.v[q]);
    if constexpr (SUB) f -= sub[(b * 4 + p) * C2 + r * V + q];
    y.v[q] = from_f32<To>(f);
  }
  *reinterpret_cast<Vec<To, V>*>(out + (size_t)e * V) = y;
}

// x (B, 2d, 2h, 2w) -> out (B, d, h, w, 8), one output voxel per thread:
// lanes (2 p, 2 p + 1) = the pair x[b, 2 i + ad, 2 j + ah, 2 k .. 2 k + 1]
// of plane p = ad * 2 + ah. VEC: 2-element loads and one 8-element store
// (both pointers aligned), else element by element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
s2d_c1_kernel(const T* __restrict__ x, T* __restrict__ out, uint32_t n_vox,
              uint32_t d, uint32_t h, uint32_t w) {
  const uint32_t e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= n_vox) return;
  uint32_t t = e;
  const uint32_t k = t % w;
  t /= w;
  const uint32_t j = t % h;
  t /= h;
  const uint32_t i = t % d;
  const uint32_t b = t / d;
  Vec<T, 8> y;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t src =
        (((b * 2 * d + 2 * i + (p >> 1)) * 2 * h + 2 * j + (p & 1)) * 2 * w) +
        2 * k;
    if constexpr (VEC) {
      const Vec<T, 2> pair = *reinterpret_cast<const Vec<T, 2>*>(x + src);
      y.v[2 * p] = pair.v[0];
      y.v[2 * p + 1] = pair.v[1];
    } else {
      y.v[2 * p] = x[src];
      y.v[2 * p + 1] = x[src + 1];
    }
  }
  if constexpr (VEC) {
    *reinterpret_cast<Vec<T, 8>*>(out + (size_t)e * 8) = y;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) out[(size_t)e * 8 + q] = y.v[q];
  }
}

inline unsigned n_blocks(int64_t n) {
  return (unsigned)((n + NTHREADS - 1) / NTHREADS);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool S2D>
int launch(const void* in, void* out, int B, int d, int h, int w, int C,
           int elem_bytes, void* stream) {
  if (B < 0 || d < 0 || h < 0 || w < 0 || C < 0 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t run = 2LL * C * elem_bytes;  // bytes of one W-voxel pair
  int unit = 16;
  while (unit > elem_bytes &&
         (run % unit || !aligned(in, unit) || !aligned(out, unit)))
    unit /= 2;
  const int64_t n_units = (int64_t)B * 8 * d * h * w * (run / unit) / 2;
  if (n_units == 0) return 0;
  if (n_units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t R = (uint32_t)(run / unit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t n = (uint32_t)n_units;
#define RESHUFFLE2_LAUNCH(T)                                                \
  reshuffle2_kernel<T, S2D><<<n_blocks(n), NTHREADS, 0, st>>>(              \
      static_cast<const T*>(in), static_cast<T*>(out), n, d, h, w, R)
  switch (unit) {
    case 16: RESHUFFLE2_LAUNCH(uint4); break;
    case 8: RESHUFFLE2_LAUNCH(uint2); break;
    case 4: RESHUFFLE2_LAUNCH(uint32_t); break;
    default: RESHUFFLE2_LAUNCH(uint16_t); break;
  }
#undef RESHUFFLE2_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename Ti, typename To, int V>
void launch_sub(const void* in, const float* sub, void* out, uint32_t n,
                int d, int h, int w, int C2, cudaStream_t st) {
  const Ti* x = static_cast<const Ti*>(in);
  To* y = static_cast<To*>(out);
  if (sub)
    d2s2_sub_kernel<Ti, To, V, true><<<n_blocks(n), NTHREADS, 0, st>>>(
        x, sub, y, n, d, h, w, C2);
  else
    d2s2_sub_kernel<Ti, To, V, false><<<n_blocks(n), NTHREADS, 0, st>>>(
        x, sub, y, n, d, h, w, C2);
}

template <typename Ti, typename To>
int launch_sub_v(const void* in, const float* sub, void* out, int B, int d,
                 int h, int w, int C, cudaStream_t st) {
  const int C2 = 2 * C;
  int V = 8;
  while (V > 1 && (C2 % V || !aligned(in, V * (int)sizeof(Ti)) ||
                   !aligned(out, V * (int)sizeof(To))))
    V /= 2;
  const int64_t n_vec = (int64_t)B * 4 * d * h * w * C2 / V;
  if (n_vec == 0) return 0;
  if (n_vec > 0x7fffffffLL ||
      (int64_t)B * 8 * d * h * w * C > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t n = (uint32_t)n_vec;
  switch (V) {
    case 8: launch_sub<Ti, To, 8>(in, sub, out, n, d, h, w, C2, st); break;
    case 4: launch_sub<Ti, To, 4>(in, sub, out, n, d, h, w, C2, st); break;
    case 2: launch_sub<Ti, To, 2>(in, sub, out, n, d, h, w, C2, st); break;
    default: launch_sub<Ti, To, 1>(in, sub, out, n, d, h, w, C2, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_c1(const void* x, void* out, int B, int d, int h, int w,
              cudaStream_t st) {
  const int64_t n_vox = (int64_t)B * d * h * w;
  if (n_vox == 0) return 0;
  if (n_vox * 8 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t n = (uint32_t)n_vox;
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(out);
  if (aligned(x, 2 * sizeof(T)) && aligned(out, 8 * sizeof(T)))
    s2d_c1_kernel<T, true><<<n_blocks(n), NTHREADS, 0, st>>>(src, dst, n, d,
                                                             h, w);
  else
    s2d_c1_kernel<T, false><<<n_blocks(n), NTHREADS, 0, st>>>(src, dst, n, d,
                                                              h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, 2d, 2h, 2w, C) -> xb (B, d, h, w, 8 C); elements of elem_bytes
extern "C" int space_to_depth2_ndhwc(const void* x, void* xb, int B, int d,
                                     int h, int w, int C, int elem_bytes,
                                     void* stream) {
  return launch<true>(x, xb, B, d, h, w, C, elem_bytes, stream);
}

// xb (B, d, h, w, 8 C) -> x (B, 2d, 2h, 2w, C); elements of elem_bytes
extern "C" int depth_to_space2_ndhwc(const void* xb, void* x, int B, int d,
                                     int h, int w, int C, int elem_bytes,
                                     void* stream) {
  return launch<false>(xb, x, B, d, h, w, C, elem_bytes, stream);
}

// yb (B, d, h, w, 8 C) bf16 (in_f32 = 0) or f32 -> (B, 2d, 2h, 2w, C) bf16
// (out_f32 = 0) or f32, minus sub (B, 8 C) f32 when sub is not null. The
// interleave and the fold exits both launch this; each keeps its own entry
// point so that each is named where it launches.
static int d2s2_sub(const void* yb, const void* sub, void* out, int B, int d,
                    int h, int w, int C, int in_f32, int out_f32,
                    void* stream) {
  if (B < 0 || d < 0 || h < 0 || w < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sub);
  if (in_f32)
    return out_f32
               ? launch_sub_v<float, float>(yb, s, out, B, d, h, w, C, st)
               : launch_sub_v<float, __nv_bfloat16>(yb, s, out, B, d, h, w,
                                                    C, st);
  return out_f32 ? launch_sub_v<__nv_bfloat16, float>(yb, s, out, B, d, h, w,
                                                      C, st)
                 : launch_sub_v<__nv_bfloat16, __nv_bfloat16>(
                       yb, s, out, B, d, h, w, C, st);
}

extern "C" int depth_to_space_interleave_ndhwc(const void* yb,
                                               const void* sub, void* out,
                                               int B, int d, int h, int w,
                                               int C, int in_f32, int out_f32,
                                               void* stream) {
  return d2s2_sub(yb, sub, out, B, d, h, w, C, in_f32, out_f32, stream);
}

extern "C" int depth_to_space_fold_ndhwc(const void* yb, const void* sub,
                                         void* out, int B, int d, int h,
                                         int w, int C, int in_f32,
                                         int out_f32, void* stream) {
  return d2s2_sub(yb, sub, out, B, d, h, w, C, in_f32, out_f32, stream);
}

// x (B, 2d, 2h, 2w) -> (B, d, h, w, 8); elements of elem_bytes (2 or 4)
extern "C" int space_to_depth_c1_ndhwc(const void* x, void* out, int B,
                                       int d, int h, int w, int elem_bytes,
                                       void* stream) {
  if (B < 0 || d < 0 || h < 0 || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch_c1<uint16_t>(x, out, B, d, h, w, st);
  if (elem_bytes == 4) return launch_c1<uint32_t>(x, out, B, d, h, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
