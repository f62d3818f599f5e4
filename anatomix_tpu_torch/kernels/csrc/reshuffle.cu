// Factor-2 space-to-depth and depth-to-space on channels-last volumes, the
// two layout permutations of the pretraining step's train walk, written by
// hand for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   L  anatomix_tpu/ops/pallas/reshuffle.py  space_to_depth  (:620)
//   L  anatomix_tpu/ops/pallas/reshuffle.py  depth_to_space  (:90, without
//      its `sub` operand, which only the ViT's exit uses)
// computing, for x (B, 2d, 2h, 2w, C) and its block layout xb (B, d, h, w,
// 8 C) with sub-position-major channels,
//   xb[b, i, j, k, ((ad * 2 + ah) * 2 + aw) * C + c]
//     = x[b, 2 i + ad, 2 j + ah, 2 k + aw, c].
// Each is the other's inverse and its adjoint, so the backward of one is
// the other (the JAX package's `space_to_depth_vjp` / `depth_to_space_vjp`).
// The values are moved, never converted: any 2- or 4-byte element type.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once, with no arithmetic (the 6M step's largest, (2, 128^3, 16) bf16:
// 134 MB each way, 0.080 ms at 3.35 TB/s). The design walks the OUTPUT in
// order, one thread per unit of 16 bytes where the channel run of one voxel
// (C elements) is a multiple of 16 bytes and both pointers are 16-byte
// aligned, else of the largest power of two that divides the run: stores
// are fully coalesced, and each thread's load is a whole unit of a run that
// its neighbours continue, so every byte is read once in runs of C elements.
// Indices are 32-bit (the launcher refuses more than 2^31 - 1 units).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

// S2D: out is the block layout (B, d, h, w, 8, R units), in is spatial.
// D2S: out is spatial (B, 2d, 2h, 2w, R units), in is the block layout.
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
    const uint32_t g = t % 8;
    t /= 8;
    const uint32_t k = t % w;
    t /= w;
    const uint32_t j = t % h;
    t /= h;
    const uint32_t i = t % d;
    const uint32_t b = t / d;
    const uint32_t Z = 2 * i + (g >> 2), Y = 2 * j + ((g >> 1) & 1),
                   X = 2 * k + (g & 1);
    src = (((b * 2 * d + Z) * 2 * h + Y) * 2 * w + X) * R + r;
  } else {
    const uint32_t X = t % (2 * w);
    t /= 2 * w;
    const uint32_t Y = t % (2 * h);
    t /= 2 * h;
    const uint32_t Z = t % (2 * d);
    const uint32_t b = t / (2 * d);
    const uint32_t g = (Z & 1) * 4 + (Y & 1) * 2 + (X & 1);
    src = ((((b * d + (Z >> 1)) * h + (Y >> 1)) * w + (X >> 1)) * 8 + g) * R +
          r;
  }
  out[e] = in[src];
}

template <bool S2D>
int launch(const void* in, void* out, int B, int d, int h, int w, int C,
           int elem_bytes, void* stream) {
  if (B < 0 || d < 0 || h < 0 || w < 0 || C < 0 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t run = (int64_t)C * elem_bytes;  // bytes of one voxel
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  int unit = 16;
  while (unit > elem_bytes && (run % unit || align % unit)) unit /= 2;
  const int64_t n_units = (int64_t)B * 8 * d * h * w * (run / unit);
  if (n_units == 0) return 0;
  if (n_units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t R = (uint32_t)(run / unit);
  const unsigned blocks = (unsigned)((n_units + NTHREADS - 1) / NTHREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t n = (uint32_t)n_units;
#define RESHUFFLE2_LAUNCH(T)                                                \
  reshuffle2_kernel<T, S2D><<<blocks, NTHREADS, 0, st>>>(                   \
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
