// Exact 2x trilinear upsample (torch `Upsample(scale_factor=2,
// mode="trilinear", align_corners=False)`) of channels-last (NDHWC) bf16
// volumes, written by hand for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   D2  anatomix_tpu/ops/pallas/upsample.py  upsample2x_trilinear_block_pallas
// which emits the result in the TPU's space-to-depth block layout; this one
// writes plain NDHWC (B, 2d, 2h, 2w, C). Per axis, output 2i is
// 0.75 * x[i] + 0.25 * x[i - 1] and output 2i + 1 is 0.75 * x[i] +
// 0.25 * x[i + 1], with the source index clamped to [0, n - 1] at the edges
// (torch's boundary rule). The 8-corner product of the three axes' weights
// is summed in f32 and rounded to bf16 once. With `split`, input and output
// are the three-term split (B, ., ., ., 3 C) [hi | lo | hi] of an f32
// volume (`norm_apply.cu`): the kernel reads hi + lo and writes the split
// of its f32 result, so the live-norm UNet's decoder keeps f32 values.
//
// What bounds it on an H100: bytes. Each output element is written once
// (2 bytes) and each input element is needed once (2 bytes per 8 outputs);
// the 8 corner reads of neighbouring outputs overlap and hit L1/L2. The
// design: one thread per 8 consecutive channels of one output voxel, eight
// 16-byte corner loads and one 16-byte store, consecutive threads on
// consecutive output addresses. Channel counts that are not a multiple of 8
// take the same kernel with one channel per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  Pack8 in;
  in.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(in.h[j]);
}

template <int V, bool SPLIT>
__global__ void __launch_bounds__(NTHREADS)
upsample2x_trilinear_kernel(const __nv_bfloat16* __restrict__ x,
                            __nv_bfloat16* __restrict__ out,
                            int64_t n_items, int d, int h, int w, int C) {
  // element stride of one voxel: C, or 3 C for the split form
  constexpr int S = SPLIT ? 3 : 1;
  const int G = C / V;
  const int64_t first = (int64_t)blockIdx.x * NTHREADS;
  const int64_t e = first + threadIdx.x;
  if (e >= n_items) return;
  // output voxel and channel group (the launcher keeps voxels below 2^31)
  const int64_t v0 = first / G;
  const int local = (int)(first - v0 * G) + threadIdx.x;
  const int v = (int)(v0 + local / G);
  const int c = (local % G) * V;
  const int W2 = 2 * w, H2 = 2 * h, D2 = 2 * d;
  const int ox = v % W2;
  int r = v / W2;
  const int oy = r % H2;
  r /= H2;
  const int oz = r % D2;
  const int b = r / D2;
  // per axis: the source voxel and its neighbour toward the output voxel
  int iz[2], iy[2], ix[2];
  iz[0] = oz >> 1;
  iz[1] = (oz & 1) ? min(iz[0] + 1, d - 1) : max(iz[0] - 1, 0);
  iy[0] = oy >> 1;
  iy[1] = (oy & 1) ? min(iy[0] + 1, h - 1) : max(iy[0] - 1, 0);
  ix[0] = ox >> 1;
  ix[1] = (ox & 1) ? min(ix[0] + 1, w - 1) : max(ix[0] - 1, 0);
  const float wt[2] = {0.75f, 0.25f};
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
  for (int kz = 0; kz < 2; ++kz) {
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
        const float wgt = wt[kz] * wt[ky] * wt[kx];
        const int64_t src =
            ((((int64_t)b * d + iz[kz]) * h + iy[ky]) * w + ix[kx]) * S * C +
            c;
        if constexpr (V == 8) {
          float in[8];
          load8(x + src, in);
          if constexpr (SPLIT) {
            float lo[8];
            load8(x + src + C, lo);
#pragma unroll
            for (int j = 0; j < 8; ++j) in[j] += lo[j];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += wgt * in[j];
        } else {
          float in = __bfloat162float(x[src]);
          if constexpr (SPLIT) in += __bfloat162float(x[src + C]);
          acc[0] += wgt * in;
        }
      }
    }
  }
  const int64_t o = (int64_t)v * S * C + c;
  if constexpr (V == 8) {
    Pack8 hi, lo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hi.h[j] = __float2bfloat16(acc[j]);
      lo.h[j] = __float2bfloat16(acc[j] - __bfloat162float(hi.h[j]));
    }
    *reinterpret_cast<uint4*>(out + o) = hi.u;
    if constexpr (SPLIT) {
      *reinterpret_cast<uint4*>(out + o + C) = lo.u;
      *reinterpret_cast<uint4*>(out + o + 2 * C) = hi.u;
    }
  } else {
    const __nv_bfloat16 hi = __float2bfloat16(acc[0]);
    out[o] = hi;
    if constexpr (SPLIT) {
      out[o + C] = __float2bfloat16(acc[0] - __bfloat162float(hi));
      out[o + 2 * C] = hi;
    }
  }
}

template <bool SPLIT>
void launch(bool vec, int64_t blocks, cudaStream_t st,
            const __nv_bfloat16* xp, __nv_bfloat16* op, int64_t n_items,
            int d, int h, int w, int C) {
  if (vec) {
    upsample2x_trilinear_kernel<8, SPLIT>
        <<<(unsigned)blocks, NTHREADS, 0, st>>>(xp, op, n_items, d, h, w, C);
  } else {
    upsample2x_trilinear_kernel<1, SPLIT>
        <<<(unsigned)blocks, NTHREADS, 0, st>>>(xp, op, n_items, d, h, w, C);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C is the volume's channels (the split form holds 3 C per voxel)
extern "C" int upsample2x_trilinear_ndhwc(const void* x, void* out, int B,
                                          int d, int h, int w, int C,
                                          int split, void* stream) {
  const int64_t voxels = (int64_t)B * 8 * d * h * w;
  if (voxels >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elems = voxels * C;
  if (elems == 0) return 0;
  const bool vec = C % 8 == 0 && aligned16(x) && aligned16(out);
  const int64_t n_items = vec ? elems / 8 : elems;
  const int64_t blocks = (n_items + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (split)
    launch<true>(vec, blocks, st, xp, op, n_items, d, h, w, C);
  else
    launch<false>(vec, blocks, st, xp, op, n_items, d, h, w, C);
  return static_cast<int>(cudaGetLastError());
}
