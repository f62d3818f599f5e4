// Gaussian-blend scatter-accumulate of sliding-window outputs into an f32
// canvas, written by hand for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   K4  anatomix_tpu/ops/pallas/scatter.py  blend_scatter_fold
// For a chunk of B windows:
//   canvas[s + (i, j, k), c] += out[b, i, j, k, c]
//                               * max(gd[i] * gh[j] * gw[k], minv) * mask[b]
// with MONAI's clamp applied before the mask.
//
// What bounds it on an H100: bytes. Each window element is read once (f32)
// and its canvas element read and written once, ~12 bytes per element for
// one multiply-add, far below the card's ridge. The canvas keeps the
// reference (D, H, W, C) order, so one window row (fixed i, j) is r2 * C
// contiguous floats in the window and in the canvas: one thread block walks
// one row with consecutive threads on consecutive addresses. Windows of one
// chunk overlap (MONAI's stride is ~0.2 roi), so the adds are f32
// atomicAdd: the sum of one chunk's contributions to a voxel is exact up to
// the order of at most B f32 additions. Masked padding windows return
// before reading anything; for finite window outputs this equals adding
// their zero-weighted product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void blend_scatter_kernel(
    float* __restrict__ canvas, const float* __restrict__ win,
    const int* __restrict__ starts, const int* __restrict__ mask,
    const float* __restrict__ gd, const float* __restrict__ gh,
    const float* __restrict__ gw, float minv, int D, int H, int W, int C,
    int r0, int r1, int r2) {
  const int b = blockIdx.y;
  if (mask[b] == 0) return;
  const int i = blockIdx.x / r1;
  const int j = blockIdx.x % r1;
  const int s0 = starts[3 * b], s1 = starts[3 * b + 1], s2 = starts[3 * b + 2];
  // the caller validates starts on the host; never write out of bounds
  if (s0 < 0 || s1 < 0 || s2 < 0 || s0 + r0 > D || s1 + r1 > H ||
      s2 + r2 > W) {
    return;
  }
  const float gij = gd[i] * gh[j];
  const int n = r2 * C;
  const float* src = win + (((int64_t)b * r0 + i) * r1 + j) * n;
  float* dst = canvas + (((int64_t)(s0 + i) * H + (s1 + j)) * W + s2) * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float wgt = fmaxf(gij * gw[e / C], minv);
    atomicAdd(dst + e, src[e] * wgt);
  }
}

}  // namespace

extern "C" int blend_scatter(void* canvas, const void* win,
                             const void* starts, const void* mask,
                             const void* gd, const void* gh, const void* gw,
                             float minv, int B, int D, int H, int W, int C,
                             int r0, int r1, int r2, void* stream) {
  if (B == 0) return 0;
  dim3 grid(r0 * r1, B);
  blend_scatter_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(canvas), static_cast<const float*>(win),
      static_cast<const int*>(starts), static_cast<const int*>(mask),
      static_cast<const float*>(gd), static_cast<const float*>(gh),
      static_cast<const float*>(gw), minv, D, H, W, C, r0, r1, r2);
  return static_cast<int>(cudaGetLastError());
}
