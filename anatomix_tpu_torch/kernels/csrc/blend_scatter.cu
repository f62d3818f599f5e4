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
// The window outputs are f32 or bf16 (the ViT's fold exit writes bf16
// windows, read here as the channels-last rows they are); every product and
// sum is f32.
//
// What bounds it on an H100: bytes. Each window element is read once (f32
// or bf16) and its canvas element read and written once, 10-12 bytes per
// element for one multiply-add, far below the card's ridge. The canvas keeps
// the reference (D, H, W, C) order, so one window row (fixed i, j) is r2 * C
// contiguous values in the window and in the canvas: one thread block walks
// one row with consecutive threads on consecutive addresses. Windows of one
// chunk overlap (MONAI's stride is ~0.2 roi), so the adds are f32
// atomicAdd: the sum of one chunk's contributions to a voxel is exact up to
// the order of at most B f32 additions. Masked padding windows return
// before reading anything; for finite window outputs this equals adding
// their zero-weighted product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void blend_scatter_kernel(
    float* __restrict__ canvas, const T* __restrict__ win,
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
  const T* src = win + (((int64_t)b * r0 + i) * r1 + j) * n;
  float* dst = canvas + (((int64_t)(s0 + i) * H + (s1 + j)) * W + s2) * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float wgt = fmaxf(gij * gw[e / C], minv);
    atomicAdd(dst + e, to_f32(src[e]) * wgt);
  }
}

}  // namespace

// win: (B, r0, r1, r2, C) f32, or bf16 when win_bf16 is not 0
extern "C" int blend_scatter(void* canvas, const void* win,
                             const void* starts, const void* mask,
                             const void* gd, const void* gh, const void* gw,
                             float minv, int B, int D, int H, int W, int C,
                             int r0, int r1, int r2, int win_bf16,
                             void* stream) {
  if (B == 0) return 0;
  dim3 grid(r0 * r1, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cv = static_cast<float*>(canvas);
  const int* s = static_cast<const int*>(starts);
  const int* m = static_cast<const int*>(mask);
  const float *a = static_cast<const float*>(gd),
              *b = static_cast<const float*>(gh),
              *c = static_cast<const float*>(gw);
  if (win_bf16)
    blend_scatter_kernel<<<grid, 256, 0, st>>>(
        cv, static_cast<const __nv_bfloat16*>(win), s, m, a, b, c, minv, D,
        H, W, C, r0, r1, r2);
  else
    blend_scatter_kernel<<<grid, 256, 0, st>>>(
        cv, static_cast<const float*>(win), s, m, a, b, c, minv, D, H, W, C,
        r0, r1, r2);
  return static_cast<int>(cudaGetLastError());
}
