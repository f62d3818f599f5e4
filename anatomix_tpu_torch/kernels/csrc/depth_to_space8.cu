// Factor-8 depth-to-space, the ViT patch decoder's exit, on channels-last
// volumes, written by hand for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   V1  anatomix_tpu/ops/pallas/reshuffle.py  depth_to_space8
//       (`_d2s8_planes`, the subtract port of the `demean` out-norm)
// computing, for y (B, d, h, w, 512 C) bf16 whose channels are ordered
// (a1, a2, a3, c) with a_i = z_i * 4 + y_i * 2 + x_i (coarsest stage
// first, the column order of the three stacked transposed-conv GEMMs),
//   out[b, 8 dz + 4 z1 + 2 z2 + z3, 8 dy + ..., 8 dx + ..., c]
//     = y[b, dz, dy, dx, ((a1 * 8 + a2) * 8 + a3) * C + c] - sub[b, ...]
// in f32, with `sub` (B, 512 C) f32 optional (the per-channel mean of the
// demean out-norm, or minus the final bias). The output is f32 NDHWC,
// which the sliding-window stitch reads as it is.
//
// What bounds it on an H100: bytes. It moves 2 bytes in and 4 out per
// element with one subtract (B2 16^3 x 16384 -> 128^3 x 32: 268 MB in,
// 537 MB out). The design walks the output in order, one thread per 4
// channels of one voxel: 16-byte stores, consecutive threads on
// consecutive addresses, so every output byte is written once, fully
// coalesced. A warp's 4 output voxels along x read two runs of 2 C
// contiguous input channels (x3 steps by C, x2 by 8 C), so every input
// byte is read once in 64-byte runs. Voxel coordinates are 32-bit (the
// launcher keeps voxels below 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

template <int V, bool SUB>
__global__ void __launch_bounds__(NTHREADS)
d2s8_kernel(const __nv_bfloat16* __restrict__ y,
            const float* __restrict__ sub, float* __restrict__ out,
            int64_t n_items, int d, int h, int w, int C) {
  const int64_t e = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= n_items) return;
  const int G = C / V;  // items per output voxel
  const int64_t vox = e / G;
  const int c = (int)(e - vox * G) * V;
  int v = (int)vox;
  const int W8 = 8 * w, H8 = 8 * h, D8 = 8 * d;
  const int X = v % W8;
  v /= W8;
  const int Y = v % H8;
  v /= H8;
  const int Z = v % D8;
  const int b = v / D8;
  const int a1 = ((Z >> 2) & 1) * 4 + ((Y >> 2) & 1) * 2 + ((X >> 2) & 1);
  const int a2 = ((Z >> 1) & 1) * 4 + ((Y >> 1) & 1) * 2 + ((X >> 1) & 1);
  const int a3 = (Z & 1) * 4 + (Y & 1) * 2 + (X & 1);
  const int cin = ((a1 * 8 + a2) * 8 + a3) * C + c;
  const int64_t in_off =
      (((int64_t)b * d + (Z >> 3)) * h + (Y >> 3)) * w + (X >> 3);
  const __nv_bfloat16* src = y + in_off * 512 * C + cin;
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    float4 r = make_float4(__low2float(lo), __high2float(lo),
                           __low2float(hi), __high2float(hi));
    if (SUB) {
      const float4 s = *reinterpret_cast<const float4*>(
          sub + (int64_t)b * 512 * C + cin);
      r.x -= s.x;
      r.y -= s.y;
      r.z -= s.z;
      r.w -= s.w;
    }
    reinterpret_cast<float4*>(out)[e] = r;
  } else {
    float r = __bfloat162float(*src);
    if (SUB) r -= sub[(int64_t)b * 512 * C + cin];
    out[e] = r;
  }
}

template <int V>
void launch(bool has_sub, int64_t blocks, cudaStream_t st,
            const __nv_bfloat16* y, const float* sub, float* out,
            int64_t n_items, int d, int h, int w, int C) {
  if (has_sub) {
    d2s8_kernel<V, true><<<(unsigned)blocks, NTHREADS, 0, st>>>(
        y, sub, out, n_items, d, h, w, C);
  } else {
    d2s8_kernel<V, false><<<(unsigned)blocks, NTHREADS, 0, st>>>(
        y, sub, out, n_items, d, h, w, C);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// y (B, d, h, w, 512 C) bf16; sub (B, 512 C) f32 or null; out
// (B, 8d, 8h, 8w, C) f32
extern "C" int depth_to_space8_ndhwc(const void* y, const void* sub,
                                     void* out, int B, int d, int h, int w,
                                     int C, void* stream) {
  const int64_t voxels = (int64_t)B * 512 * d * h * w;
  if (voxels >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elems = voxels * C;
  if (elems == 0) return 0;
  // 8-byte loads of y, 16-byte loads of sub and stores of out
  const bool vec = C % 4 == 0 && aligned16(y) && aligned16(out) &&
                   (sub == nullptr || aligned16(sub));
  const int64_t n_items = vec ? elems / 4 : elems;
  const int64_t blocks = (n_items + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const auto* sp = static_cast<const float*>(sub);
  auto* op = static_cast<float*>(out);
  if (vec) {
    launch<4>(sp != nullptr, blocks, st, yp, sp, op, n_items, d, h, w, C);
  } else {
    launch<1>(sp != nullptr, blocks, st, yp, sp, op, n_items, d, h, w, C);
  }
  return static_cast<int>(cudaGetLastError());
}
