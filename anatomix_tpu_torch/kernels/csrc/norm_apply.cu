// Apply half of (tiled) instance norm, plus the activation, on channels-last
// (NDHWC) volumes, written by hand for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   D1  anatomix_tpu/ops/pallas/norm_apply.py  norm_apply_block
// computing
//   out[b, z, y, x, c] = act(x[b, z, y, x, c] * a[b, tz, ty, tx, c]
//                            + s[b, tz, ty, tx, c] [+ r[b, z, y, x, c]])
//                        [+ 0.1 x[b, z, y, x, c]]
// with (tz, ty, tx) = (zmap[z], ymap[y], xmap[x]): three int32 maps from
// voxel index to tile index, so even and uneven tiles (and the global norm,
// one tile) take the same kernel. The input is bf16 or f32 (the fused
// forward stores the convs that feed a live norm in f32), a and s are f32
// (B, t0, t1, t2, C), the math is f32 and the output bf16. The optional
// residual r (bf16, x's shape) is the ViT tokenizer's
// `lrelu(IN(conv2(...)) + r)` (`anatomix_tpu/models/vit3d/primus.py`
// `_tokenizer_v2`), which the TPU runs as XLA passes: here it is one pass.
// With `split`, the output is (B, D, H, W, 3 C): each value v as the three
// bf16 channel blocks [hi | lo | hi], hi = bf16(v), lo = bf16(v - hi), the
// operand of a conv whose weights are packed [w_hi; w_hi; w_lo] along Ci,
// which then reads v * w as x_hi w_hi + x_lo w_hi + x_hi w_lo, to about
// 2^-16 of it (the port's ViT tokenizer, whose instance norms amplify a bf16
// rounding on a smooth volume); a residual in that form is read as hi + lo.
// With `post_res` it adds 0.1 x after the activation: a residual UNet's
// block end, `act(norm(conv)) + 0.1 conv` (`anatomix_tpu/models/unet.py:
// 530-532`), with (a, s) the batch norm's running affine, the instance
// norm's, or 1 and 0 where the block has no norm.
//
// What bounds it on an H100: bytes. It reads each input element once and
// writes each output element once (4 or 6 bytes per element) for two
// flops, far below the card's ridge; the (a, s) rows are a few KB and stay
// in L1/L2. The design: one thread per 8 consecutive channels of one voxel,
// 16- or 32-byte loads (16 more for a residual) and a 16-byte store,
// consecutive threads on
// consecutive addresses. Voxel coordinates come from one 64-bit division
// per thread (for its block's start) and 32-bit arithmetic after it.
// Channel counts that are not a multiple of 8 take the same kernel with one
// channel per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

// 1 relu, 2 lrelu (PReLU: its weight as the slope), 3 elu, 4 tanh, 5 selu
__device__ __forceinline__ float activate(float v, int act, float slope) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v >= 0.f ? v : slope * v;
    case 3: return v >= 0.f ? v : expm1f(v);
    case 4: return tanhf(v);
    case 5:
      return 1.0507009873554805f * (v > 0.f ? v
                                            : 1.6732632423543772f * expm1f(v));
    default: return v;
  }
}

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

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS)
norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ s, const int* __restrict__ zmap,
                  const int* __restrict__ ymap, const int* __restrict__ xmap,
                  const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* __restrict__ out, int64_t n_items, int D,
                  int H, int W, int C, int t0, int t1, int t2, int act,
                  float slope, int split, int post_res) {
  const int G = C / V;  // items per voxel
  const int64_t first = (int64_t)blockIdx.x * NTHREADS;
  const int64_t e = first + threadIdx.x;
  if (e >= n_items) return;
  // voxel and channel group: one 64-bit division for the block's start,
  // 32-bit arithmetic after it (the launcher keeps voxels below 2^31)
  const int64_t v0 = first / G;
  const int local = (int)(first - v0 * G) + threadIdx.x;
  const int v = (int)(v0 + local / G);
  const int c = (local % G) * V;
  const int xi = v % W;
  int r = v / W;
  const int yi = r % H;
  r /= H;
  const int zi = r % D;
  const int b = r / D;
  const int64_t t =
      (((int64_t)b * t0 + zmap[zi]) * t1 + ymap[yi]) * t2 + xmap[xi];
  const float* ar = a + t * C + c;
  const float* sr = s + t * C + c;
  // element offset of (v, c) in the output and the residual
  const int64_t o = split ? (int64_t)v * 3 * C + c : e * V;
  if constexpr (V == 8) {
    float xv[8];
    load8(x + e * 8, xv);
    const float4 a0 = reinterpret_cast<const float4*>(ar)[0];
    const float4 a1 = reinterpret_cast<const float4*>(ar)[1];
    const float4 s0 = reinterpret_cast<const float4*>(sr)[0];
    const float4 s1 = reinterpret_cast<const float4*>(sr)[1];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (res != nullptr) {
      load8(res + o, rv);
      if (split) {
        float lo[8];
        load8(res + o + C, lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) rv[j] += lo[j];
      }
    }
    Pack8 hi, lo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float val = activate(xv[j] * av[j] + sv[j] + rv[j], act, slope);
      if (post_res) val += 0.1f * xv[j];
      hi.h[j] = __float2bfloat16(val);
      lo.h[j] = __float2bfloat16(val - __bfloat162float(hi.h[j]));
    }
    *reinterpret_cast<uint4*>(out + o) = hi.u;
    if (split) {
      *reinterpret_cast<uint4*>(out + o + C) = lo.u;
      *reinterpret_cast<uint4*>(out + o + 2 * C) = hi.u;
    }
  } else {
    const float xe = to_float(x[e]);
    float val = xe * ar[0] + sr[0];
    if (res != nullptr) {
      val += __bfloat162float(res[o]);
      if (split) val += __bfloat162float(res[o + C]);
    }
    val = activate(val, act, slope);
    if (post_res) val += 0.1f * xe;
    const __nv_bfloat16 hi = __float2bfloat16(val);
    out[o] = hi;
    if (split) {
      out[o + C] = __float2bfloat16(val - __bfloat162float(hi));
      out[o + 2 * C] = hi;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
void launch(bool vec, int64_t blocks, cudaStream_t st, const void* x,
            const float* a, const float* s, const int* zmap, const int* ymap,
            const int* xmap, const __nv_bfloat16* res, __nv_bfloat16* out,
            int64_t n_items, int D,
            int H, int W, int C, int t0, int t1, int t2, int act,
            float slope, int split, int post_res) {
  const T* xp = static_cast<const T*>(x);
  if (vec) {
    norm_apply_kernel<T, 8><<<(unsigned)blocks, NTHREADS, 0, st>>>(
        xp, a, s, zmap, ymap, xmap, res, out, n_items, D, H, W, C, t0, t1,
        t2, act, slope, split, post_res);
  } else {
    norm_apply_kernel<T, 1><<<(unsigned)blocks, NTHREADS, 0, st>>>(
        xp, a, s, zmap, ymap, xmap, res, out, n_items, D, H, W, C, t0, t1,
        t2, act, slope, split, post_res);
  }
}

}  // namespace

extern "C" int norm_apply_ndhwc(const void* x, int x_f32, const void* a,
                                const void* s, const void* zmap,
                                const void* ymap, const void* xmap,
                                const void* res, void* out, int B, int D,
                                int H, int W, int C,
                                int t0, int t1, int t2, int act, float slope,
                                int split, int post_res, void* stream) {
  const int64_t voxels = (int64_t)B * D * H * W;
  if (voxels >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elems = voxels * C;
  if (elems == 0) return 0;
  const bool vec = C % 8 == 0 && aligned16(x) && aligned16(out) &&
                   aligned16(a) && aligned16(s) &&
                   (res == nullptr || aligned16(res));
  const int64_t n_items = vec ? elems / 8 : elems;
  const int64_t blocks = (n_items + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* sp = static_cast<const float*>(s);
  const auto* zp = static_cast<const int*>(zmap);
  const auto* yp = static_cast<const int*>(ymap);
  const auto* wp = static_cast<const int*>(xmap);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (x_f32) {
    launch<float>(vec, blocks, st, x, ap, sp, zp, yp, wp, rp, op, n_items,
                  D, H, W, C, t0, t1, t2, act, slope, split, post_res);
  } else {
    launch<__nv_bfloat16>(vec, blocks, st, x, ap, sp, zp, yp, wp, rp, op,
                          n_items, D, H, W, C, t0, t1, t2, act, slope,
                          split, post_res);
  }
  return static_cast<int>(cudaGetLastError());
}
