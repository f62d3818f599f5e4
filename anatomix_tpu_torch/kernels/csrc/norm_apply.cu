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
//
// The same library holds the statistics that D1 applies,
// `norm_stats_ndhwc`: for each (sample, tile, channel) of x the f32 mean
// and biased variance `var = max(E[x^2] - E[x]^2, 0)` over the tile's
// voxels, folded into the (a, s) that D1 takes,
//   a = rsqrt(var + eps) [* scale],  s = -mean * a [+ bias],
// with the tiles given by their boundaries on each axis. It replaces no
// Pallas kernel: the JAX package leaves these reductions to XLA
// (`anatomix_tpu/ops/norms.py`, `models/unet_fused._fold_affine`), and the
// port ran them as torch reductions (an f32 copy, a squared copy, two tile
// sums, a dozen tiny ops a norm). Bytes bound it on an H100: one read of x
// for three flops an element. The design reads x once. Pass 1 gives each
// block a contiguous run of one tile's voxels (in the tile's own z, y, x
// order) and one range of channel groups; each thread keeps V channels
// (16-byte loads: 4 f32 or 8 bf16) of a strided run of voxels, with f32
// sums of x and x^2 in registers, and steps through the tile's box by a
// fixed decomposition of its stride, with no division in the loop. The
// block reduces its lanes in shared memory by a fixed tree and writes one
// partial per (sample, tile, block, channel). Pass 2 sums a tile's partials
// in double, in a fixed order (32 stripes of batched loads, then a tree),
// and folds them. No atomics: two launches on the same input give the
// same bits. The grid (`kernels/norm.stats_plan`) gives every tile the same
// number of blocks, eight a SM in all at 2x128^3x32 and as few as one at
// the 4^3 bottleneck; a block never straddles two tiles.

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

// ---------------------------------------------------------------------------
// norm_stats_ndhwc: the statistics and their affine fold (header above)

namespace {

constexpr int STATS_THREADS = 256;
constexpr int STATS_UNROLL = 4;  // loads in flight per thread
constexpr int FOLD_CH = 32;      // pass 2: channels of a block,
constexpr int FOLD_ST = 32;      //         its stripes over the partials
constexpr int FOLD_BATCH = 8;    //         and their loads in flight

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_float(*p);
  } else if constexpr (V == 4) {  // f32
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {  // V == 8, bf16
    load8(p, v);
  }
}

// The box of flat tile t = (tz * t1 + ty) * t2 + tx, from the boundaries
// offs = [z: t0 + 1 | y: t1 + 1 | x: t2 + 1].
struct Box {
  int z0, y0, x0, dz, dy, dx;
};

__device__ __forceinline__ Box tile_box(const int* offs, int t, int t0,
                                        int t1, int t2) {
  const int tx = t % t2;
  t /= t2;
  const int ty = t % t1;
  const int tz = t / t1;
  const int* zo = offs;
  const int* yo = zo + t0 + 1;
  const int* xo = yo + t1 + 1;
  Box bx;
  bx.z0 = zo[tz];
  bx.dz = zo[tz + 1] - bx.z0;
  bx.y0 = yo[ty];
  bx.dy = yo[ty + 1] - bx.y0;
  bx.x0 = xo[tx];
  bx.dx = xo[tx + 1] - bx.x0;
  return bx;
}

// Pass 1. Block (bt * nblk + k, cchunk): the k-th of nblk runs of tile bt's
// voxels (bt = b * T + t), channel groups [cchunk * GB, + GB). Thread
// (lane, gl): group g = cchunk * GB + gl, voxels lane, lane + L, ... of the
// run. Writes part[bt][k][0 | 1][C]: the sums of x and of x^2.
template <typename T, int V>
__global__ void __launch_bounds__(STATS_THREADS)
norm_stats_partial_kernel(const T* __restrict__ x, const int* __restrict__ offs,
                          float* __restrict__ part, int D, int H, int W, int C,
                          int t0, int t1, int t2, int nblk) {
  __shared__ float red[2][V][STATS_THREADS];
  const int G = C / V;
  const int GB = min(G, STATS_THREADS);  // channel groups of a block
  const int L = STATS_THREADS / GB;      // voxels in flight per group
  const int lane = threadIdx.x / GB;
  const int gl = threadIdx.x - lane * GB;
  const int g = blockIdx.y * GB + gl;
  const int k = blockIdx.x % nblk;
  const int bt = blockIdx.x / nblk;
  const int n_tiles = t0 * t1 * t2;
  const int b = bt / n_tiles;
  const Box bx = tile_box(offs, bt - b * n_tiles, t0, t1, t2);
  const int n = bx.dz * bx.dy * bx.dx;
  const int chunk = (n + nblk - 1) / nblk;
  const int end = min(n, (k + 1) * chunk);
  int i = k * chunk + lane;
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  if (lane < L && g < G && i < end) {
    // voxel i of the box in (iz, iy, ix); the stride L as (sz, sy, sx),
    // sx < dx and sy < dy, so one carry per axis keeps them in the box
    int ix = i % bx.dx;
    const int r = i / bx.dx;
    int iy = r % bx.dy;
    int iz = r / bx.dy;
    const int sx = L % bx.dx;
    const int q = L / bx.dx;
    const int sy = q % bx.dy;
    const int sz = q / bx.dy;
    const T* xb = x + (int64_t)b * D * H * W * C + g * V;
    while (i < end) {
      float v[STATS_UNROLL][V];
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u) {
        if (i < end) {
          const int64_t vox =
              ((int64_t)(bx.z0 + iz) * H + (bx.y0 + iy)) * W + bx.x0 + ix;
          load_vec<T, V>(xb + vox * C, v[u]);
          ix += sx;
          iy += sy;
          iz += sz;
          if (ix >= bx.dx) {
            ix -= bx.dx;
            ++iy;
          }
          if (iy >= bx.dy) {
            iy -= bx.dy;
            ++iz;
          }
          i += L;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += v[u][j];
          s2[j] = fmaf(v[u][j], v[u][j], s2[j]);
        }
      }
    }
  }
  // the lanes of each group, summed by a fixed tree
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][j][threadIdx.x] = s1[j];
    red[1][j][threadIdx.x] = s2[j];
  }
  __syncthreads();
  for (int h = 1; h < L; h *= 2) {
    if (lane % (2 * h) == 0 && lane + h < L) {
      const int o = threadIdx.x + h * GB;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][j][threadIdx.x] += red[0][j][o];
        red[1][j][threadIdx.x] += red[1][j][o];
      }
    }
    __syncthreads();
  }
  if (lane == 0 && g < G) {
    float* p = part + ((int64_t)bt * nblk + k) * 2 * C + g * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p[j] = red[0][j][threadIdx.x];
      p[C + j] = red[1][j][threadIdx.x];
    }
  }
}

// Pass 2. Block (bt, cchunk): channels [cchunk * FOLD_CH, + FOLD_CH) of
// tile bt; stripe st sums the partials k = st, st + FOLD_ST, ... in double,
// FOLD_BATCH loads in flight, then a fixed tree sums the stripes, and the
// sums are folded into (a, s).
__global__ void __launch_bounds__(FOLD_CH * FOLD_ST)
norm_stats_fold_kernel(const float* __restrict__ part,
                       const int* __restrict__ offs,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ a,
                       float* __restrict__ s, int C, int t0, int t1, int t2,
                       int nblk, float eps) {
  __shared__ double red[2][FOLD_ST][FOLD_CH];
  const int cl = threadIdx.x % FOLD_CH;
  const int st = threadIdx.x / FOLD_CH;
  const int c = blockIdx.y * FOLD_CH + cl;
  const int bt = blockIdx.x;
  double d1 = 0.0, d2 = 0.0;
  if (c < C) {
    const float* p = part + (int64_t)bt * nblk * 2 * C + c;
    for (int k0 = st; k0 < nblk; k0 += FOLD_ST * FOLD_BATCH) {
      float v1[FOLD_BATCH], v2[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u) {
        const int k = k0 + u * FOLD_ST;
        v1[u] = k < nblk ? p[(int64_t)k * 2 * C] : 0.f;
        v2[u] = k < nblk ? p[(int64_t)k * 2 * C + C] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u) {
        d1 += v1[u];
        d2 += v2[u];
      }
    }
  }
  red[0][st][cl] = d1;
  red[1][st][cl] = d2;
  __syncthreads();
  for (int h = FOLD_ST / 2; h > 0; h /= 2) {
    if (st < h) {
      red[0][st][cl] += red[0][st + h][cl];
      red[1][st][cl] += red[1][st + h][cl];
    }
    __syncthreads();
  }
  if (st != 0 || c >= C) return;
  const Box bx = tile_box(offs, bt % (t0 * t1 * t2), t0, t1, t2);
  const double n = (double)bx.dz * bx.dy * bx.dx;
  const double mean = red[0][0][cl] / n;
  const double var = fmax(red[1][0][cl] / n - mean * mean, 0.0);
  double av = 1.0 / sqrt(var + (double)eps);
  if (scale != nullptr) av *= scale[c];
  double sv = -mean * av;
  if (bias != nullptr) sv += bias[c];
  a[(int64_t)bt * C + c] = (float)av;
  s[(int64_t)bt * C + c] = (float)sv;
}

template <typename T, int V>
void launch_partial(dim3 grid, cudaStream_t st, const void* x,
                    const int* offs, float* part, int D, int H, int W, int C,
                    int t0, int t1, int t2, int nblk) {
  norm_stats_partial_kernel<T, V><<<grid, STATS_THREADS, 0, st>>>(
      static_cast<const T*>(x), offs, part, D, H, W, C, t0, t1, t2, nblk);
}

}  // namespace

// vec: 16-byte loads (4 f32 or 8 bf16 channels a thread; C a multiple of
// that and x 16-byte aligned), else one channel a thread. offs: int32 tile
// boundaries [z: t0 + 1 | y: t1 + 1 | x: t2 + 1]; part: f32 scratch of
// B * t0 * t1 * t2 * nblk * 2 * C; scale, bias: f32 (C,) or null; a, s:
// f32 (B, t0, t1, t2, C).
extern "C" int norm_stats_ndhwc(const void* x, int x_f32, int vec,
                                const void* offs, void* part,
                                const void* scale, const void* bias, void* a,
                                void* s, int B, int D, int H, int W, int C,
                                int t0, int t1, int t2, int nblk, float eps,
                                void* stream) {
  const int64_t voxels = (int64_t)B * D * H * W;
  if (voxels >= 0x7fffffffLL || nblk < 1 || t0 < 1 || t1 < 1 || t2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (voxels == 0 || C == 0) return 0;
  const int V = vec ? (x_f32 ? 4 : 8) : 1;
  if (C % V != 0 || (vec && !aligned16(x)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = C / V;
  const int GB = G < STATS_THREADS ? G : STATS_THREADS;
  const int64_t tiles = (int64_t)B * t0 * t1 * t2;
  const int64_t blocks = tiles * nblk;
  const int chunks = (G + GB - 1) / GB;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const int*>(offs);
  auto* pp = static_cast<float*>(part);
  const dim3 grid1((unsigned)blocks, (unsigned)chunks);
  if (x_f32) {
    if (vec)
      launch_partial<float, 4>(grid1, st, x, op, pp, D, H, W, C, t0, t1, t2,
                               nblk);
    else
      launch_partial<float, 1>(grid1, st, x, op, pp, D, H, W, C, t0, t1, t2,
                               nblk);
  } else {
    if (vec)
      launch_partial<__nv_bfloat16, 8>(grid1, st, x, op, pp, D, H, W, C, t0,
                                       t1, t2, nblk);
    else
      launch_partial<__nv_bfloat16, 1>(grid1, st, x, op, pp, D, H, W, C, t0,
                                       t1, t2, nblk);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid2((unsigned)tiles, (unsigned)((C + FOLD_CH - 1) / FOLD_CH));
  norm_stats_fold_kernel<<<grid2, FOLD_CH * FOLD_ST, 0, st>>>(
      pp, op, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(a),
      static_cast<float*>(s), C, t0, t1, t2, nblk, eps);
  return static_cast<int>(cudaGetLastError());
}
