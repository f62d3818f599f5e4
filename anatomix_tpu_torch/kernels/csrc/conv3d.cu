// 3x3x3 stride-1 "same" convolutions on channels-last (NDHWC) bf16 volumes,
// written by hand for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  anatomix_tpu/ops/pallas/conv_block.py  conv_block_sparse_halo,
//       conv_block_sparse_halo_wide, conv_block_sparse_valid,
//       conv_block_sparse_valid_wide   (block-space conv, bias + act)
//   K2  anatomix_tpu/ops/pallas/conv3x3.py     _conv3x3_valid
//       (the Ci=1 entry conv and the deep "direct" convs)
//   K3  anatomix_tpu/ops/pallas/conv_block.py  conv_block_skip_halo,
//       conv_block_skip_halo_wide, conv_block_skip_valid
//       (conv over concat(enc, nearest-2x(small)), neither materialized)
//   D3  anatomix_tpu/ops/pallas/conv_block.py  conv_block_sparse_cat_halo,
//       conv_block_sparse_cat_halo_wide
//       (conv over concat(enc, up), both at one resolution, the concat
//       not materialized)
//   T-x anatomix_tpu/ops/pallas/conv_block.py  conv_block_sparse_dx
//       (dx of K1 on the (d+2)^3 extended grid with the gradient's zero
//       halo built in the kernel, then the caller's pad adjoint)
// with one implicit-GEMM kernel: M = output voxels, N = Co, K = 27 * Ci.
//
// What bounds it on an H100: the 16-channel full-resolution convs that
// carry most of the 6M UNet's work move ~64 bytes per voxel for ~14 kFLOP,
// close to the card's ridge (~295 FLOP per byte in bf16), so both the
// tensor-core rate and HBM matter; the deep convs are operation bound.
// The design keeps every byte it re-reads on chip: one thread block loads a
// (TZ+2)x(TY+2)x(TX+2) halo brick of 16 input channels into shared memory
// once per K step and reuses it for all 27 taps and all N columns of its
// tile. Padding is by index mapping (reflect: -1 -> 1, n -> n-2; zeros:
// masked), so no padded copy exists in device memory. For the decoder convs
// the channels [c1, c1+c2) come from a second tensor: at half resolution
// (nearest decoders, f_shift 1) it is read at (z/2, y/2, x/2) of the
// reflected full-resolution coordinate, so neither the 2x upsample nor the
// concat exists in memory; at full resolution (trilinear decoders, f_shift
// 0) it is read at (z, y, x), so the concat does not exist. Tensor cores
// are used through WMMA bf16 16x16x16 with f32 accumulation; bias and the
// activation run in the epilogue, which stores bf16 or f32. Weight offsets
// are 64-bit (27 * 1536 * 512 at the dev 8^3 decoder). This first version
// favours being simple and right over speed: wgmma, TMA and a pipelined
// ring are later work.
//
// The input gradient of a "same" conv (`conv3x3x3_dgrad_ndhwc`) is this
// kernel run as the transposed conv: flipped, transposed weights (packed by
// the caller, 27 * Co x Ci), zero padding, over the output grid grown by 1
// on each side (origin -1), so it reads the unpadded dy and treats the halo
// of 2 as zeros by index; no padded gradient exists in device memory. It is
// bound like the forward (the same GEMM with Ci and Co swapped). For reflect
// padding the (S+2)^3 f32 result g is then folded by `pad_adjoint_kernel`:
// dx[i] = g[i+1] (+ g[0] if i == 1) (+ g[S+1] if i == S-2) on each axis,
// edges and corners included, the exact adjoint of torch's reflect pad. For
// zero padding only the interior is computed, straight into bf16 dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TX = 16;  // output brick: 16 x 4 x 2 = 128 voxels (GEMM M)
constexpr int TY = 4;
constexpr int TZ = 2;
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int HZ = TZ + 2;
constexpr int HALO = HX * HY * HZ;  // 432 halo voxels
constexpr int CK = 16;              // input channels per K step
constexpr int NWARPS = TY * TZ;     // one warp per output x-row of 16 voxels
constexpr int NTHREADS = NWARPS * 32;

struct ConvArgs {
  // input extents D, H, W; output extents oD, oH, oW, whose voxel o reads
  // the input around o + org (org 0 and o-extents = input extents for a
  // "same" conv; org -1 and extents + 2 for the dgrad's extended grid)
  const __nv_bfloat16* enc;    // (B, D, H, W, c1)
  const __nv_bfloat16* small;  // (B, D>>f_shift, H>>f_shift, W>>f_shift,
                               //  c2), or null if c2 == 0
  const __nv_bfloat16* w;      // (27 * (c1 + c2), co), row (tap * Ci + ci)
  const float* bias;           // (co)
  void* out;                   // (B, oD, oH, oW, co) bf16 or f32
  int D, H, W;
  int oD, oH, oW, org;
  int c1, c2, co;
  int f_shift;  // 1: `small` at half resolution, 0: at full resolution
  int tiles_x, tiles_y;
  int reflect, act, out_f32;
  int xvec, wvec;  // 16-byte loads allowed for inputs / weights
  float slope;
};

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // the tile overhang past the volume is never stored; keep it in bounds
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v >= 0.f ? v : slope * v;
    case 3: return v >= 0.f ? v : expm1f(v);
    case 4: return tanhf(v);
    default: return v;
  }
}

union Pack8 {  // eight bf16 values as raw 16-bit patterns
  uint4 u;
  unsigned short h[8];
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
conv3x3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // HALO x CK
  __nv_bfloat16* sB = sA + HALO * CK;                          // 27*CK x NT
  float* sC = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * TX;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * TY;
  const int z0 = (t / a.tiles_y) * TZ;
  const int n0 = blockIdx.y * NT;
  const int64_t b = blockIdx.z;
  const int ci = a.c1 + a.c2;
  const int fs = a.f_shift;
  const int Ds = a.D >> fs, Hs = a.H >> fs, Ws = a.W >> fs;
  const int wy = warp % TY, wz = warp / TY;
  const unsigned short* enc_u = reinterpret_cast<const unsigned short*>(a.enc);
  const unsigned short* small_u =
      reinterpret_cast<const unsigned short*>(a.small);
  const unsigned short* w_u = reinterpret_cast<const unsigned short*>(a.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT / 16];
#pragma unroll
  for (int f = 0; f < NT / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int cb = 0; cb < ci; cb += CK) {
    __syncthreads();  // the previous step's MMAs are done with sA / sB
    // halo brick: HALO voxels x CK channels, 8 channels (16 bytes) per item
    for (int e = tid; e < HALO * (CK / 8); e += NTHREADS) {
      const int v = e >> 1;
      const int c = cb + (e & 1) * 8;
      const int hx = v % HX;
      const int hy = (v / HX) % HY;
      const int hz = v / (HX * HY);
      int gz = z0 + hz - 1 + a.org, gy = y0 + hy - 1 + a.org,
          gx = x0 + hx - 1 + a.org;
      bool inside = true;
      if (a.reflect) {
        gz = reflect_index(gz, a.D);
        gy = reflect_index(gy, a.H);
        gx = reflect_index(gx, a.W);
      } else {
        inside = gz >= 0 && gz < a.D && gy >= 0 && gy < a.H && gx >= 0 &&
                 gx < a.W;
      }
      Pack8 val;
      val.u = make_uint4(0u, 0u, 0u, 0u);
      if (inside && c < ci) {
        if (a.xvec) {
          // c1 % 8 == 0 and c2 % 8 == 0: the 8 channels lie in one source,
          // so only its offset is computed
          const __nv_bfloat16* src;
          if (c < a.c1) {
            src = a.enc + (((b * a.D + gz) * a.H + gy) * a.W + gx) * a.c1 + c;
          } else {
            src = a.small +
                  (((b * Ds + (gz >> fs)) * Hs + (gy >> fs)) * Ws +
                   (gx >> fs)) * a.c2 +
                  (c - a.c1);
          }
          val.u = *reinterpret_cast<const uint4*>(src);
        } else {
          const int64_t enc_off =
              (((b * a.D + gz) * a.H + gy) * a.W + gx) * a.c1;
          const int64_t small_off =
              (((b * Ds + (gz >> fs)) * Hs + (gy >> fs)) * Ws + (gx >> fs)) *
              a.c2;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cc = c + j;
            if (cc < a.c1) {
              val.h[j] = enc_u[enc_off + cc];
            } else if (cc < ci) {
              val.h[j] = small_u[small_off + (cc - a.c1)];
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(sA + v * CK + (e & 1) * 8) = val.u;
    }
    // weights: 27 taps x CK input channels x NT output channels
    for (int e = tid; e < 27 * CK * (NT / 8); e += NTHREADS) {
      const int n8 = (e % (NT / 8)) * 8;
      const int r = e / (NT / 8);  // tap * CK + k
      const int tap = r / CK;
      const int cin = cb + (r % CK);
      const int cout = n0 + n8;
      Pack8 val;
      val.u = make_uint4(0u, 0u, 0u, 0u);
      if (cin < ci && cout < a.co) {
        const unsigned short* src =
            w_u + ((int64_t)tap * ci + cin) * a.co + cout;
        if (a.wvec) {
          val.u = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (cout + j < a.co) val.h[j] = src[j];
          }
        }
      }
      *reinterpret_cast<uint4*>(sB + r * NT + n8) = val.u;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 27; ++tap) {
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      // rows: the warp's 16 output voxels along x, shifted by the tap
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(
          fa, sA + (((wz + kd) * HY + (wy + kh)) * HX + kw) * CK, CK);
#pragma unroll
      for (int f = 0; f < NT / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + tap * CK * NT + f * 16, NT);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int f = 0; f < NT / 16; ++f) {
    wmma::store_matrix_sync(sC + warp * 16 * NT + f * 16, acc[f], NT,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // epilogue: bias + activation, consecutive threads on consecutive channels
  for (int e = tid; e < NWARPS * 16 * NT; e += NTHREADS) {
    const int n = e % NT;
    const int r = (e / NT) % 16;
    const int wi = e / (16 * NT);
    const int x = x0 + r, y = y0 + wi % TY, z = z0 + wi / TY;
    const int cout = n0 + n;
    if (x < a.oW && y < a.oH && z < a.oD && cout < a.co) {
      const float v = activate(sC[e] + a.bias[cout], a.act, a.slope);
      const int64_t o =
          (((b * a.oD + z) * a.oH + y) * a.oW + x) * a.co + cout;
      if (a.out_f32) {
        static_cast<float*>(a.out)[o] = v;
      } else {
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const ConvArgs& a, int B, int tiles_z,
                   cudaStream_t stream) {
  const int smem = HALO * CK * 2 + 27 * CK * NT * 2;
  static_assert(NWARPS * 16 * NT * 4 <= HALO * CK * 2 + 27 * CK * NT * 2,
                "epilogue tile must fit in the operand buffers");
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3x3_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.tiles_x * a.tiles_y * tiles_z, (a.co + NT - 1) / NT, B);
  conv3x3x3_kernel<NT><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int conv3x3x3_two_operand(
    const void* enc, const void* small, int f_shift, const void* w,
    const void* bias, void* out, int B, int D, int H, int W, int c1, int c2,
    int co, int reflect, int act, float slope, int out_f32, void* stream,
    int grow = 0) {
  ConvArgs a;
  a.enc = static_cast<const __nv_bfloat16*>(enc);
  a.small = static_cast<const __nv_bfloat16*>(small);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.D = D;
  a.H = H;
  a.W = W;
  a.oD = D + 2 * grow;
  a.oH = H + 2 * grow;
  a.oW = W + 2 * grow;
  a.org = -grow;
  a.c1 = c1;
  a.c2 = c2;
  a.co = co;
  a.f_shift = f_shift;
  a.tiles_x = (a.oW + TX - 1) / TX;
  a.tiles_y = (a.oH + TY - 1) / TY;
  const int tiles_z = (a.oD + TZ - 1) / TZ;
  a.reflect = reflect;
  a.act = act;
  a.out_f32 = out_f32;
  a.slope = slope;
  a.xvec = (c1 % 8 == 0) && (c2 % 8 == 0) && (c1 == 0 || aligned16(enc)) &&
           (c2 == 0 || aligned16(small));
  a.wvec = (co % 8 == 0) && aligned16(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (co > 32) {
    err = launch<64>(a, B, tiles_z, s);
  } else if (co > 16) {
    err = launch<32>(a, B, tiles_z, s);
  } else {
    err = launch<16>(a, B, tiles_z, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int conv3x3x3_upcat_ndhwc(
    const void* enc, const void* small, const void* w, const void* bias,
    void* out, int B, int D, int H, int W, int c1, int c2, int co,
    int reflect, int act, float slope, int out_f32, void* stream) {
  return conv3x3x3_two_operand(enc, small, 1, w, bias, out, B, D, H, W, c1,
                               c2, co, reflect, act, slope, out_f32, stream);
}

extern "C" int conv3x3x3_cat_ndhwc(
    const void* enc, const void* up, const void* w, const void* bias,
    void* out, int B, int D, int H, int W, int c1, int c2, int co,
    int reflect, int act, float slope, int out_f32, void* stream) {
  return conv3x3x3_two_operand(enc, up, 0, w, bias, out, B, D, H, W, c1, c2,
                               co, reflect, act, slope, out_f32, stream);
}

extern "C" int conv3x3x3_ndhwc(const void* x, const void* w, const void* bias,
                               void* out, int B, int D, int H, int W, int ci,
                               int co, int reflect, int act, float slope,
                               int out_f32, void* stream) {
  return conv3x3x3_two_operand(x, nullptr, 0, w, bias, out, B, D, H, W, ci,
                               0, co, reflect, act, slope, out_f32, stream);
}

namespace {

// the extended-grid indices whose gradient lands on voxel i of an n-extent
// axis under reflect padding: the interior i + 1, and the halo face that
// mirrors onto i (-1 -> 1, n -> n - 2)
__device__ __forceinline__ int reflect_sources(int i, int n, int* s) {
  int k = 0;
  s[k++] = i + 1;
  if (i == 1) s[k++] = 0;
  if (i == n - 2) s[k++] = n + 1;
  return k;
}

__global__ void pad_adjoint_kernel(const float* __restrict__ g,
                                   __nv_bfloat16* __restrict__ dx, int64_t n,
                                   int D, int H, int W, int C) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = e % C;
    int64_t t = e / C;
    const int x = t % W;
    t /= W;
    const int y = t % H;
    t /= H;
    const int z = t % D;
    const int64_t b = t / D;
    int sz[3], sy[3], sx[3];
    const int nz = reflect_sources(z, D, sz);
    const int ny = reflect_sources(y, H, sy);
    const int nx = reflect_sources(x, W, sx);
    float acc = 0.f;
    for (int i = 0; i < nz; ++i) {
      for (int j = 0; j < ny; ++j) {
        const int64_t row = ((b * (D + 2) + sz[i]) * (H + 2) + sy[j]) * (W + 2);
        for (int k = 0; k < nx; ++k) acc += g[(row + sx[k]) * C + c];
      }
    }
    dx[e] = __float2bfloat16(acc);
  }
}

}  // namespace

// dx (B, D, H, W, ci) bf16 of a 3x3x3 "same" conv from dy (B, D, H, W, co)
// and the flipped, transposed packed weights w_t (27 * co, ci); zero_bias is
// (ci,) f32 zeros. reflect: g_ext (B, D+2, H+2, W+2, ci) f32 is scratch.
extern "C" int conv3x3x3_dgrad_ndhwc(const void* dy, const void* w_t,
                                     const void* zero_bias, void* g_ext,
                                     void* dx, int B, int D, int H, int W,
                                     int co, int ci, int reflect,
                                     void* stream) {
  if (!reflect) {
    return conv3x3x3_two_operand(dy, nullptr, 0, w_t, zero_bias, dx, B, D,
                                 H, W, co, 0, ci, 0, 0, 0.f, 0, stream);
  }
  int rc = conv3x3x3_two_operand(dy, nullptr, 0, w_t, zero_bias, g_ext, B,
                                 D, H, W, co, 0, ci, 0, 0, 0.f, 1, stream,
                                 /*grow=*/1);
  if (rc != 0) return rc;
  const int64_t n = (int64_t)B * D * H * W * ci;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t(1) << 20)) blocks = int64_t(1) << 20;
  pad_adjoint_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g_ext), static_cast<__nv_bfloat16*>(dx), n,
      D, H, W, ci);
  return static_cast<int>(cudaGetLastError());
}
