// Stride-2 3x3x3 convolution with zero padding 1 on channels-last (NDHWC)
// bf16 volumes, written by hand for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   V2  anatomix_tpu/ops/pallas/conv_down.py  conv_down2_block
// (the ViT tokenizer's downsample convs, `primus._tokenizer_v2_fused`).
// Output voxel o reads input rows 2o-1, 2o, 2o+1 on each axis; row -1 and,
// for an odd extent, row D are zeros. The TPU kernel reads the
// space-to-depth block tensor, whose block grid is the output grid; the port
// has no block layout, so this kernel reads channels-last directly.
//
// One implicit GEMM: M = output voxels, N = Co, K = 27 * Ci. A thread block
// owns a 16 x 4 x 2 output brick and one N tile; for each K step of 16
// input channels it loads the brick's input footprint, a 33 x 9 x 5 halo
// (2 * 16 + 1 rows along x), into shared memory once and reuses it for all
// 27 taps and all N columns of its tile. The warp's 16 output voxels of one
// x-row read every second halo voxel, so the A fragment of tap (kd, kh, kw)
// is a WMMA load with a leading dimension of two voxels. Tensor cores run
// through WMMA bf16 16x16x16 with f32 accumulation; bias and the
// activation run in the epilogue, which stores bf16 or f32 (the tokenizer
// stores f32, since an instance norm follows every conv).
//
// What bounds it on an H100: the first stage (B2 128^3 x 32 -> 64^3 x 64)
// does ~220 FLOP per input byte, below the card's ridge (~295 in bf16), so
// its bytes bound it; the two deeper stages (64 -> 128, 128 -> 256
// channels) are operation bound. This first version favours
// being simple and right over speed: the halo is re-read from L2 by
// neighbouring bricks (1.45x the input), loads and MMAs do not overlap,
// and WMMA reaches a fraction of the wgmma rate; wgmma, TMA and a pipelined
// ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TX = 16;  // output brick: 16 x 4 x 2 = 128 voxels (GEMM M)
constexpr int TY = 4;
constexpr int TZ = 2;
constexpr int HX = 2 * TX + 1;  // its input footprint
constexpr int HY = 2 * TY + 1;
constexpr int HZ = 2 * TZ + 1;
constexpr int HALO = HX * HY * HZ;  // 1485 voxels
constexpr int CK = 16;              // input channels per K step
constexpr int NWARPS = TY * TZ;     // one warp per output x-row of 16 voxels
constexpr int NTHREADS = NWARPS * 32;

struct DownArgs {
  const __nv_bfloat16* x;  // (B, D, H, W, ci)
  const __nv_bfloat16* w;  // (27 * ci, co), row (tap * ci + c)
  const float* bias;       // (co)
  void* out;               // (B, Do, Ho, Wo, co) bf16 or f32
  int D, H, W;             // input extents
  int Do, Ho, Wo;          // output extents, (n - 1) / 2 + 1
  int ci, co;
  int tiles_x, tiles_y;
  int act, out_f32;
  int xvec, wvec;  // 16-byte loads allowed for input / weights
  float slope;
};

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
conv_down2_kernel(const DownArgs a) {
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
  const int wy = warp % TY, wz = warp / TY;
  const unsigned short* x_u = reinterpret_cast<const unsigned short*>(a.x);
  const unsigned short* w_u = reinterpret_cast<const unsigned short*>(a.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT / 16];
#pragma unroll
  for (int f = 0; f < NT / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int cb = 0; cb < a.ci; cb += CK) {
    __syncthreads();  // the previous step's MMAs are done with sA / sB
    // input footprint: HALO voxels x CK channels, 8 channels per item
    for (int e = tid; e < HALO * (CK / 8); e += NTHREADS) {
      const int v = e >> 1;
      const int c = cb + (e & 1) * 8;
      const int hx = v % HX;
      const int hy = (v / HX) % HY;
      const int hz = v / (HX * HY);
      const int gz = 2 * z0 - 1 + hz;
      const int gy = 2 * y0 - 1 + hy;
      const int gx = 2 * x0 - 1 + hx;
      Pack8 val;
      val.u = make_uint4(0u, 0u, 0u, 0u);
      if (gz >= 0 && gz < a.D && gy >= 0 && gy < a.H && gx >= 0 &&
          gx < a.W && c < a.ci) {
        const int64_t off =
            (((b * a.D + gz) * a.H + gy) * a.W + gx) * a.ci + c;
        if (a.xvec) {
          val.u = *reinterpret_cast<const uint4*>(a.x + off);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < a.ci) val.h[j] = x_u[off + j];
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
      if (cin < a.ci && cout < a.co) {
        const unsigned short* src =
            w_u + ((int64_t)tap * a.ci + cin) * a.co + cout;
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
      // rows: the warp's 16 output voxels along x read halo voxels
      // 2r + kw, two voxels (2 * CK values) apart
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(
          fa, sA + (((2 * wz + kd) * HY + (2 * wy + kh)) * HX + kw) * CK,
          2 * CK);
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
    if (x < a.Wo && y < a.Ho && z < a.Do && cout < a.co) {
      const float v = activate(sC[e] + a.bias[cout], a.act, a.slope);
      const int64_t o =
          (((b * a.Do + z) * a.Ho + y) * a.Wo + x) * a.co + cout;
      if (a.out_f32) {
        static_cast<float*>(a.out)[o] = v;
      } else {
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const DownArgs& a, int B, int tiles_z,
                   cudaStream_t stream) {
  const int smem = HALO * CK * 2 + 27 * CK * NT * 2;
  static_assert(NWARPS * 16 * NT * 4 <= HALO * CK * 2 + 27 * CK * NT * 2,
                "epilogue tile must fit in the operand buffers");
  static_assert((HALO * CK * 2) % 32 == 0, "sB must stay 32-byte aligned");
  cudaError_t err = cudaFuncSetAttribute(
      conv_down2_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.tiles_x * a.tiles_y * tiles_z, (a.co + NT - 1) / NT, B);
  conv_down2_kernel<NT><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int conv_down2_ndhwc(const void* x, const void* w,
                                const void* bias, void* out, int B, int D,
                                int H, int W, int ci, int co, int act,
                                float slope, int out_f32, void* stream) {
  DownArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.D = D;
  a.H = H;
  a.W = W;
  a.Do = (D - 1) / 2 + 1;
  a.Ho = (H - 1) / 2 + 1;
  a.Wo = (W - 1) / 2 + 1;
  a.ci = ci;
  a.co = co;
  a.tiles_x = (a.Wo + TX - 1) / TX;
  a.tiles_y = (a.Ho + TY - 1) / TY;
  const int tiles_z = (a.Do + TZ - 1) / TZ;
  a.act = act;
  a.out_f32 = out_f32;
  a.slope = slope;
  a.xvec = (ci % 8 == 0) && aligned16(x);
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
