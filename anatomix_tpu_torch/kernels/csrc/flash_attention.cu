// Non-causal attention softmax(q k^T * scale) v over (B, H, N, hd) bf16,
// written by hand for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernel
//   V3  anatomix_tpu/models/vit3d/primus.py  _flash_attention
// (the stock Pallas TPU flash-attention kernel behind every EVA block of
// the ViT: B2 H6 N4104 hd66 per window pair). The TPU pads N to a block
// multiple with segment ids and the head dim to 128 lanes in device
// memory; here the ragged key tail is masked in the kernel and the head dim
// is zero-filled to HDP (a multiple of 16: 80 for hd 66) in shared memory
// only, so device memory holds exactly (B, H, N, hd) in and out.
//
// Flash attention, FlashAttention-2 style: a block of 4 warps owns 64 query
// rows (16 per warp, kept as mma.sync A fragments in registers) and walks
// the keys in tiles of 64. Per tile, S = q k^T comes from
// mma.sync.m16n8k16 bf16 with f32 accumulation; the online softmax (running
// row max and row sum, f32, exp2 with the scale folded into log2 e) runs on
// the accumulator registers, whose layout is the A-fragment layout of the
// next product, so P is rounded to bf16 in registers and P v accumulates
// into f32 registers rescaled by the change of the row max. Nothing of size
// N x N leaves registers. Keys past N get -inf before the max; query rows
// past N are computed on zeros and not stored. K is staged row-major and V
// transposed in shared memory (row strides padded by 8 elements, so the
// fragment loads are free of bank conflicts).
//
// What bounds it on an H100: operations. At B2 H6 N4104 hd66 it does
// 4 B H N^2 hd = 5.3e10 FLOP on 13 MB of input, thousands of FLOP per
// byte. This first version is simple: tiles are loaded with 4-byte loads
// and no copy overlaps the MMAs, mma.sync reaches a fraction of the wgmma
// rate, and the hd padding 66 -> 80 spends 21 % more MMA work; a TMA ring,
// wgmma and a warp-specialized producer are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int VS = BK + 8;  // row stride of the transposed V tile
static_assert(BQ == BK, "load_tile stages BK rows of q, k or v");

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of one (N, hd) head into `dst`: row-major with row
// stride QS (transpose = false), or transposed, dst[col * VS + row]; rows
// past N are zeros. hd is even: one 4-byte load per column pair.
template <int QS, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int N, int hd) {
  const int hp = hd >> 1;
  const unsigned short* src_u = reinterpret_cast<const unsigned short*>(src);
  unsigned short* dst_u = reinterpret_cast<unsigned short*>(dst);
  for (int e = threadIdx.x; e < BK * hp; e += NTHREADS) {
    const int row = e / hp;
    const int col = 2 * (e - row * hp);
    uint32_t val = 0u;
    if (r0 + row < N) {
      val = *reinterpret_cast<const uint32_t*>(
          src_u + (int64_t)(r0 + row) * hd + col);
    }
    if (TRANSPOSE) {
      dst_u[col * VS + row] = static_cast<unsigned short>(val & 0xffffu);
      dst_u[(col + 1) * VS + row] = static_cast<unsigned short>(val >> 16);
    } else {
      *reinterpret_cast<uint32_t*>(dst_u + row * QS + col) = val;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int N, int hd,
                       float scale_log2) {
  constexpr int QS = HDP + 8;  // row stride of the q and k tiles
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDP / 8;
  constexpr int NTILES = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x QS
  __nv_bfloat16* sK = sQ + BQ * QS;                            // BK x QS
  __nv_bfloat16* sVt = sK + BK * QS;                           // HDP x VS

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int c = lane & 3;   // thread in group
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int q0 = blockIdx.x * BQ;

  // zero the head-dim padding once; the tile loads never write it
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int pad = HDP - hd;
  for (int e = tid; e < BQ * pad; e += NTHREADS) {
    const int row = e / pad, col = hd + e % pad;
    sQ[row * QS + col] = zero;
    sK[row * QS + col] = zero;
  }
  for (int e = tid; e < pad * BK; e += NTHREADS) {
    sVt[(hd + e / BK) * VS + e % BK] = zero;
  }
  load_tile<QS, false>(sQ, q + head, q0, N, hd);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = ld32(sQ + (r0 + g) * QS + kk * 16 + 2 * c);
    qa[kk][1] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 2 * c);
    qa[kk][2] = ld32(sQ + (r0 + g) * QS + kk * 16 + 8 + 2 * c);
    qa[kk][3] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 8 + 2 * c);
  }

  float o[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's fragments are read
    load_tile<QS, false>(sK, k + head, k0, N, hd);
    load_tile<QS, true>(sVt, v + head, k0, N, hd);
    __syncthreads();

    float s[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * QS + kk * 16 + 2 * c;
        mma16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool valid = k0 + j * 8 + 2 * c + h < N;
        s[j][h] = valid ? s[j][h] * scale_log2 : -INFINITY;
        s[j][2 + h] = valid ? s[j][2 + h] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][h]);
        mx1 = fmaxf(mx1, s[j][2 + h]);
      }
    }
    // the four threads of a group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile starts below N, so each row has a finite max here
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      o[dn][0] *= al0;
      o[dn][1] *= al0;
      o[dn][2] *= al1;
      o[dn][3] *= al1;
    }
    // P in the A-fragment layout: key columns 16 kk + {2c, 2c+1} from
    // tile 2 kk, 16 kk + 8 + {2c, 2c+1} from tile 2 kk + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      const float p00 = exp2f(s[j][0] - mn0), p01 = exp2f(s[j][1] - mn0);
      const float p10 = exp2f(s[j][2] - mn1), p11 = exp2f(s[j][3] - mn1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p00, p01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const __nv_bfloat16* vr = sVt + (dn * 8 + g) * VS + kk * 16 + 2 * c;
        mma16816(o[dn], pa[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = dn * 8 + 2 * c + h;
      if (col < hd) {
        if (row0 < N) {
          out[head + (int64_t)row0 * hd + col] =
              __float2bfloat16(o[dn][h] * inv0);
        }
        if (row1 < N) {
          out[head + (int64_t)row1 * hd + col] =
              __float2bfloat16(o[dn][2 + h] * inv1);
        }
      }
    }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int N, int hd, float scale, cudaStream_t st) {
  const int smem = (BQ * (HDP + 8) + BK * (HDP + 8) + HDP * VS) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, BH);
  flash_attention_kernel<HDP><<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), N, hd,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous (BH, N, hd) bf16, hd even and at most 128
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int N, int hd, float scale,
                               void* stream) {
  if (N <= 0 || hd <= 0 || hd % 2 || hd > 128 || BH <= 0 || BH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 16) {
    err = launch<16>(q, k, v, out, BH, N, hd, scale, st);
  } else if (hd <= 32) {
    err = launch<32>(q, k, v, out, BH, N, hd, scale, st);
  } else if (hd <= 48) {
    err = launch<48>(q, k, v, out, BH, N, hd, scale, st);
  } else if (hd <= 64) {
    err = launch<64>(q, k, v, out, BH, N, hd, scale, st);
  } else if (hd <= 80) {
    err = launch<80>(q, k, v, out, BH, N, hd, scale, st);
  } else {
    err = launch<128>(q, k, v, out, BH, N, hd, scale, st);
  }
  return static_cast<int>(err);
}
