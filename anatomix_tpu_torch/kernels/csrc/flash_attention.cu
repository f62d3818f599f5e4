// Non-causal attention softmax(q k^T * scale) v over (B, H, N, hd) bf16 and
// its backward, written by hand for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   V3      anatomix_tpu/models/vit3d/primus.py  _flash_attention
// (the stock Pallas TPU flash-attention kernel behind every EVA block of
// the ViT: B2 H6 N4104 hd66 per window pair) and, under jax.grad, the two
// kernels of its custom VJP (jax/experimental/pallas/ops/tpu/
// flash_attention.py _flash_attention_bwd):
//   V3-dkv  _flash_attention_bwd_dkv  -> flash_attention_bwd_dkv
//   V3-dq   _flash_attention_bwd_dq   -> flash_attention_bwd_dq
// The TPU pads N to a block multiple with segment ids and the head dim to
// 128 lanes in device memory; here the ragged tail is masked in the kernels
// and the head dim is zero-filled to HDP (a multiple of 16: 80 for hd 66)
// in shared memory only, so device memory holds exactly (B, H, N, hd).
//
// Forward, FlashAttention-2 style: a block of 4 warps owns 64 query
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
// fragment loads are free of bank conflicts). Given a pointer, it also
// writes each row's log-sum-exp (f32), which the backward reads.
//
// Backward, FlashAttention-2's split into a key-side and a query-side
// pass (the stock kernel's split; di = sum(o * dO) is one f32 reduction
// outside, as JAX takes it in XLA). Both recompute P from q, k and the lse
// and never hold an N x N tile outside registers:
// - dkv: a block owns 64 keys and walks the queries in tiles of 32; it
//   forms S^T = k q^T rather than S, so P^T and dS^T come out of the
//   accumulators already in the A-fragment layout that dV += P^T dO and
//   dK += dS^T q need (no transpose through shared memory for P or dS);
//   q and dO are staged twice, row-major and transposed. dK and dV stay in
//   f32 registers (2 x 40 at HDP 80) for the whole walk; query tiles of
//   32 keep S^T and dP^T at 16 registers each.
// - dq: a block owns 64 queries and walks the keys in tiles of 64, as the
//   forward does, with dO as a second A operand; dQ += dS K reads K
//   transposed from shared memory. Each block writes only its own rows:
//   no atomics, so dQ is deterministic, as is the TPU kernel's.
// P and dS are rounded to bf16 for the products, as the forward rounds P.
//
// What bounds them on an H100: operations. At B2 H6 N4104 hd66 the
// forward does 4 B H N^2 hd = 5.3e10 FLOP, dkv 8 B H N^2 hd = 1.07e11 and
// dq 6 B H N^2 hd = 8.0e10, on a few MB of input: thousands of FLOP per
// byte. These first versions are simple: tiles are loaded with 4-byte
// loads and no copy overlaps the MMAs, mma.sync reaches a fraction of the
// wgmma rate, the hd padding 66 -> 80 spends 21 % more MMA work, and the
// backward recomputes S in both passes; a TMA ring, wgmma and a
// warp-specialized producer are later work.

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

// rows [r0, r0 + ROWS) of one (N, hd) head into `dst`: row-major with row
// stride STRIDE (transpose = false), or transposed, dst[col * STRIDE + row];
// rows past N are zeros. hd is even: one 4-byte load per column pair. The
// head-dim padding [hd, HDP) is never written (zero_pad fills it once).
template <int ROWS, int STRIDE, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int N, int hd) {
  const int hp = hd >> 1;
  const unsigned short* src_u = reinterpret_cast<const unsigned short*>(src);
  unsigned short* dst_u = reinterpret_cast<unsigned short*>(dst);
  for (int e = threadIdx.x; e < ROWS * hp; e += NTHREADS) {
    const int row = e / hp;
    const int col = 2 * (e - row * hp);
    uint32_t val = 0u;
    if (r0 + row < N) {
      val = *reinterpret_cast<const uint32_t*>(
          src_u + (int64_t)(r0 + row) * hd + col);
    }
    if (TRANSPOSE) {
      dst_u[col * STRIDE + row] = static_cast<unsigned short>(val & 0xffffu);
      dst_u[(col + 1) * STRIDE + row] = static_cast<unsigned short>(val >> 16);
    } else {
      *reinterpret_cast<uint32_t*>(dst_u + row * STRIDE + col) = val;
    }
  }
}

// zero the head-dim padding [hd, HDP) of a tile of ROWS rows: columns of a
// row-major tile (TRANSPOSE = false) or rows of a transposed one
template <int ROWS, int STRIDE, bool TRANSPOSE, int HDP>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int hd) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int pad = HDP - hd;
  for (int e = threadIdx.x; e < ROWS * pad; e += NTHREADS) {
    if (TRANSPOSE) {
      dst[(hd + e / ROWS) * STRIDE + e % ROWS] = zero;
    } else {
      dst[(e / pad) * STRIDE + hd + e % pad] = zero;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int N, int hd,
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

  // the head-dim padding, once; the tile loads never write it
  zero_pad<BQ, QS, false, HDP>(sQ, hd);
  zero_pad<BK, QS, false, HDP>(sK, hd);
  zero_pad<BK, VS, true, HDP>(sVt, hd);
  load_tile<BQ, QS, false>(sQ, q + head, q0, N, hd);
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
    load_tile<BK, QS, false>(sK, k + head, k0, N, hd);
    load_tile<BK, VS, true>(sVt, v + head, k0, N, hd);
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
  if (lse != nullptr && c == 0) {
    // natural log-sum-exp of the scaled logits: m and l are in base 2
    const float ln2 = 0.6931471805599453f;
    if (row0 < N) lse[(int64_t)blockIdx.y * N + row0] = (m0 + log2f(l0)) * ln2;
    if (row1 < N) lse[(int64_t)blockIdx.y * N + row1] = (m1 + log2f(l1)) * ln2;
  }
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
                   void* lse, int BH, int N, int hd, float scale,
                   cudaStream_t st) {
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
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, hd,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward: dK and dV (key side), dQ (query side)

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQB = 32;       // query rows per tile of the key-side pass
constexpr int TS = BQB + 8;   // row stride of its transposed q and dO tiles
static_assert(BK == 2 * BQB, "sQ and sdO together stage the block's keys");

// Key side: a block of 4 warps owns 64 keys (16 per warp, K and V kept as
// mma.sync A fragments in registers) and walks the queries in tiles of 32.
// Per tile it forms S^T = K q^T, P^T = exp(S^T * scale - lse) and
// dP^T = V dO^T in accumulator registers whose layout is the A-fragment
// layout of the next product, so P^T and dS^T = P^T (dP^T - di) go to
// bf16 registers and dV += P^T dO, dK += dS^T q accumulate in f32
// registers; q and dO are staged row-major (for S^T and dP^T) and
// transposed (for the two accumulations). Queries past N read lse = +inf
// (P = 0) and di = 0, so they add nothing; keys past N are zeros and are
// not stored.
template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ di,
                               float* __restrict__ dk,
                               float* __restrict__ dv, int N, int hd,
                               float scale, float scale_log2) {
  constexpr int QS = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDP / 8;
  constexpr int NTILES = BQB / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  // sQ and sdO are contiguous: together they first stage the 64 keys
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQB x QS
  __nv_bfloat16* sdO = sQ + BQB * QS;                          // BQB x QS
  __nv_bfloat16* sQt = sdO + BQB * QS;                         // HDP x TS
  __nv_bfloat16* sdOt = sQt + HDP * TS;                        // HDP x TS
  float* sL = reinterpret_cast<float*>(sdOt + HDP * TS);       // BQB
  float* sD = sL + BQB;                                        // BQB

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int64_t hrow = (int64_t)blockIdx.y * N;
  const int k0 = blockIdx.x * BK;
  const int r0 = warp * 16;

  zero_pad<BK, QS, false, HDP>(sQ, hd);  // sQ and sdO
  zero_pad<BQB, TS, true, HDP>(sQt, hd);
  zero_pad<BQB, TS, true, HDP>(sdOt, hd);

  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_tile<BK, QS, false>(sQ, k + head, k0, N, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ka[kk][0] = ld32(sQ + (r0 + g) * QS + kk * 16 + 2 * c);
    ka[kk][1] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 2 * c);
    ka[kk][2] = ld32(sQ + (r0 + g) * QS + kk * 16 + 8 + 2 * c);
    ka[kk][3] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 8 + 2 * c);
  }
  __syncthreads();
  load_tile<BK, QS, false>(sQ, v + head, k0, N, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    va[kk][0] = ld32(sQ + (r0 + g) * QS + kk * 16 + 2 * c);
    va[kk][1] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 2 * c);
    va[kk][2] = ld32(sQ + (r0 + g) * QS + kk * 16 + 8 + 2 * c);
    va[kk][3] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 8 + 2 * c);
  }

  float dka[DTILES][4], dva[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dn][i] = dva[dn][i] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += BQB) {
    __syncthreads();  // the previous tile (or the K and V staging) is read
    load_tile<BQB, QS, false>(sQ, q + head, q0, N, hd);
    load_tile<BQB, QS, false>(sdO, dout + head, q0, N, hd);
    load_tile<BQB, TS, true>(sQt, q + head, q0, N, hd);
    load_tile<BQB, TS, true>(sdOt, dout + head, q0, N, hd);
    if (tid < BQB) {
      const bool valid = q0 + tid < N;
      sL[tid] = valid ? lse[hrow + q0 + tid] * LOG2E : INFINITY;
      sD[tid] = valid ? di[hrow + q0 + tid] : 0.f;
    }
    __syncthreads();

    float st[NTILES][4], dpt[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* qr = sQ + (j * 8 + g) * QS + kk * 16 + 2 * c;
        mma16816(st[j], ka[kk], ld32(qr), ld32(qr + 8));
        const __nv_bfloat16* dr = sdO + (j * 8 + g) * QS + kk * 16 + 2 * c;
        mma16816(dpt[j], va[kk], ld32(dr), ld32(dr + 8));
      }
    }
    // P^T and dS^T in the A-fragment layout (rows: keys; k: queries)
    uint32_t pa[BQB / 16][4], dsa[BQB / 16][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * c + (i & 1);
        p[i] = exp2f(st[j][i] * scale_log2 - sL[col]);
        ds[i] = p[i] * (dpt[j][i] - sD[col]);
      }
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BQB / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const __nv_bfloat16* dr = sdOt + (dn * 8 + g) * TS + kk * 16 + 2 * c;
        mma16816(dva[dn], pa[kk], ld32(dr), ld32(dr + 8));
        const __nv_bfloat16* qr = sQt + (dn * 8 + g) * TS + kk * 16 + 2 * c;
        mma16816(dka[dn], dsa[kk], ld32(qr), ld32(qr + 8));
      }
    }
  }

  const int row0 = k0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = dn * 8 + 2 * c + h;
      if (col < hd) {
        if (row0 < N) {
          dk[head + (int64_t)row0 * hd + col] = dka[dn][h] * scale;
          dv[head + (int64_t)row0 * hd + col] = dva[dn][h];
        }
        if (row1 < N) {
          dk[head + (int64_t)row1 * hd + col] = dka[dn][2 + h] * scale;
          dv[head + (int64_t)row1 * hd + col] = dva[dn][2 + h];
        }
      }
    }
  }
}

// Query side: a block of 4 warps owns 64 queries (q and dO as A fragments
// in registers, lse and di of the thread's two rows in registers) and walks
// the keys in tiles of 64: S = q K^T and dP = dO V^T in accumulator
// registers, P = exp(S * scale - lse) with keys past N set to 0,
// dS = P (dP - di) to bf16 A fragments, dQ += dS K in f32 registers. K is
// staged row-major (for S) and transposed (for dQ), V row-major. Each
// block writes its own rows of dQ: no atomics, deterministic.
template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              float* __restrict__ dq, int N, int hd,
                              float scale, float scale_log2) {
  constexpr int QS = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDP / 8;
  constexpr int NTILES = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x QS
  __nv_bfloat16* sK = sQ + BQ * QS;                            // BK x QS
  __nv_bfloat16* sV = sK + BK * QS;                            // BK x QS
  __nv_bfloat16* sKt = sV + BK * QS;                           // HDP x VS

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int64_t hrow = (int64_t)blockIdx.y * N;
  const int q0 = blockIdx.x * BQ;
  const int r0 = warp * 16;

  zero_pad<BQ, QS, false, HDP>(sQ, hd);
  zero_pad<BK, QS, false, HDP>(sK, hd);
  zero_pad<BK, QS, false, HDP>(sV, hd);
  zero_pad<BK, VS, true, HDP>(sKt, hd);

  uint32_t qa[KSTEPS][4], doa[KSTEPS][4];
  load_tile<BQ, QS, false>(sQ, q + head, q0, N, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = ld32(sQ + (r0 + g) * QS + kk * 16 + 2 * c);
    qa[kk][1] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 2 * c);
    qa[kk][2] = ld32(sQ + (r0 + g) * QS + kk * 16 + 8 + 2 * c);
    qa[kk][3] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 8 + 2 * c);
  }
  __syncthreads();
  load_tile<BQ, QS, false>(sQ, dout + head, q0, N, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    doa[kk][0] = ld32(sQ + (r0 + g) * QS + kk * 16 + 2 * c);
    doa[kk][1] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 2 * c);
    doa[kk][2] = ld32(sQ + (r0 + g) * QS + kk * 16 + 8 + 2 * c);
    doa[kk][3] = ld32(sQ + (r0 + g + 8) * QS + kk * 16 + 8 + 2 * c);
  }
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  // rows past N: lse +inf gives P = 0
  const float l0 = row0 < N ? lse[hrow + row0] * LOG2E : INFINITY;
  const float l1 = row1 < N ? lse[hrow + row1] * LOG2E : INFINITY;
  const float d0 = row0 < N ? di[hrow + row0] : 0.f;
  const float d1 = row1 < N ? di[hrow + row1] : 0.f;

  float dqa[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[dn][i] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's fragments are read
    load_tile<BK, QS, false>(sK, k + head, k0, N, hd);
    load_tile<BK, QS, false>(sV, v + head, k0, N, hd);
    load_tile<BK, VS, true>(sKt, k + head, k0, N, hd);
    __syncthreads();

    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * QS + kk * 16 + 2 * c;
        mma16816(s, qa[kk], ld32(kr), ld32(kr + 8));
        const __nv_bfloat16* vr = sV + (j * 8 + g) * QS + kk * 16 + 2 * c;
        mma16816(dp, doa[kk], ld32(vr), ld32(vr + 8));
      }
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = k0 + j * 8 + 2 * c + (i & 1) < N;
        const float p =
            valid ? exp2f(s[i] * scale_log2 - (i < 2 ? l0 : l1)) : 0.f;
        ds[i] = p * (dp[i] - (i < 2 ? d0 : d1));
      }
      dsa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const __nv_bfloat16* kr = sKt + (dn * 8 + g) * VS + kk * 16 + 2 * c;
        mma16816(dqa[dn], dsa[kk], ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = dn * 8 + 2 * c + h;
      if (col < hd) {
        if (row0 < N) dq[head + (int64_t)row0 * hd + col] = dqa[dn][h] * scale;
        if (row1 < N) {
          dq[head + (int64_t)row1 * hd + col] = dqa[dn][2 + h] * scale;
        }
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *di;
  void *dq, *dk, *dv;
  int BH, N, hd;
  float scale;
};

template <int HDP>
cudaError_t launch_bwd_dkv(const BwdArgs& a, cudaStream_t st) {
  const int smem = (2 * BQB * (HDP + 8) + 2 * HDP * TS) * 2 + 2 * BQB * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BK - 1) / BK, a.BH);
  flash_attention_bwd_dkv_kernel<HDP><<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.N, a.hd,
      a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t st) {
  const int smem = (BQ * (HDP + 8) + 2 * BK * (HDP + 8) + HDP * VS) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BQ - 1) / BQ, a.BH);
  flash_attention_bwd_dq_kernel<HDP><<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<float*>(a.dq), a.N, a.hd, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

// the head-dim instantiations of the backward: hd up to 80
template <bool DKV>
cudaError_t dispatch_bwd(const BwdArgs& a, cudaStream_t st) {
  if (a.hd <= 16) return DKV ? launch_bwd_dkv<16>(a, st) : launch_bwd_dq<16>(a, st);
  if (a.hd <= 32) return DKV ? launch_bwd_dkv<32>(a, st) : launch_bwd_dq<32>(a, st);
  if (a.hd <= 48) return DKV ? launch_bwd_dkv<48>(a, st) : launch_bwd_dq<48>(a, st);
  if (a.hd <= 64) return DKV ? launch_bwd_dkv<64>(a, st) : launch_bwd_dq<64>(a, st);
  return DKV ? launch_bwd_dkv<80>(a, st) : launch_bwd_dq<80>(a, st);
}

bool bad_bwd_shape(int BH, int N, int hd) {
  return N <= 0 || hd <= 0 || hd % 2 || hd > 80 || BH <= 0 || BH > 65535;
}

}  // namespace

// q, k, v, out: contiguous (BH, N, hd) bf16, hd even and at most 128;
// lse: null, or (BH, N) f32 for the natural log-sum-exp of each row's
// scaled logits (what the backward kernels read)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int N, int hd,
                               float scale, void* stream) {
  if (N <= 0 || hd <= 0 || hd % 2 || hd > 128 || BH <= 0 || BH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 16) {
    err = launch<16>(q, k, v, out, lse, BH, N, hd, scale, st);
  } else if (hd <= 32) {
    err = launch<32>(q, k, v, out, lse, BH, N, hd, scale, st);
  } else if (hd <= 48) {
    err = launch<48>(q, k, v, out, lse, BH, N, hd, scale, st);
  } else if (hd <= 64) {
    err = launch<64>(q, k, v, out, lse, BH, N, hd, scale, st);
  } else if (hd <= 80) {
    err = launch<80>(q, k, v, out, lse, BH, N, hd, scale, st);
  } else {
    err = launch<128>(q, k, v, out, lse, BH, N, hd, scale, st);
  }
  return static_cast<int>(err);
}

// The backward of `flash_attention`: q, k, v, dout contiguous (BH, N, hd)
// bf16, hd even and at most 80; lse (from the forward) and
// di = sum(o * dout, -1), (BH, N) f32. dk and dv (this one) or dq (the
// next) are (BH, N, hd) f32, every element written.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int BH, int N,
                                       int hd, float scale, void* stream) {
  if (bad_bwd_shape(BH, N, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q, k, v, dout, lse, di, nullptr, dk, dv, BH, N, hd, scale};
  return static_cast<int>(
      dispatch_bwd<true>(a, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int BH, int N, int hd,
                                      float scale, void* stream) {
  if (bad_bwd_shape(BH, N, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q, k, v, dout, lse, di, dq, nullptr, nullptr, BH, N, hd, scale};
  return static_cast<int>(
      dispatch_bwd<false>(a, static_cast<cudaStream_t>(stream)));
}
