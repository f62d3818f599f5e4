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
// - dkv, on Hopper's warpgroup MMA (wgmma, `hopper.cuh`): a block of two
//   warpgroups owns 128 keys, K and V staged once, and walks the queries in
//   tiles of 64 through a 3-stage cp.async ring of (q, dO, lse, di). S^T =
//   K q^T and dP^T = V dO^T come from shared memory (m64n64k16); P^T and
//   dS^T are rounded to bf16 register-A fragments in the accumulators' own
//   layout; dV += P^T dO and dK += dS^T q read the same q and dO tiles
//   MN-major (transpose bit), so each operand is staged once and never
//   transposed. Details at the kernel.
// - dq: a block owns 64 queries and walks the keys in tiles of 64, as the
//   forward does, with dO as a second A operand; dQ += dS K reads K
//   transposed from shared memory. Each block writes only its own rows:
//   no atomics, so dQ is deterministic, as is the TPU kernel's.
// P and dS are rounded to bf16 for the products, as the forward rounds P.
//
// What bounds them on an H100: operations. At B2 H6 N4104 hd66 the
// forward does 4 B H N^2 hd = 5.3e10 FLOP, dkv 8 B H N^2 hd = 1.07e11 and
// dq 6 B H N^2 hd = 8.0e10, on a few MB of input: thousands of FLOP per
// byte. dkv therefore runs on wgmma with its copies a ring ahead of the
// MMAs, and pads the head dim to 16 only in shared memory. The forward and
// dq stay on mma.sync
// with 4-byte tile loads that do not overlap the MMAs, the head dim padded
// to 80 in every product; a ring and wgmma for them, as in dkv, are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Key side, on Hopper's warpgroup MMA. A block of two warpgroups owns 128
// keys (64 each); K and V are staged once in shared memory. The block walks
// the queries in tiles of 64 through a DKV_STAGES-deep cp.async ring of
// (q, dO, lse, di), loading DKV_STAGES - 1 tiles ahead of the MMAs. Per
// tile and warpgroup:
//   S^T = K q^T and dP^T = V dO^T   wgmma m64n64k16, A = K or V and B = the
//                                   q or dO tile (K-major), over HDP / 16
//                                   head-dim steps;
//   P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - di) on
//                                   the accumulators, rounded to bf16
//                                   register-A fragments;
//   dV += P^T dO and dK += dS^T q   register-A wgmma m64nHDPk16 over the
//                                   64 queries, B = the same q and dO tiles
//                                   read MN-major (transpose bit); at hd 66
//                                   the m64n72 that skips the padding ran
//                                   no faster on the card than m64n80.
// Every tile lies in shared memory as no-swizzle core matrices (8 rows x 8
// head dims, 128 bytes), head-dim group major, so one copy serves both
// reads: K-major, core matrices adjacent along N (rows) are 128 bytes apart
// and along K (head dims) rows / 8 x 128; MN-major the other way round.
// A (B, H, N, hd) row of 66 bf16 is only 4-byte aligned, so the tiles come
// in by 4-byte cp.async, one warp filling one core matrix per instruction;
// head dims past hd and rows past N are zero-filled by the copy. A query
// past N is a zero row of q and dO (its lse and di read 0): its P^T is
// finite and its dS^T 0, so it adds nothing; a key past N is a zero row
// whose dK and dV are not stored. dK and dV stay in f32 registers for the
// whole walk; dK is scaled once at the end, and each block writes only its
// own key rows (deterministic, no atomics).
constexpr int DKV_KEYS = 128;  // keys per block: 64 per warpgroup
constexpr int DKV_Q = 64;      // queries per ring tile
constexpr int DKV_STAGES = 3;
constexpr int DKV_THREADS = 256;

// rows [r0, r0 + R) of one (N, hd) head into the core-matrix tile at `dst`
// (core (row group i, head-dim group j) at (j * R / 8 + i) * 128), by the
// block's 8 warps; zeros past N and past hd
template <int R, int HDP>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int r0,
                                          int N, int hd) {
  constexpr int RG = R / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, col_in = 2 * (lane & 3);
#pragma unroll 2
  for (int c = warp; c < RG * (HDP / 8); c += DKV_THREADS / 32) {
    const int j = c / RG, i = c - j * RG;
    const int row = r0 + 8 * i + r, col = 8 * j + col_in;
    const bool ok = row < N && col < hd;
    hopper::cp_async4(dst + c * 128 + lane * 4,
                      ok ? src + (int64_t)row * hd + col : src, ok);
  }
}

template <int HDP>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ di,
                               float* __restrict__ dk,
                               float* __restrict__ dv, int N, int hd,
                               float scale, float scale_log2) {
  using namespace hopper;
  constexpr int KV_BYTES = DKV_KEYS * HDP * 2;
  constexpr int T_BYTES = DKV_Q * HDP * 2;  // one q or dO tile
  constexpr int STAGE = 2 * T_BYTES + 2 * DKV_Q * 4;
  constexpr int KG = DKV_KEYS / 8 * 128;  // K / V: next head-dim group
  constexpr int QG = DKV_Q / 8 * 128;     // q / dO: next head-dim group
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sK = s0, sV = s0 + KV_BYTES, sR = s0 + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = (tid >> 5) & 3, wg = tid >> 7;
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int64_t hrow = (int64_t)blockIdx.y * N;
  const int k0 = blockIdx.x * DKV_KEYS;
  const int ntiles = (N + DKV_Q - 1) / DKV_Q;

  auto load_tile = [&](int t, int slot) {
    const uint32_t st = sR + slot * STAGE;
    const int q0 = t * DKV_Q;
    load_rows<DKV_Q, HDP>(st, q + head, q0, N, hd);
    load_rows<DKV_Q, HDP>(st + T_BYTES, dout + head, q0, N, hd);
    if (tid < 2 * DKV_Q) {
      const float* src = (tid < DKV_Q ? lse : di) + hrow;
      const bool ok = q0 + (tid & (DKV_Q - 1)) < N;
      cp_async4(st + 2 * T_BYTES + tid * 4,
                ok ? src + q0 + (tid & (DKV_Q - 1)) : src, ok);
    }
  };
  // K and V join the first ring group
  load_rows<DKV_KEYS, HDP>(sK, k + head, k0, N, hd);
  load_rows<DKV_KEYS, HDP>(sV, v + head, k0, N, hd);
#pragma unroll
  for (int s = 0; s < DKV_STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  // accumulators: each is first written by an MMA (scale-d 0), so no other
  // instruction defines it and the MMAs stay asynchronous
  float st[32], dpt[32], dka[HDP / 2], dva[HDP / 2];
  uint32_t pa[4][4], dsa[4][4];
  const uint32_t kA = sK + wg * 8 * 128, vA = sV + wg * 8 * 128;
  const int cq = 2 * (lane & 3);  // this lane's query columns 8 j + cq (+1)

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DKV_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    // the slot loaded now was last read by tile t - 1's MMAs, which both
    // warpgroups waited for before the barrier
    const int nxt = t + DKV_STAGES - 1;
    if (nxt < ntiles) load_tile(nxt, nxt % DKV_STAGES);
    cp_async_commit();
    const uint32_t sq = sR + (t % DKV_STAGES) * STAGE, sdo = sq + T_BYTES;
    const float* sl =
        reinterpret_cast<const float*>(smem + (sq - s0) + 2 * T_BYTES);
    const float* sd = sl + DKV_Q;

    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint64_t bq = make_desc(sq + 2 * kk * QG, QG, 128);
      const uint64_t bdo = make_desc(sdo + 2 * kk * QG, QG, 128);
      Wgmma<64, 0, 0>::mma(st, make_desc(kA + 2 * kk * KG, KG, 128), bq,
                           kk > 0);
      Wgmma<64, 0, 0>::mma(dpt, make_desc(vA + 2 * kk * KG, KG, 128), bdo,
                           kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T as A fragments (rows: keys; K: queries): columns 8 j
    // of the accumulators are K 0-7 (j even) or 8-15 (j odd) of step j / 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + cq);
      const float2 d = *reinterpret_cast<const float2*>(sd + 8 * j + cq);
      const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
      const float p0 = exp2f(st[4 * j] * scale_log2 - l0);
      const float p1 = exp2f(st[4 * j + 1] * scale_log2 - l1);
      const float p2 = exp2f(st[4 * j + 2] * scale_log2 - l0);
      const float p3 = exp2f(st[4 * j + 3] * scale_log2 - l1);
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      dsa[j / 2][(j % 2) * 2 + 0] =
          pack_bf16(p0 * (dpt[4 * j] - d.x), p1 * (dpt[4 * j + 1] - d.y));
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dpt[4 * j + 2] - d.x), p3 * (dpt[4 * j + 3] - d.y));
    }

    fence_regs(dka);
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < DKV_Q / 16; ++kq) {
      // B MN-major: K (queries) groups 128 bytes apart, N (head dims) QG
      const int on = t > 0 || kq > 0;
      WgmmaRS<HDP, 1>::mma(dva, pa[kq], make_desc(sdo + 2 * kq * 128, 128, QG),
                          on);
      WgmmaRS<HDP, 1>::mma(dka, dsa[kq], make_desc(sq + 2 * kq * 128, 128, QG),
                          on);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
#pragma unroll
    for (int kq = 0; kq < DKV_Q / 16; ++kq) {
      fence_regs(pa[kq]);
      fence_regs(dsa[kq]);
    }
  }
  cp_async_wait<0>();

  // rows 16 w + lane / 4 (+ 8) of the warpgroup's 64 keys, head dims
  // 8 j + cq (+ 1); hd is even, so a pair is either stored or past hd
  const int row0 = k0 + 64 * wg + 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= N) continue;
      const int64_t off = head + (int64_t)row * hd + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(
          dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
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
  const int smem = 2 * DKV_KEYS * HDP * 2 +
                   DKV_STAGES * (2 * DKV_Q * HDP * 2 + 2 * DKV_Q * 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + DKV_KEYS - 1) / DKV_KEYS, a.BH);
  flash_attention_bwd_dkv_kernel<HDP><<<grid, DKV_THREADS, smem, st>>>(
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

// the head-dim instantiations of the backward: hd up to 80, padded to 16
// (HDP)
cudaError_t dispatch_dkv(const BwdArgs& a, cudaStream_t st) {
  if (a.hd <= 16) return launch_bwd_dkv<16>(a, st);
  if (a.hd <= 32) return launch_bwd_dkv<32>(a, st);
  if (a.hd <= 48) return launch_bwd_dkv<48>(a, st);
  if (a.hd <= 64) return launch_bwd_dkv<64>(a, st);
  return launch_bwd_dkv<80>(a, st);
}

cudaError_t dispatch_dq(const BwdArgs& a, cudaStream_t st) {
  if (a.hd <= 16) return launch_bwd_dq<16>(a, st);
  if (a.hd <= 32) return launch_bwd_dq<32>(a, st);
  if (a.hd <= 48) return launch_bwd_dq<48>(a, st);
  if (a.hd <= 64) return launch_bwd_dq<64>(a, st);
  return launch_bwd_dq<80>(a, st);
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
      dispatch_dkv(a, static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(dispatch_dq(a, static_cast<cudaStream_t>(stream)));
}
