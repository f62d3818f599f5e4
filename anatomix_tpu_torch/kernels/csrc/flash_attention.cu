// Non-causal attention softmax(q k^T * scale) v over (B, H, N, hd) bf16 and
// its backward, written by hand for Hopper (sm_90a), with a plain C
// interface for ctypes; beside them the ViT's attention prologue (the
// per-head q/k LayerNorm, RoPE and the bf16 (B, H, N, hd) pack of q, k and
// v: `qkv_prologue`, at the end of the file).
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
// All three run on Hopper's warpgroup MMA (wgmma, `hopper.cuh`) and never
// hold an N x N tile outside registers. A block walks one side of the
// attention matrix in tiles through a cp.async ring that runs ahead of the
// MMAs, and owns the other side's rows for the whole walk:
// - forward: a block of FWD_WG warpgroups owns 64 queries each (q staged
//   once) and walks the keys in tiles of 64, K and V through a 4-stage
//   ring. S = q K^T is SS m64n64k16 (both K-major); the online softmax
//   (running row max and sum, f32, exp2 with the scale folded into log2 e)
//   runs on the accumulators, whose layout is the register-A layout of the
//   next product, so P is rounded to bf16 in registers; P V is register-A
//   m64nHDPk16 on the same V tile read MN-major (transpose bit). Given a
//   pointer it also writes each row's natural log-sum-exp (f32), which the
//   backward reads.
// - dkv: a block of two warpgroups owns 128 keys (K and V staged once) and
//   walks the queries in tiles of 64, q and dO through the ring; S^T and
//   dP^T on SS, P^T and dS^T as register-A fragments, dV += P^T dO and dK +=
//   dS^T q reading the same q and dO tiles MN-major.
// - dq: the forward's walk, with dO staged beside q: S = q K^T and dP = dO
//   V^T on SS (K and V K-major), dS = P (dP - di) rounded to bf16
//   register-A fragments, dQ += dS K on the same K tile read MN-major.
// So every operand tile is staged once and never transposed by a copy.
// di = sum(o * dO) is one f32 reduction outside, as JAX takes it in XLA;
// P and dS are rounded to bf16 for the products. Each block writes only its
// own rows: no atomics, the same bits on every launch, as the TPU kernels
// give.
//
// Every tile lies in shared memory as no-swizzle core matrices (8 rows x 8
// head dims, 128 bytes), head-dim group major: core (row group i, head-dim
// group j) of an R-row tile at (j R / 8 + i) x 128. Read K-major, core
// matrices adjacent along the rows are 128 bytes apart and along the head
// dims R / 8 x 128; read MN-major the other way round. A (B, H, N, hd) row
// of 66 bf16 is 132 bytes, only 4-byte aligned, so the tiles come in by
// 4-byte cp.async, one warp filling one core matrix per instruction; head
// dims past hd and rows past N are zero-filled by the copy.
//
// What bounds them on an H100: the staging of the walked side, then the
// MMAs. At B2 H6 N4104 hd66 the forward does 4 B H N^2 hd = 5.3e10 FLOP,
// dkv 8 B H N^2 hd = 1.07e11 and dq 6 B H N^2 hd = 8.0e10 (0.05-0.11 ms at
// the bf16 peak), on a few MB of input; but each block stages the whole of
// the walked side of its head from L2, N / rows-per-block times per head
// (at 192 queries a block ~290 MB a launch for the forward and dq). Hence
// the rows per block are as many as registers allow (the forward at hd <=
// 80 and dq: three warpgroups, 192 rows; the forward at hd 128: two), the
// copies run a ring ahead of the MMAs, and within a warpgroup the next
// tile's S (and dP) MMAs are issued before this tile's P V (dS K) so the
// softmax of one tile overlaps the tensor cores' work on the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 64;    // keys per ring tile (forward, dq)
constexpr int RING = 4;   // ring stages (forward, dq): tile t + 1 is read
                          // while t + 2 and t + 3 are in flight

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + R) of one (N, hd) head into the core-matrix tile at `dst`
// (core (row group i, head-dim group j) at (j * R / 8 + i) * 128), by the
// block's NT / 32 warps, each filling one core matrix per 4-byte cp.async
// (lane l: row l / 4 of the core, head dims 2 (l % 4) and + 1); zeros past
// N and past hd
template <int R, int HDP, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int r0,
                                          int N, int hd) {
  constexpr int RG = R / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, col_in = 2 * (lane & 3);
#pragma unroll 2
  for (int c = warp; c < RG * (HDP / 8); c += NT / 32) {
    const int j = c / RG, i = c - j * RG;
    const int row = r0 + 8 * i + r, col = 8 * j + col_in;
    const bool ok = row < N && col < hd;
    hopper::cp_async4(dst + c * 128 + lane * 4,
                      ok ? src + (int64_t)row * hd + col : src, ok);
  }
}

// the accumulator of an m64n64 product (thread: rows r, r + 8 of its warp's
// 16, columns 8 j + 2 (lane % 4) (+ 1)) as register-A fragments of the next
// product, whose K is those 64 columns: K step kk takes column blocks 2 kk
// (K 0-7) and 2 kk + 1 (K 8-15)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[4 * j], s[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
}

// sum (or max) of a row over the four lanes of a quad that hold it
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Forward. A block of NWG warpgroups owns 64 NWG queries; q joins the first
// ring group. Per key tile t and warpgroup (rows 64 wg ..):
//   S = q K_t^T        SS m64n64k16 over HDP / 16 head-dim steps;
//   online softmax     s <- s scale log2 e (keys past N: -inf), m_t = max(
//                      m_{t-1}, row max), alpha_t = exp2(m_{t-1} - m_t),
//                      s <- exp2(s - m_t), l = l alpha_t + row sum;
//   O_t = P_t V_t      register-A m64nHDPk16 on the V tile read MN-major,
//                      into a fresh accumulator (scale-d 0 on the first
//                      step), folded in plain registers: O = O alpha_t +
//                      O_t.
// The fold keeps every definition of an MMA accumulator an MMA's, so ptxas
// keeps the wgmmas asynchronous (a rescale of a live accumulator serializes
// them, C7515). Order within an iteration: S of tile t + 1 and O_t are
// issued back to back; the softmax of tile t + 1 runs once its S is in
// (wgmma_wait<1>) while O_t is still on the tensor cores; P_{t+1} is packed
// after O_t retires (its fragments are O_t's A operand).
template <int HDP, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int N, int hd,
                       float scale_log2) {
  using namespace hopper;
  constexpr int NT = NWG * 128;
  constexpr int BQ = NWG * 64;
  constexpr int QG = BQ / 8 * 128;  // q: next head-dim group
  constexpr int KG = KT / 8 * 128;  // K, V tile: next head-dim group
  constexpr int T_BYTES = KT * HDP * 2;
  constexpr int STAGE = 2 * T_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem), sR = sQ + BQ * HDP * 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = (tid >> 5) & 3, wg = tid >> 7;
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (N + KT - 1) / KT;

  auto load_kv = [&](int t) {
    const uint32_t st = sR + (t % RING) * STAGE;
    load_rows<KT, HDP, NT>(st, k + head, t * KT, N, hd);
    load_rows<KT, HDP, NT>(st + T_BYTES, v + head, t * KT, N, hd);
  };
  load_rows<BQ, HDP, NT>(sQ, q + head, q0, N, hd);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // S and O_t are declared where an MMA first writes them (scale-d 0), so
  // no other instruction defines an accumulator and the MMAs stay
  // asynchronous; O is only ever plain registers
  float o[HDP / 2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  const uint32_t qA = sQ + wg * 8 * 128;
  const int cq = 2 * (lane & 3);  // this lane's key columns 8 j + cq (+ 1)
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r, r + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of their sums
  float al0 = 0.f, al1 = 0.f;            // alpha of the tile to fold next

  auto issue_s = [&](float (&s)[32], int t) {
    const uint32_t sk = sR + (t % RING) * STAGE;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      Wgmma<64, 0, 0>::mma(s, make_desc(qA + 2 * kk * QG, QG, 128),
                           make_desc(sk + 2 * kk * KG, KG, 128), kk > 0);
    }
    wgmma_commit();
  };
  auto softmax = [&](float (&s)[32], int t) {
    const int key0 = t * KT + cq;
    const bool ragged = t * KT + KT > N;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool dead = ragged && key0 + 8 * j + h >= N;
        s[4 * j + h] = dead ? -INFINITY : s[4 * j + h] * scale_log2;
        s[4 * j + 2 + h] = dead ? -INFINITY : s[4 * j + 2 + h] * scale_log2;
        mx0 = fmaxf(mx0, s[4 * j + h]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + h]);
      }
    }
    // every tile starts below N, so each row's max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    al0 = exp2f(m0 - mn0);
    al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[4 * j + h] = exp2f(s[4 * j + h] - mn0);
        s[4 * j + 2 + h] = exp2f(s[4 * j + 2 + h] - mn1);
        r0 += s[4 * j + h];
        r1 += s[4 * j + 2 + h];
      }
    }
    l0 = l0 * al0 + r0;
    l1 = l1 * al1 + r1;
  };

  // tile 0's logits and P
  cp_async_wait<RING - 2>();
  fence_proxy_async();
  __syncthreads();
  {
    float s[32];
    fence_regs(s);
    wgmma_fence();
    issue_s(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, 0);
    pack_a(pa, s);
    fence_a(pa);
  }

  auto issue_pv = [&](float (&ot)[HDP / 2], int t) {
    const uint32_t sv = sR + (t % RING) * STAGE + T_BYTES;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // B MN-major: K (keys) groups 128 bytes apart, N (head dims) KG
      WgmmaRS<HDP, 1>::mma(ot, pa[kk], make_desc(sv + 2 * kk * 128, 128, KG),
                           kk > 0);
    }
    wgmma_commit();
  };
  auto fold = [&](const float (&ot)[HDP / 2], float a0, float a1) {
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[4 * j] = o[4 * j] * a0 + ot[4 * j];
      o[4 * j + 1] = o[4 * j + 1] * a0 + ot[4 * j + 1];
      o[4 * j + 2] = o[4 * j + 2] * a1 + ot[4 * j + 2];
      o[4 * j + 3] = o[4 * j + 3] * a1 + ot[4 * j + 3];
    }
  };

  // every tile but the last: the loop body has no branch around an MMA or
  // a wait, so ptxas can see that wgmma_wait<1> retires S's group and
  // lets the softmax read it while O_t runs
  for (int t = 0; t + 1 < ntiles; ++t) {
    // tile t + 1 has landed; the slot loaded now held tile t - 1, whose
    // MMAs every warpgroup retired before the barrier
    cp_async_wait<RING - 3>();
    fence_proxy_async();
    __syncthreads();
    if (t + RING - 1 < ntiles) load_kv(t + RING - 1);
    cp_async_commit();

    float s[32], ot[HDP / 2];
    fence_regs(s);
    fence_regs(ot);
    wgmma_fence();
    issue_s(s, t + 1);
    issue_pv(ot, t);
    const float a0 = al0, a1 = al1;
    wgmma_wait<1>();
    fence_regs(s);
    softmax(s, t + 1);
    wgmma_wait<0>();
    fence_regs(ot);
    fence_a(pa);
    fold(ot, a0, a1);
    pack_a(pa, s);
    fence_a(pa);
  }
  {
    // the last tile (landed and behind a barrier: the prologue's for one
    // tile, else the last iteration's)
    float ot[HDP / 2];
    fence_regs(ot);
    wgmma_fence();
    issue_pv(ot, ntiles - 1);
    wgmma_wait<0>();
    fence_regs(ot);
    fold(ot, al0, al1);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + 64 * wg + 16 * w + (lane >> 2), row1 = row0 + 8;
  if (lse != nullptr && (lane & 3) == 0) {
    // natural log-sum-exp of the scaled logits: m and l are in base 2
    const float ln2 = 0.6931471805599453f;
    if (row0 < N) lse[(int64_t)blockIdx.y * N + row0] = (m0 + log2f(l0)) * ln2;
    if (row1 < N) lse[(int64_t)blockIdx.y * N + row1] = (m1 + log2f(l1)) * ln2;
  }
  // head dims 8 j + cq (+ 1); hd is even, so a pair is stored whole or not
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
    if (row0 < N) {
      *reinterpret_cast<__nv_bfloat162*>(out + head + (int64_t)row0 * hd +
                                         col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (row1 < N) {
      *reinterpret_cast<__nv_bfloat162*>(out + head + (int64_t)row1 * hd +
                                         col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// warpgroups of a forward block: three (192 queries) up to hd 80, two at
// hd 128, where O and its tile take 128 registers a thread
template <int HDP>
constexpr int fwd_wg() {
  return HDP <= 80 ? 3 : 2;
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int N, int hd, float scale,
                   cudaStream_t st) {
  constexpr int NWG = fwd_wg<HDP>();
  constexpr int BQ = NWG * 64;
  const int smem = BQ * HDP * 2 + RING * 2 * KT * HDP * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HDP, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, BH);
  flash_attention_kernel<HDP, NWG><<<grid, NWG * 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, hd,
      scale * LOG2E);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward: dK and dV (key side), dQ (query side)

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
// Every tile is staged once as core matrices (file header) and read both
// K-major and MN-major. A query past N is a zero row of q and dO (its lse
// and di read 0): its P^T is finite and its dS^T 0, so it adds nothing; a
// key past N is a zero row whose dK and dV are not stored. dK and dV stay
// in f32 registers for the whole walk; dK is scaled once at the end, and
// each block writes only its own key rows (deterministic, no atomics).
constexpr int DKV_KEYS = 128;  // keys per block: 64 per warpgroup
constexpr int DKV_Q = 64;      // queries per ring tile
constexpr int DKV_STAGES = 3;
constexpr int DKV_THREADS = 256;

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
    load_rows<DKV_Q, HDP, DKV_THREADS>(st, q + head, q0, N, hd);
    load_rows<DKV_Q, HDP, DKV_THREADS>(st + T_BYTES, dout + head, q0, N, hd);
    if (tid < 2 * DKV_Q) {
      const float* src = (tid < DKV_Q ? lse : di) + hrow;
      const bool ok = q0 + (tid & (DKV_Q - 1)) < N;
      cp_async4(st + 2 * T_BYTES + tid * 4,
                ok ? src + q0 + (tid & (DKV_Q - 1)) : src, ok);
    }
  };
  // K and V join the first ring group
  load_rows<DKV_KEYS, HDP, DKV_THREADS>(sK, k + head, k0, N, hd);
  load_rows<DKV_KEYS, HDP, DKV_THREADS>(sV, v + head, k0, N, hd);
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

// Query side: the forward's walk. A block of NWG warpgroups owns 64 NWG
// queries (q and dO staged once, in the first ring group; lse and di of the
// thread's two rows in registers) and walks the keys in tiles of 64, K and V
// through the ring. Per tile t and warpgroup:
//   S = q K_t^T, dP = dO V_t^T   SS m64n64k16, K and V read K-major;
//   P = exp2(S scale log2 e - lse log2 e) (keys past N: 0), dS = P (dP -
//                                di), rounded to bf16 register-A fragments;
//   dQ += dS K_t                 register-A m64nHDPk16 on the same K tile
//                                read MN-major.
// dQ is an MMA accumulator for the whole walk (scale-d 0 on the first step)
// and is scaled once at the end, as dkv does with dK. As in the forward,
// the next tile's S and dP are issued before this tile's dS K, and its dS
// is computed while dS K runs. A query past N is a zero row of q and dO
// with lse +inf: its P is 0; it is not stored.
template <int HDP, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              float* __restrict__ dq, int N, int hd,
                              float scale, float scale_log2) {
  using namespace hopper;
  constexpr int NT = NWG * 128;
  constexpr int BQ = NWG * 64;
  constexpr int QG = BQ / 8 * 128;  // q, dO: next head-dim group
  constexpr int KG = KT / 8 * 128;  // K, V tile: next head-dim group
  constexpr int Q_BYTES = BQ * HDP * 2;
  constexpr int T_BYTES = KT * HDP * 2;
  constexpr int STAGE = 2 * T_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem), sDO = sQ + Q_BYTES;
  const uint32_t sR = sQ + 2 * Q_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = (tid >> 5) & 3, wg = tid >> 7;
  const int64_t head = (int64_t)blockIdx.y * N * hd;
  const int64_t hrow = (int64_t)blockIdx.y * N;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (N + KT - 1) / KT;

  auto load_kv = [&](int t) {
    const uint32_t st = sR + (t % RING) * STAGE;
    load_rows<KT, HDP, NT>(st, k + head, t * KT, N, hd);
    load_rows<KT, HDP, NT>(st + T_BYTES, v + head, t * KT, N, hd);
  };
  load_rows<BQ, HDP, NT>(sQ, q + head, q0, N, hd);
  load_rows<BQ, HDP, NT>(sDO, dout + head, q0, N, hd);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  const int row0 = q0 + 64 * wg + 16 * w + (lane >> 2), row1 = row0 + 8;
  // rows past N: lse +inf gives P = 0
  const float l0 = row0 < N ? lse[hrow + row0] * LOG2E : INFINITY;
  const float l1 = row1 < N ? lse[hrow + row1] * LOG2E : INFINITY;
  const float d0 = row0 < N ? di[hrow + row0] : 0.f;
  const float d1 = row1 < N ? di[hrow + row1] : 0.f;

  // accumulators: each is first written by an MMA (scale-d 0), so no other
  // instruction defines it and the MMAs stay asynchronous; S and dP are
  // declared afresh for each tile
  float dqa[HDP / 2];
  uint32_t dsa[4][4];
  const uint32_t qA = sQ + wg * 8 * 128, doA = sDO + wg * 8 * 128;
  const int cq = 2 * (lane & 3);  // this lane's key columns 8 j + cq (+ 1)

  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int t) {
    const uint32_t sk = sR + (t % RING) * STAGE, sv = sk + T_BYTES;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      Wgmma<64, 0, 0>::mma(s, make_desc(qA + 2 * kk * QG, QG, 128),
                           make_desc(sk + 2 * kk * KG, KG, 128), kk > 0);
      Wgmma<64, 0, 0>::mma(dp, make_desc(doA + 2 * kk * QG, QG, 128),
                           make_desc(sv + 2 * kk * KG, KG, 128), kk > 0);
    }
    wgmma_commit();
  };
  // s <- dS = P (dP - di) in f32, P 0 for keys past N
  auto dscores = [&](float (&s)[32], const float (&dp)[32], int t) {
    const int key0 = t * KT + cq;
    const bool ragged = t * KT + KT > N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool dead = ragged && key0 + 8 * j + h >= N;
        const float p0 = dead ? 0.f : exp2f(s[4 * j + h] * scale_log2 - l0);
        const float p1 =
            dead ? 0.f : exp2f(s[4 * j + 2 + h] * scale_log2 - l1);
        s[4 * j + h] = p0 * (dp[4 * j + h] - d0);
        s[4 * j + 2 + h] = p1 * (dp[4 * j + 2 + h] - d1);
      }
    }
  };

  // tile 0's dS
  cp_async_wait<RING - 2>();
  fence_proxy_async();
  __syncthreads();
  {
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_sdp(s, dp, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dscores(s, dp, 0);
    pack_a(dsa, s);
    fence_a(dsa);
  }

  auto issue_dq = [&](int t) {
    const uint32_t sk = sR + (t % RING) * STAGE;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // B MN-major: K (keys) groups 128 bytes apart, N (head dims) KG
      WgmmaRS<HDP, 1>::mma(dqa, dsa[kk], make_desc(sk + 2 * kk * 128, 128, KG),
                           t > 0 || kk > 0);
    }
    wgmma_commit();
  };

  // every tile but the last, with no branch around an MMA or a wait (see
  // the forward)
  for (int t = 0; t + 1 < ntiles; ++t) {
    // tile t + 1 has landed; the slot loaded now held tile t - 1
    cp_async_wait<RING - 3>();
    fence_proxy_async();
    __syncthreads();
    if (t + RING - 1 < ntiles) load_kv(t + RING - 1);
    cp_async_commit();

    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dqa);
    wgmma_fence();
    issue_sdp(s, dp, t + 1);
    issue_dq(t);
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    dscores(s, dp, t + 1);
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_a(dsa);
    pack_a(dsa, s);
    fence_a(dsa);
  }
  fence_regs(dqa);
  wgmma_fence();
  issue_dq(ntiles - 1);
  wgmma_wait<0>();
  fence_regs(dqa);

  // head dims 8 j + cq (+ 1); hd is even, so a pair is stored whole or not
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
    if (row0 < N) {
      *reinterpret_cast<float2*>(dq + head + (int64_t)row0 * hd + col) =
          make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(dq + head + (int64_t)row1 * hd + col) =
          make_float2(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
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

// dq's warpgroups a block: three (192 queries)
constexpr int DQ_WG = 3;

template <int HDP>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t st) {
  constexpr int BQ = DQ_WG * 64;
  const int smem = 2 * BQ * HDP * 2 + RING * 2 * KT * HDP * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<HDP, DQ_WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BQ - 1) / BQ, a.BH);
  flash_attention_bwd_dq_kernel<HDP, DQ_WG><<<grid, DQ_WG * 128, smem, st>>>(
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


// ---------------------------------------------------------------------------
// The attention prologue of an EVA block, between the q/k/v projections and
// the forward above. It replaces no Pallas kernel: the JAX package leaves
// the per-head q/k LayerNorm, the rotary embedding and the cast to XLA.
// The projections leave q, k and v as (B, N, H hd) f32, which is (rows, hd)
// with a row per (sample, token, head). Per row, in f32: for q and k, the
// LayerNorm over hd (biased variance, eps, affine) when given its
// parameters, then, when given the tables and the token n is not one of
// the first R (the registers), the rotation of the interleaved pairs
// (2i, 2i + 1) by the cos/sin row of token n - R, its products and sums in
// the plain version's order (x0 c - x1 s, x0 s + x1 c; no contraction into
// FMAs); v only moves. Each row is rounded once to bf16 and stored into
// (B, H, N, hd), the layout the forward reads.
//
// What bounds it: bytes. At B2 N4104 H6 hd66 a call reads 39 MB of f32 and
// writes 19.5 MB of bf16 (17.5 us at 3.35 TB/s); the arithmetic is a few
// flops a byte. So the design is one pass with every load in flight early:
// a warp owns PRO_RW consecutive rows (consecutive heads of a token: 1056
// contiguous bytes at hd 66), lane l holds pairs l and l + 32 (hd <= 128)
// as 8-byte float2 loads (a row starts at an even float, so every pair is
// 8-byte aligned), all issued before any arithmetic. The mean and the
// variance come from registers by xor shuffles (every lane ends with the
// same bits), two passes over the registers, the rows' shuffles side by
// side so that their latencies overlap; no atomics, so two launches give
// the same bits. Each lane stores one bf16x2 a pair. The affines are read
// once a warp; the tables (1.1 MB at the cell's shape) stay in L2.
// blockIdx.y picks q, k or v, so the branches on the norm and the rotation
// are uniform in a block.
constexpr int PRO_THREADS = 256;
constexpr int PRO_RW = 4;  // rows a warp

// Fields by name, picked by blockIdx.y through selects: an array indexed
// by it would copy the whole argument block to each thread's stack.
struct PrologueArgs {
  const float *q, *k, *v;       // (rows, hd) f32
  __nv_bfloat16 *qo, *ko, *vo;  // (B, H, N, hd) bf16
  const float *q_w, *q_b;       // q_norm weight and bias (hd): null: no norm
  const float *k_w, *k_b;
  const float* cos;             // (N - R, hd / 2) f32: null: no rotation
  const float* sin;
  int64_t rows;                 // B N H
  int N, H, hd, R;
  float eps;
};

__global__ void __launch_bounds__(PRO_THREADS)
qkv_prologue_kernel(const PrologueArgs a) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int np = a.hd >> 1;
  const int64_t row0 =
      ((int64_t)blockIdx.x * (PRO_THREADS / 32) + (threadIdx.x >> 5)) *
      PRO_RW;
  const float2* src =
      reinterpret_cast<const float2*>(t == 0 ? a.q : t == 1 ? a.k : a.v);
  // slot s of a row: pair lane + 32 s; rows past the last hold zeros,
  // which normalize to finite values and are not stored
  bool slot[2];
  float2 x[PRO_RW][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) slot[s] = lane + 32 * s < np;
#pragma unroll
  for (int j = 0; j < PRO_RW; ++j) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      x[j][s] = row0 + j < a.rows && slot[s]
                    ? __ldg(src + (row0 + j) * np + lane + 32 * s)
                    : make_float2(0.f, 0.f);
    }
  }
  if (t < 2 && a.q_w != nullptr) {
    const float2* w = reinterpret_cast<const float2*>(t ? a.k_w : a.q_w);
    const float2* b = reinterpret_cast<const float2*>(t ? a.k_b : a.q_b);
    float2 wp[2], bp[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wp[s] = slot[s] ? __ldg(w + lane + 32 * s) : make_float2(0.f, 0.f);
      bp[s] = slot[s] ? __ldg(b + lane + 32 * s) : make_float2(0.f, 0.f);
    }
    // the rows' sums side by side, so their shuffles overlap
    float mean[PRO_RW], m2[PRO_RW];
#pragma unroll
    for (int j = 0; j < PRO_RW; ++j) {
      mean[j] = (x[j][0].x + x[j][0].y) + (x[j][1].x + x[j][1].y);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < PRO_RW; ++j) {
        mean[j] += __shfl_xor_sync(0xffffffffu, mean[j], m);
      }
    }
#pragma unroll
    for (int j = 0; j < PRO_RW; ++j) {
      mean[j] = __fdiv_rn(mean[j], (float)a.hd);
      m2[j] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (slot[s]) {
          const float d0 = x[j][s].x - mean[j], d1 = x[j][s].y - mean[j];
          m2[j] += d0 * d0 + d1 * d1;
        }
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < PRO_RW; ++j) {
        m2[j] += __shfl_xor_sync(0xffffffffu, m2[j], m);
      }
    }
#pragma unroll
    for (int j = 0; j < PRO_RW; ++j) {
      const float rstd = __frsqrt_rn(
          __fadd_rn(__fdiv_rn(m2[j], (float)a.hd), a.eps));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        x[j][s].x = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(x[j][s].x, mean[j]), rstd),
                      wp[s].x),
            bp[s].x);
        x[j][s].y = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(x[j][s].y, mean[j]), rstd),
                      wp[s].y),
            bp[s].y);
      }
    }
  }
  const bool rope = t < 2 && a.cos != nullptr;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      t == 0 ? a.qo : t == 1 ? a.ko : a.vo);
  // (sample, token, head) of the first row, by one 32-bit division each
  // (rows < 2^31); the next rows step the head
  const int r0 = (int)row0;
  int h = r0 % a.H, n = (r0 / a.H) % a.N, bi = r0 / a.H / a.N;
#pragma unroll
  for (int j = 0; j < PRO_RW; ++j) {
    if (row0 + j >= a.rows) break;  // the same for the whole warp
    if (j > 0 && ++h == a.H) {
      h = 0;
      if (++n == a.N) n = 0, ++bi;
    }
    __nv_bfloat162* dst = out + (((int64_t)bi * a.H + h) * a.N + n) * np;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!slot[s]) continue;
      const int p = lane + 32 * s;
      float y0 = x[j][s].x, y1 = x[j][s].y;
      if (rope && n >= a.R) {
        const int64_t i = (int64_t)(n - a.R) * np + p;
        const float c = __ldg(a.cos + i), sn = __ldg(a.sin + i);
        y0 = __fsub_rn(__fmul_rn(x[j][s].x, c), __fmul_rn(x[j][s].y, sn));
        y1 = __fadd_rn(__fmul_rn(x[j][s].x, sn), __fmul_rn(x[j][s].y, c));
      }
      dst[p] = __floats2bfloat162_rn(y0, y1);
    }
  }
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

// The attention prologue (above `qkv_prologue_kernel`): q, k, v contiguous
// (B, N, H hd) f32, 8-byte aligned; qo, ko, vo contiguous (B, H, N, hd)
// bf16; hd even and at most 128. q_w, q_b, k_w, k_b: the (hd) f32 affines
// of the per-head LayerNorms, all null for none; cos, sin: (N - R, hd / 2)
// f32 rotary tables, both null for no rotation; R in [0, N] register tokens
// come first and are not rotated.
extern "C" int qkv_prologue(const void* q, const void* k, const void* v,
                            const void* q_w, const void* q_b,
                            const void* k_w, const void* k_b,
                            const void* cos, const void* sin, void* qo,
                            void* ko, void* vo, int B, int N, int H, int hd,
                            int R, float eps, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || hd <= 0 || hd % 2 || hd > 128 ||
      R < 0 || R > N || (q_w == nullptr) != (k_w == nullptr) ||
      (cos == nullptr) != (sin == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PrologueArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.qo = static_cast<__nv_bfloat16*>(qo);
  a.ko = static_cast<__nv_bfloat16*>(ko);
  a.vo = static_cast<__nv_bfloat16*>(vo);
  a.q_w = static_cast<const float*>(q_w);
  a.q_b = static_cast<const float*>(q_b);
  a.k_w = static_cast<const float*>(k_w);
  a.k_b = static_cast<const float*>(k_b);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.rows = (int64_t)B * N * H;
  a.N = N;
  a.H = H;
  a.hd = hd;
  a.R = R;
  a.eps = eps;
  // the kernel's (sample, token, head) arithmetic is 32-bit
  if (a.rows > 2147483647 - 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int per_block = PRO_THREADS / 32 * PRO_RW;
  dim3 grid(static_cast<unsigned>((a.rows + per_block - 1) / per_block), 3);
  qkv_prologue_kernel<<<grid, PRO_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
