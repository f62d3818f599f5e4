// Weight gradient of the 3x3x3 convolution on channels-last (NDHWC) bf16
// volumes, stride 1 ("same"; zero, reflect, replicate or circular padding,
// a mode per axis) or stride 2 (zero
// padding 1), as one implicit GEMM on Hopper's warpgroup MMA (sm_90a), with
// a plain C interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   T-w anatomix_tpu/ops/pallas/conv_block_train.py  _wgrad_halo_wide,
//       _wgrad_halo, _wgrad   (dW of K1 in block space, f32 accumulators
//       resident across the whole sequential grid)
// and the stride-2 conv's weight gradient of the ViT tokenizer's
// pretraining step (JAX differentiates XLA's conv there):
//   dW[(tap * Ci + ci), co] = sum over (b, o) of x_pad[b, s o + tap - 1, ci]
//                             * dy[b, o, co],   s = 1 or 2,
// M = 27 * Ci (taps x input channels), N = Co, K = the positions o of dy's
// grid: B * D * H * W at stride 1, B * ceil(D/2) * ceil(H/2) * ceil(W/2) at
// stride 2, so the stride-2 gradient is read on its own grid, with no
// zeros inserted. The result is the packed (27 * Ci, Co) f32 layout of
// `kernels/conv.py`.
//
// What bounds it on an H100: the same work as the forward conv, reading x
// and dy once (the 16-channel 128^3 convs move ~64 bytes per voxel for
// ~14 kFLOP, near the card's ridge); the output is tiny. What is hard is
// the reduction over K = 4.2 M positions at 128^3 and only 1,024 at 8^3:
// the TPU carries its f32 accumulators across a sequential grid; Hopper's
// blocks run in parallel and in no order.
//
// Two designs; `kernels/conv_train.py` `wgrad_plan`, a pure function of
// the shapes, picks one per launch and passes its tiling. Both run on
// Hopper's warpgroup MMA (wgmma m64nNk16, f32 accumulators in registers)
// from a 4-stage shared-memory ring filled by cp.async ahead of the MMAs.
//
// 1. The halo brick (`wgrad_brick_kernel`), for the narrow stride-1 convs
//    (Ci <= 48 at Co = 16, Ci <= 16 at Co = 32: the 6M UNet's
//    full-resolution levels and the ViT's stem): a block owns all 27 * cp
//    rows of dW (cp = Ci padded to 8) for BN columns and reduces a run of
//    8 x 4 x 4-position bricks of dy. Per brick the ring holds x's
//    10 x 6 x 6 halo, all cp channels, stored [8-channel group][halo voxel]
//    (16-byte rows), loaded once (2.8x the brick's positions, not once per
//    tap), and dy's 128 x BN brick. The A operand of an m64 tile (rows
//    (tap, channel), K the positions) comes from registers: each warp's 16
//    rows are two (tap, channel-group) pairs, and ldmatrix.x4.trans reads
//    their 8 x 8 blocks straight from the halo, each lane pointing at its
//    position shifted by its tap, so any pairs share an m64 tile and a
//    16-channel conv wastes no rows on padding channels.
// 2. The gather ring (`wgrad_kernel`), for the rest (wide Ci, and stride 2
//    at every width): a block owns a 128 x BN tile of dW (128 (tap,
//    channel) rows; the Ci = 1 and 2 stems take 16 taps a tile) and reduces
//    a run of 64-position bricks (8 x 4 x 2 at full resolution) of dy's
//    grid. Per brick, A is, for each position and each of the tile's 16
//    (tap, 8-channel) groups, the 16 bytes of x that the tap reads there
//    (the padding's index map, src-size 0 for zeros; widths that are not a
//    multiple of 8 by scalar loads into the same layout), cached in L1,
//    where the neighbouring taps and bricks find them again; B is the
//    brick's dy rows. Both are stored MN-major in the no-swizzle core-matrix
//    layout (each 16-byte row 8 channels of one position), so wgmma takes
//    them with both transpose bits set and nothing is transposed on the way.
// The plans split the positions over enough blocks to fill the 132 SMs
// once (at 8^3 and 16^3 as at 128^3). Each block stores its partial tile
// into its split's slice of an f32 workspace (splits, 27 * Ci, Co) that the
// wrapper allocates, and `wgrad_reduce_kernel` sums the slices in a fixed
// order into dW (a plan of one split stores straight into dW): no atomics,
// so two launches on the same tensors give the same bits, and training on
// the card repeats from a state. The workspace is at most a few tens of MB
// (the dev UNet's 128^3 96 -> 32 conv: 64 splits x 332 KB), written and
// read once. The result is held to 1e-3 of max |dW| against the f32 plain
// version: the step's dW are sums of millions of products that largely
// cancel (batch norm's backward leaves dy with zero sum per channel), so
// both sides' rounding shows at ~1e-4 of the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "pad.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;      // dW rows per tile: two warpgroups x m64
constexpr int BK = 64;       // positions per ring stage (one brick)
constexpr int STAGES = 4;    // ring depth; loads run STAGES - 2 ahead
constexpr int NTHREADS = 256;
constexpr int A_BYTES = BM * BK * 2;

// the launch plan of kernels/conv_train.py `wgrad_plan`, in this order
enum PlanField {
  P_BN, P_BX, P_BY, P_BZ, P_BB, P_TILES_X, P_TILES_Y, P_TILES_Z,
  P_TILES_B, P_M_TILES, P_N_TILES, P_SPLITS, P_BRICKS, P_HALO, P_LEN
};

// halo-brick mode: 8 x 4 x 4 positions of dy read a 10 x 6 x 6 halo of x
constexpr int HB_X = 8, HB_Y = 4, HB_Z = 4;
constexpr int HB_POS = HB_X * HB_Y * HB_Z;
constexpr int HH_X = HB_X + 2, HH_Y = HB_Y + 2, HH_Z = HB_Z + 2;
constexpr int HH_VOX = HH_X * HH_Y * HH_Z;

struct WgradArgs {
  const __nv_bfloat16* x;   // (B, D, H, W, ci)
  const __nv_bfloat16* dy;  // (B, oD, oH, oW, co)
  float* dw;                // (27 * ci, co)
  float* ws;                // (splits, 27 * ci, co) partials, or null: the
                            // blocks store into dw
  int B, D, H, W, ci, cp, co;
  int oD, oH, oW, stride;
  int bx, by, bz;           // log2 of the brick's x, y, z extents
  int tiles_x, tiles_y, tiles_z;
  int n_bricks, bricks_per_split;
  int pad;                  // 2 bits an axis (D, H, W from bit 0): 0
                            // zeros, 1 reflect, 2 replicate, 3 circular
  int xvec, dyvec;
};


// where split `split`'s partial of dW row `row` goes
__device__ __forceinline__ float* partial_row(const WgradArgs& a, int split,
                                              int64_t row) {
  float* base = a.ws ? a.ws + (int64_t)split * 27 * a.ci * a.co : a.dw;
  return base + row * a.co;
}

union Pack8 {  // eight bf16 values as raw 16-bit patterns
  uint4 u;
  unsigned short h[8];
};

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int BN, bool GP>
__global__ void __launch_bounds__(NTHREADS) wgrad_kernel(const WgradArgs a) {
  constexpr int NB8 = BN / 8;
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int first = blockIdx.z * a.bricks_per_split;
  const int nsteps =
      max(min(a.bricks_per_split, a.n_bricks - first), 0);
  const int bb = 6 - a.bx - a.by - a.bz;

  // this thread gathers position p of each brick for the tile's (tap,
  // channel-group) groups 4 q .. 4 q + 3
  const int p = tid & (BK - 1);
  const int q = tid >> 6;
  const int px = p & ((1 << a.bx) - 1);
  const int py = (p >> a.bx) & ((1 << a.by) - 1);
  const int pz = (p >> (a.bx + a.by)) & ((1 << a.bz) - 1);
  const int pb = p >> (a.bx + a.by + a.bz);
  int g_tap[4], g_c[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int m = m0 + 8 * (4 * q + jj);
    g_tap[jj] = m / a.cp;
    g_c[jj] = m - g_tap[jj] * a.cp;
  }
  const uint32_t a_pos = ((p >> 3) * 16 + 4 * q) * 128 + (p & 7) * 16;

  auto load_stage = [&](int brick, int slot) {
    const uint32_t sa = s0 + slot * STAGE;
    const uint32_t sb = sa + A_BYTES;
    int t = brick;
    const int tx = t % a.tiles_x;
    t /= a.tiles_x;
    const int ty = t % a.tiles_y;
    t /= a.tiles_y;
    const int tz = t % a.tiles_z;
    const int tb = t / a.tiles_z;
    const int ox0 = tx << a.bx, oy0 = ty << a.by, oz0 = tz << a.bz;
    const int b0 = tb << bb;
    // A: x at this thread's position for 4 (tap, channel-group) pairs
    {
      const int ox = ox0 + px, oy = oy0 + py, oz = oz0 + pz, b = b0 + pb;
      const bool pos_ok =
          ox < a.oW && oy < a.oH && oz < a.oD && b < a.B;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int tap = g_tap[jj], c = g_c[jj];
        bool ok = pos_ok && tap < 27 && c < a.ci;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        int iz = a.stride * oz + kd - 1, iy = a.stride * oy + kh - 1,
            ix = a.stride * ox + kw - 1;
        pad_voxel<GP>(a.pad, a.D, a.H, a.W, iz, iy, ix, ok);
        const int64_t off =
            ok ? ((((int64_t)b * a.D + iz) * a.H + iy) * a.W + ix) * a.ci + c
               : 0;
        const uint32_t dst = sa + a_pos + jj * 128;
        if (a.xvec) {
          cp_async16_ca(dst, a.x + off, ok);
        } else {
          Pack8 v;
          v.u = make_uint4(0u, 0u, 0u, 0u);
          if (ok) {
            const unsigned short* xu =
                reinterpret_cast<const unsigned short*>(a.x) + off;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (c + j < a.ci) v.h[j] = xu[j];
            }
          }
          st_shared16(dst, v.u);
        }
      }
    }
    // B: the brick's 64 positions x BN columns of dy
    for (int e = tid; e < BK * NB8; e += NTHREADS) {
      const int kr = (e & 7) + 8 * ((e >> 3) / NB8);
      const int ng = (e >> 3) % NB8;
      const int ox = ox0 + (kr & ((1 << a.bx) - 1));
      const int oy = oy0 + ((kr >> a.bx) & ((1 << a.by) - 1));
      const int oz = oz0 + ((kr >> (a.bx + a.by)) & ((1 << a.bz) - 1));
      const int b = b0 + (kr >> (a.bx + a.by + a.bz));
      const int col = n0 + 8 * ng;
      const bool ok = ox < a.oW && oy < a.oH && oz < a.oD && b < a.B &&
                      col < a.co;
      const int64_t off =
          ok ? ((((int64_t)b * a.oD + oz) * a.oH + oy) * a.oW + ox) * a.co +
                   col
             : 0;
      const uint32_t dst = sb + ((kr >> 3) * NB8 + ng) * 128 + (kr & 7) * 16;
      if (a.dyvec) {
        cp_async16_cg(dst, a.dy + off, ok);
      } else {
        Pack8 v;
        v.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* du =
              reinterpret_cast<const unsigned short*>(a.dy) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col + j < a.co) v.h[j] = du[j];
          }
        }
        st_shared16(dst, v.u);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) load_stage(first + s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    // the slot written now was last read by brick i - 2's MMAs, which
    // every warpgroup waited for before the barrier
    const int next = i + STAGES - 2;
    if (next < nsteps) load_stage(first + next, next % STAGES);
    cp_async_commit();
    const uint32_t sa = s0 + (i % STAGES) * STAGE + wg * 8 * 128;
    const uint32_t sb = s0 + (i % STAGES) * STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A M-major: 8-row groups 128 bytes apart, 8-position groups 2048;
      // B N-major: 8-column groups 128 bytes apart, 8-position groups
      // BN * 16
      Wgmma<BN, 1, 1>::mma(acc, make_desc(sa + kk * 4096, 2048, 128),
                           make_desc(sb + kk * 2 * BN * 16, BN * 16, 128),
                           1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  fence_regs(acc);

  // epilogue: thread holds rows 16 w + l / 4 (+ 8) of its warpgroup's 64,
  // columns 8 j + 2 (l % 4) (+ 1); store them into this split's partial
  // (zeros for a split past the bricks)
  const int w = (tid >> 5) & 3, l = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + w * 16 + (l >> 2) + 8 * h;
    const int tap = m / a.cp;
    const int c = m - tap * a.cp;
    if (tap >= 27 || c >= a.ci) continue;
    float* row = partial_row(a, blockIdx.z, (int64_t)tap * a.ci + c);
#pragma unroll
    for (int j = 0; j < NB8; ++j) {
      const int col = n0 + 8 * j + 2 * (l & 3);
      if (col < a.co) row[col] = acc[4 * j + 2 * h];
      if (col + 1 < a.co) row[col + 1] = acc[4 * j + 2 * h + 1];
    }
  }
}

// The halo brick (design 1 above): each warpgroup holds up to MTW m64
// tiles of f32 accumulators and runs one register-A wgmma m64nBNk16 per
// tile and 16 positions.
// the narrow brick fits three blocks on an SM by shared memory; its
// registers are capped to keep them (at 82-86 a thread it would hold two)
template <int BN, int MTW, bool GP>
__global__ void __launch_bounds__(NTHREADS, BN == 16 && MTW <= 4 ? 3 : 1)
wgrad_brick_kernel(const WgradArgs a) {
  constexpr int NB8 = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int cgs = a.cp / 8;
  const uint32_t cg_stride = HH_VOX * 16;
  const uint32_t x_bytes = cgs * cg_stride;
  const uint32_t stage = x_bytes + HB_POS * BN * 2;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int first = blockIdx.y * a.bricks_per_split;
  const int nsteps = max(min(a.bricks_per_split, a.n_bricks - first), 0);
  const int mt_all = (27 * cgs + 7) / 8;  // m64 tiles of dW's rows
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this lane's ldmatrix row: block lj (its channel group: lj & 1; its
  // positions 0-7 or 8-15: lj >> 1), stored row li (position x = li)
  const int lj = lane >> 3, li = lane & 7;
  uint32_t a_off[MTW];
#pragma unroll
  for (int t = 0; t < MTW; ++t) {
    const int grp = (wg + 2 * t) * 8 + 2 * warp + (lj & 1);
    int tap = grp / cgs;
    const int cg = grp - tap * cgs;
    tap = min(tap, 26);  // rows past dW's end: any voxel, never stored
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    a_off[t] = cg * cg_stride + ((kd * HH_Y + kh) * HH_X + kw + li) * 16;
  }

  auto load_stage = [&](int brick, int slot) {
    const uint32_t sx = s0 + slot * stage;
    const uint32_t sdy = sx + x_bytes;
    int t = brick;
    const int ox0 = (t % a.tiles_x) * HB_X;
    t /= a.tiles_x;
    const int oy0 = (t % a.tiles_y) * HB_Y;
    t /= a.tiles_y;
    const int oz0 = (t % a.tiles_z) * HB_Z;
    const int b = t / a.tiles_z;
    for (int e = tid; e < HH_VOX * cgs; e += NTHREADS) {
      const int cg = e % cgs;
      const int v = e / cgs;
      const int hx = v % HH_X;
      const int hy = (v / HH_X) % HH_Y;
      const int hz = v / (HH_X * HH_Y);
      int iz = oz0 + hz - 1, iy = oy0 + hy - 1, ix = ox0 + hx - 1;
      const int c = cg * 8;
      bool ok = c < a.ci;
      pad_voxel<GP>(a.pad, a.D, a.H, a.W, iz, iy, ix, ok);
      const int64_t off =
          ok ? ((((int64_t)b * a.D + iz) * a.H + iy) * a.W + ix) * a.ci + c
             : 0;
      const uint32_t dst = sx + cg * cg_stride + v * 16;
      if (a.xvec) {
        cp_async16_ca(dst, a.x + off, ok);
      } else {
        Pack8 val;
        val.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* xu =
              reinterpret_cast<const unsigned short*>(a.x) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < a.ci) val.h[j] = xu[j];
          }
        }
        st_shared16(dst, val.u);
      }
    }
    for (int e = tid; e < HB_POS * NB8; e += NTHREADS) {
      const int kr = (e & 7) + 8 * ((e >> 3) / NB8);
      const int ng = (e >> 3) % NB8;
      const int ox = ox0 + (kr & 7), oy = oy0 + ((kr >> 3) & 3),
                oz = oz0 + (kr >> 5);
      const int col = n0 + 8 * ng;
      const bool ok = ox < a.oW && oy < a.oH && oz < a.oD && col < a.co;
      const int64_t off =
          ok ? ((((int64_t)b * a.oD + oz) * a.oH + oy) * a.oW + ox) * a.co +
                   col
             : 0;
      const uint32_t dst = sdy + ((kr >> 3) * NB8 + ng) * 128 + (kr & 7) * 16;
      if (a.dyvec) {
        cp_async16_cg(dst, a.dy + off, ok);
      } else {
        Pack8 val;
        val.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* du =
              reinterpret_cast<const unsigned short*>(a.dy) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col + j < a.co) val.h[j] = du[j];
          }
        }
        st_shared16(dst, val.u);
      }
    }
  };

  float acc[MTW][BN / 2];
#pragma unroll
  for (int t = 0; t < MTW; ++t) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.f;
  }

  // every MMA is waited for inside its brick, so loads run STAGES - 1 ahead
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(first + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int next = i + STAGES - 1;
    if (next < nsteps) load_stage(first + next, next % STAGES);
    cp_async_commit();
    const uint32_t sx = s0 + (i % STAGES) * stage;
    const uint32_t sdy = sx + x_bytes;
#pragma unroll 1
    for (int ks = 0; ks < HB_POS / 16; ++ks) {
      // positions 16 ks .. 16 ks + 15: the (y, z) rows 2 ks and 2 ks + 1
      const int q = 2 * ks + (lj >> 1);
      const uint32_t row = (((q >> 2) * HH_Y + (q & 3)) * HH_X) * 16;
      uint32_t frag[MTW][4];
#pragma unroll
      for (int t = 0; t < MTW; ++t) {
        if (wg + 2 * t < mt_all) ldmatrix_x4_trans(frag[t], sx + a_off[t] + row);
      }
      const uint64_t db =
          make_desc(sdy + 2 * ks * NB8 * 128, NB8 * 128, 128);
#pragma unroll
      for (int t = 0; t < MTW; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MTW; ++t) {
        if (wg + 2 * t < mt_all) WgmmaRS<BN, 1>::mma(acc[t], frag[t], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < MTW; ++t) fence_regs(acc[t]);
    }
  }
  cp_async_wait<0>();

  // epilogue: tile wg + 2 t, rows 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1); store them into this split's partial
#pragma unroll
  for (int t = 0; t < MTW; ++t) {
    const int gm = wg + 2 * t;
    if (gm >= mt_all) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = gm * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int grp = m >> 3;
      const int tap = grp / cgs;
      const int c = (grp - tap * cgs) * 8 + (m & 7);
      if (tap >= 27 || c >= a.ci) continue;
      float* dst = partial_row(a, blockIdx.y, (int64_t)tap * a.ci + c);
#pragma unroll
      for (int j = 0; j < NB8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col < a.co) dst[col] = acc[t][4 * j + 2 * h];
        if (col + 1 < a.co) dst[col + 1] = acc[t][4 * j + 2 * h + 1];
      }
    }
  }
}

template <int BN, int MTW, bool GP>
cudaError_t launch_brick_gp(const WgradArgs& a, int n_tiles, int splits,
                            cudaStream_t stream) {
  const int smem = STAGES * (a.cp / 8 * HH_VOX * 16 + HB_POS * BN * 2);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_brick_kernel<BN, MTW, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wgrad_brick_kernel<BN, MTW, GP><<<dim3(n_tiles, splits), NTHREADS, smem,
                                    stream>>>(a);
  return cudaGetLastError();
}

template <int BN, int MTW>
cudaError_t launch_brick(const WgradArgs& a, int n_tiles, int splits,
                         cudaStream_t stream) {
  return generic_pad(a.pad)
             ? launch_brick_gp<BN, MTW, true>(a, n_tiles, splits, stream)
             : launch_brick_gp<BN, MTW, false>(a, n_tiles, splits, stream);
}

template <int BN, bool GP>
cudaError_t launch_ring(const WgradArgs& a, int m_tiles, int n_tiles,
                        int splits, cudaStream_t stream) {
  const int smem = STAGES * (A_BYTES + BK * BN * 2);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<BN, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<BN, GP><<<dim3(m_tiles, n_tiles, splits), NTHREADS, smem,
                         stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch(const WgradArgs& a, int m_tiles, int n_tiles, int splits,
                   cudaStream_t stream) {
  return generic_pad(a.pad)
             ? launch_ring<BN, true>(a, m_tiles, n_tiles, splits, stream)
             : launch_ring<BN, false>(a, m_tiles, n_tiles, splits, stream);
}

// dW = the splits' partials summed in a fixed order: a block takes 32
// consecutive elements (one a lane, so each split row is one 128-byte
// load), its warp g sums the splits g, g + 32, ... in turn, then lane's
// thread of warp 0 adds the 32 warps' sums in warp order. A serial loop
// over hundreds of splits a thread would wait on each load in turn.
constexpr int RED_WARPS = 32;

__global__ void __launch_bounds__(RED_WARPS * 32)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                    int splits, int64_t n) {
  __shared__ float part[RED_WARPS][33];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  for (int64_t e0 = blockIdx.x * 32LL; e0 < n; e0 += gridDim.x * 32LL) {
    const int64_t e = e0 + lane;
    float s = 0.f;
    if (e < n) {
#pragma unroll 4
      for (int k = grp; k < splits; k += RED_WARPS) s += ws[k * n + e];
    }
    part[grp][lane] = s;
    __syncthreads();
    if (grp == 0 && e < n) {
      float t = part[0][lane];
      for (int g = 1; g < RED_WARPS; ++g) t += part[g][lane];
      dw[e] = t;
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// dw (27 * ci, co) f32 = the weight gradient of the 3x3x3 conv of x (B, D,
// H, W, ci) at `stride` 1 (padding `pad`, 2 bits an axis; dy (B, D, H, W,
// co)) or 2 (zero padding 1; dy (B, (D+1)/2, (H+1)/2, (W+1)/2, co)), both
// bf16, under the launch plan `plan`; ws the (splits, 27 * ci, co) f32
// workspace of a plan of more than one split, else null
extern "C" int conv3x3x3_wgrad_ndhwc(const void* x, const void* dy, void* dw,
                                     void* ws, const int* plan, int B, int D,
                                     int H, int W, int ci, int co, int pad,
                                     int stride, void* stream) {
  WgradArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.dw = static_cast<float*>(dw);
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci = ci;
  a.cp = ceil_div(ci, 8) * 8;
  a.co = co;
  a.stride = stride;
  a.oD = stride == 2 ? ceil_div(D, 2) : D;
  a.oH = stride == 2 ? ceil_div(H, 2) : H;
  a.oW = stride == 2 ? ceil_div(W, 2) : W;
  const int bn = plan[P_BN];
  a.bx = plan[P_BX];
  a.by = plan[P_BY];
  a.bz = plan[P_BZ];
  const int bb = plan[P_BB];
  a.tiles_x = plan[P_TILES_X];
  a.tiles_y = plan[P_TILES_Y];
  a.tiles_z = plan[P_TILES_Z];
  const int tiles_b = plan[P_TILES_B];
  const int m_tiles = plan[P_M_TILES];
  const int n_tiles = plan[P_N_TILES];
  const int splits = plan[P_SPLITS];
  a.bricks_per_split = plan[P_BRICKS];
  const int halo = plan[P_HALO];
  a.n_bricks = a.tiles_x * a.tiles_y * a.tiles_z * tiles_b;
  // the plan must cover dy's grid, dW's rows and columns as the kernel cuts
  // them; the halo-brick mode takes all 27 * cp rows in one block (m_tiles
  // counts its m64 tiles)
  const int mtw = (m_tiles + 1) / 2;
  const bool bad_halo =
      halo && (stride != 1 || a.bx != 3 || a.by != 2 || a.bz != 2 ||
               bb != 0 || m_tiles * 64 < 27 * a.cp ||
               !((bn == 16 && mtw <= 11) || (bn == 32 && mtw <= 4)));
  if ((stride != 1 && stride != 2) || pad < 0 || pad > 63 ||
      (stride == 2 && pad) || bad_halo || (splits > 1) != (ws != nullptr) ||
      (!halo && (a.bx + a.by + a.bz + bb != 6 || m_tiles * BM < 27 * a.cp)) ||
      a.bx < 0 || a.by < 0 || a.bz < 0 ||
      bb < 0 || (a.tiles_x << a.bx) < a.oW || (a.tiles_y << a.by) < a.oH ||
      (a.tiles_z << a.bz) < a.oD || (tiles_b << bb) < B ||
      n_tiles * bn < co || splits < 1 ||
      (int64_t)splits * a.bricks_per_split < a.n_bricks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.pad = pad;
  a.xvec = (ci % 8 == 0) && aligned16(x);
  a.dyvec = (co % 8 == 0) && aligned16(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (halo) {
    if (bn == 32) {
      err = launch_brick<32, 4>(a, n_tiles, splits, s);
    } else if (mtw <= 4) {
      err = launch_brick<16, 4>(a, n_tiles, splits, s);
    } else {
      err = launch_brick<16, 11>(a, n_tiles, splits, s);
    }
  } else {
    switch (bn) {
      case 16: err = launch<16>(a, m_tiles, n_tiles, splits, s); break;
      case 32: err = launch<32>(a, m_tiles, n_tiles, splits, s); break;
      case 64: err = launch<64>(a, m_tiles, n_tiles, splits, s); break;
      case 128: err = launch<128>(a, m_tiles, n_tiles, splits, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = (int64_t)27 * ci * co;
  int64_t blocks = (n + 31) / 32;
  if (blocks > 132 * 16) blocks = 132 * 16;
  wgrad_reduce_kernel<<<(unsigned)blocks, RED_WARPS * 32, 0, s>>>(
      a.ws, a.dw, splits, n);
  return static_cast<int>(cudaGetLastError());
}
