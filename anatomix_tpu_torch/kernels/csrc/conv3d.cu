// 3x3x3 convolutions on channels-last (NDHWC) bf16 volumes as one implicit
// GEMM on Hopper's warpgroup MMA (sm_90a), with a plain C interface for
// ctypes.
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
// GEMM: M = output voxels, N = Co, K = taps x Ci, on Hopper's warpgroup
// MMA (wgmma m64nNk16, bf16 operands from shared memory, f32 accumulators
// in registers).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s). The 16-channel
// full-resolution convs of the 6M UNet move ~64 bytes per voxel for ~14
// kFLOP, near the card's ridge (~295 FLOP per byte): bytes and the tensor
// rate both matter, and a kernel that re-reads its input per tap from L2
// pays for it. The wide full-resolution convs (the dev UNet's and the ViT
// tokenizer's, on the three-term split at 3 Ci) are operation bound. The
// deep convs at 4^3 and 8^3 (K1 3072 -> 1024, the D3 decoder over 4608
// channels) read a weight matrix of 42-170 MB for 128-1024 output voxels:
// they are bound by reading the weights once, which takes the whole card.
//
// Three designs share the entry points; `kernels/conv.py` `conv_plan`, a
// pure function of the shapes, picks one per launch and passes its tiling.
//
// 1. The halo brick (`conv_brick_kernel`), for N tiles up to 64 where the
//    output grid has enough 8 x 8 x 4 tiles (every full-resolution conv of
//    the 6M, dev and ViT paths). The tile's 10 x 10 x 6 input halo comes in
//    by cp.async through the padding's index map (reflect -1 -> 1,
//    n -> n-2, or zeros by src-size 0; channels [c1, c1+c2) from the second
//    operand: at half resolution for K3, f_shift 1, at full resolution for
//    D3, f_shift 0), stored [8-channel group][halo voxel] in the no-swizzle
//    core-matrix layout (8 rows of 16 bytes). The A operand of tap
//    (kd, kh, kw) for one output z-plane is then the brick itself with the
//    descriptor's start moved by (kd, kh, kw) voxels: its 8-row groups are
//    the plane's 8 x-rows of 8 voxels, one halo row apart, its two K halves
//    two channel groups apart. So each input voxel is read 2.3x (600 / 256)
//    per tile and never copied per tap. The weights (N-major core matrices,
//    transpose bit set) sit beside it; each warpgroup runs two z-planes.
//    Narrow convs take all of K at once; wider ones walk it in channel
//    chunks of 16-48 whose halo and 27-tap weights fit 100 KB, so two or
//    more blocks share an SM and overlap one's loads with another's MMAs.
// 2. The gather ring (`conv_kernel`), for N tiles of 128 and the deep,
//    small grids. A block owns 128 output voxels (a brick of the grid with
//    the batch folded in where the volume is small: 4x4x4x2 at 4^3, so no
//    MMA row is padding) by BN output channels and walks K in steps of 64
//    rows (8 groups of 8 channels of one or more taps; Ci padded to 8). Each
//    step's A (the 128 voxels' channels, gathered row by row through the
//    index map, cached in L1) and B (64 x BN weights, streamed through L2)
//    come into a 3-4-stage ring by cp.async, two steps ahead of the MMAs,
//    which each warpgroup waits for only one step later. A per-step gather
//    takes any 128 voxels, which the small grids need; a brick would pad
//    them. Where tiles x N tiles leave SMs idle (the 4^3 and 8^3 convs, the
//    16^3 decoders, the small dgrads), the plan splits K over blocks (a
//    3-stage ring there, two blocks per SM): each block stores its raw f32
//    partial tile into a workspace (splits, voxels, Co) that the wrapper
//    allocates, and a second kernel sums the splits in a fixed order, then
//    applies bias and the activation and stores bf16 or f32, so the result
//    is the same bits from run to run. Each block of the 4^3 3072 -> 1024
//    conv reads its own 1/264 of the 170 MB weight matrix once.
// 3. The stride-2 conv's input gradient, below.
// Every accumulator is first written by an MMA (scale-d 0), so no other
// instruction defines it and ptxas keeps the MMAs asynchronous.
//
// The input gradient of a "same" conv (`conv3x3x3_dgrad_ndhwc`) is this
// kernel run as the transposed conv: flipped, transposed weights (packed by
// the caller, 27 * Co x Ci), zero padding, over the output grid grown by 1
// on each side (origin -1), so it reads the unpadded dy and treats the halo
// of 2 as zeros by index. For reflect padding the (S+2)^3 f32 result g is
// then folded by `pad_adjoint_kernel`: dx[i] = g[i+1] (+ g[0] if i == 1)
// (+ g[S+1] if i == S-2) on each axis, the exact adjoint of torch's reflect
// pad. For zero padding only the interior is computed, straight into dx.
//
// The input gradient of the stride-2 pad-1 conv
// (`conv3x3x3_dgrad_s2_ndhwc`) reads dy on its own grid: per axis
// dx[i] = sum over taps k with i + 1 - k even of dy[(i + 1 - k) / 2] w_k^T,
// so an even i takes the tap 1 and an odd i the taps 0 and 2: 27 tap
// products per 8 voxels of dx, with no inserted zeros. At the tokenizer's
// first stage (64 -> 32 channels) the halo brick runs it: an 8 x 8 x 4 tile
// of dy's grid and its 9 x 9 x 5 halo hold all the gradient its 2048 dx
// voxels read, and the block runs the 8 parity classes one after the other,
// each tap a shifted descriptor. Wider, the gather ring runs it with the
// parity classes on the grid's third axis, each class's tile a brick of its
// own sub-grid whose K walks only its 1-8 taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;       // output voxels per tile: two warpgroups x m64
constexpr int BK = 64;        // K rows per ring stage (8 groups of 8)
constexpr int NTHREADS = 256;
constexpr int A_BYTES = BM * BK * 2;

// the launch plan of kernels/conv.py `conv_plan`, in this order
enum PlanField {
  P_BN, P_BX, P_BY, P_BZ, P_BB, P_TILES_X, P_TILES_Y, P_TILES_Z,
  P_TILES_B, P_N_TILES, P_SPLITS, P_STEPS, P_BRICK, P_STAGES, P_CHUNK,
  P_LEN
};

// halo-brick mode: an 8 x 8 x 4 output tile reads a 10 x 10 x 6 halo
constexpr int BRICK_X = 8, BRICK_Y = 8, BRICK_Z = 4;
constexpr int HALO_X = BRICK_X + 2, HALO_Y = BRICK_Y + 2, HALO_Z = BRICK_Z + 2;
constexpr int HALO_VOX = HALO_X * HALO_Y * HALO_Z;

struct ConvArgs {
  const __nv_bfloat16* enc;    // (B, D, H, W, c1), or null if c1 == 0
  const __nv_bfloat16* small;  // (B, D>>f_shift, ..., c2), or null
  const __nv_bfloat16* w;      // (taps * (c1 + c2), co), row tap * Ci + c
  const float* bias;           // (co)
  void* out;                   // (B, oD, oH, oW, co) bf16 or f32
  float* ws;                   // (splits, B * oD * oH * oW, co) or null
  int B, D, H, W;              // the gathered grid
  int oD, oH, oW, org;         // the output grid; mode 0 reads o + org
  int gD, gH, gW;              // the tiled grid (mode 1: a class's)
  int c1, c2, cp, co;          // cp: c1 + c2 padded to 8 (brick: 16)
  int f_shift, mode;           // mode 0: stride 1; 1: stride-2 dgrad
  int bx, by, bz;              // log2 of the tile's x, y, z extents
  int tiles_x, tiles_y, tiles_z;
  int splits, steps_per_split;
  int reflect, act, out_f32;
  int xvec, wvec, fast;        // 16-byte loads; one tap per 32 channels
  int chunk;                   // halo-brick mode: channels a K chunk
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

struct Voxel {
  int b, z, y, x;
  bool valid;
};

// row r of m-tile `tile`: the tile is a 2^bx x 2^by x 2^bz brick of the
// tiled grid times the batch items that fill its remaining bits
__device__ __forceinline__ Voxel tile_voxel(const ConvArgs& a, int tile,
                                            int r) {
  int t = tile;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  t /= a.tiles_y;
  const int tz = t % a.tiles_z;
  const int tb = t / a.tiles_z;
  const int bb = 7 - a.bx - a.by - a.bz;
  Voxel v;
  v.x = (tx << a.bx) + (r & ((1 << a.bx) - 1));
  v.y = (ty << a.by) + ((r >> a.bx) & ((1 << a.by) - 1));
  v.z = (tz << a.bz) + ((r >> (a.bx + a.by)) & ((1 << a.bz) - 1));
  v.b = (tb << bb) + (r >> (a.bx + a.by + a.bz));
  v.valid = v.x < a.gW && v.y < a.gH && v.z < a.gD && v.b < a.B;
  return v;
}

// the output voxel of tiled-grid voxel g: itself in mode 0; in mode 1 its
// voxel in parity class `cls` (bits pz py px) of the output
__device__ __forceinline__ Voxel class_voxel(const ConvArgs& a, Voxel g,
                                             int cls) {
  if (a.mode == 1) {
    g.z = 2 * g.z + (cls >> 2);
    g.y = 2 * g.y + ((cls >> 1) & 1);
    g.x = 2 * g.x + (cls & 1);
    g.valid = g.valid && g.z < a.oD && g.y < a.oH && g.x < a.oW;
  }
  return g;
}

// the number of taps of parity class cls in mode 1: 1 per even axis, 2
// per odd one
__device__ __forceinline__ int class_taps(int cls) {
  return (1 + (cls & 1)) * (1 + ((cls >> 1) & 1)) * (1 + (cls >> 2));
}

// the 27-tap index (kd * 9 + kh * 3 + kw) of a class's tap ti; in mode 1
// an even coordinate takes tap 1, an odd one taps 0 and 2
__device__ __forceinline__ int tap_of(const ConvArgs& a, int ti, int cls) {
  if (a.mode == 0) return ti;
  const int px = cls & 1, py = (cls >> 1) & 1, pz = cls >> 2;
  const int nx = 1 + px, ny = 1 + py;
  const int kw = px ? 2 * (ti % nx) : 1;
  const int kh = py ? 2 * ((ti / nx) % ny) : 1;
  const int kd = pz ? 2 * (ti / (nx * ny)) : 1;
  return kd * 9 + kh * 3 + kw;
}

// the gathered voxel that tap `tap` (of 27) of output voxel `o` reads,
// with the padding's index map; `ok` false where it reads a zero. Mode 0
// reads o + k - 1 + org; mode 1 (the stride-2 conv's input gradient) reads
// the gradient at (o + 1 - k) / 2, where that is whole and in range
__device__ __forceinline__ void source_voxel(const ConvArgs& a,
                                             const Voxel& o, int tap,
                                             int& iz, int& iy, int& ix,
                                             bool& ok) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  if (a.mode == 1) {
    const int tz = o.z + 1 - kd, ty = o.y + 1 - kh, tx = o.x + 1 - kw;
    iz = tz >> 1;
    iy = ty >> 1;
    ix = tx >> 1;
    ok = ok && tz >= 0 && ty >= 0 && tx >= 0 && iz < a.D && iy < a.H &&
         ix < a.W;
    return;
  }
  iz = o.z + kd - 1 + a.org;
  iy = o.y + kh - 1 + a.org;
  ix = o.x + kw - 1 + a.org;
  if (a.reflect) {
    iz = reflect_index(iz, a.D);
    iy = reflect_index(iy, a.H);
    ix = reflect_index(ix, a.W);
  } else {
    ok = ok && iz >= 0 && iz < a.D && iy >= 0 && iy < a.H && ix >= 0 &&
         ix < a.W;
  }
}

// channel c of a gathered voxel, in the source that holds it
__device__ __forceinline__ const __nv_bfloat16* chunk_src(
    const ConvArgs& a, int b, int iz, int iy, int ix, int c) {
  if (c < a.c1) {
    return a.enc + ((((int64_t)b * a.D + iz) * a.H + iy) * a.W + ix) * a.c1 +
           c;
  }
  const int fs = a.f_shift;
  return a.small +
         ((((int64_t)b * (a.D >> fs) + (iz >> fs)) * (a.H >> fs) +
           (iy >> fs)) * (a.W >> fs) + (ix >> fs)) * a.c2 + (c - a.c1);
}

// 8 channels [c, c + 8) of a gathered voxel by scalar loads (widths that
// are not a multiple of 8), zeros past c1 + c2
__device__ __forceinline__ uint4 chunk_scalar(const ConvArgs& a, int b,
                                              int iz, int iy, int ix, int c) {
  Pack8 v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  const int ci = a.c1 + a.c2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c + j < ci) {
      v.h[j] = *reinterpret_cast<const unsigned short*>(
          chunk_src(a, b, iz, iy, ix, c + j));
    }
  }
  return v.u;
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// STAGES: the ring's depth; loads run STAGES - 2 steps ahead
template <int BN, int STAGES>
__global__ void __launch_bounds__(NTHREADS) conv_kernel(const ConvArgs a) {
  constexpr int NB8 = BN / 8;
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int cls = a.mode == 1 ? (int)blockIdx.z : 0;
  const int split = a.mode == 1 ? 0 : (int)blockIdx.z;
  const int ci = a.c1 + a.c2;
  const int k_total = (a.mode == 1 ? class_taps(cls) : 27) * a.cp;
  const int steps_all = (k_total + BK - 1) / BK;
  const int step0 = split * a.steps_per_split;
  const int nsteps = max(min(a.steps_per_split, steps_all - step0), 0);

  // this thread gathers A row r, chunks 4 jh .. 4 jh + 3 of each stage
  const int r = tid & (BM - 1);
  const int jh = tid >> 7;
  const Voxel row = class_voxel(a, tile_voxel(a, tile, r), cls);
  const uint32_t a_row = ((r >> 3) * 8 + 4 * jh) * 128 + (r & 7) * 16;

  auto load_stage = [&](int step, int slot) {
    const uint32_t sa = s0 + slot * STAGE;
    const uint32_t sb = sa + A_BYTES;
    const int k0 = step * BK;
    if (a.fast) {
      // the 4 chunks are 32 channels of one tap in one source
      const int kb = k0 + 32 * jh;
      const int ti = kb / a.cp;
      const int c = kb - ti * a.cp;
      bool ok = row.valid && kb < k_total;
      int iz = 0, iy = 0, ix = 0;
      source_voxel(a, row, tap_of(a, ti, cls), iz, iy, ix, ok);
      const __nv_bfloat16* src =
          ok ? chunk_src(a, row.b, iz, iy, ix, c) : a.w;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        cp_async16_ca(sa + a_row + jj * 128, ok ? src + 8 * jj : a.w, ok);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kb = k0 + 32 * jh + 8 * jj;
        const int ti = kb / a.cp;
        const int c = kb - ti * a.cp;
        bool ok = row.valid && kb < k_total;
        int iz = 0, iy = 0, ix = 0;
        if (ok) source_voxel(a, row, tap_of(a, ti, cls), iz, iy, ix, ok);
        const uint32_t dst = sa + a_row + jj * 128;
        if (a.xvec) {
          cp_async16_ca(dst, ok ? chunk_src(a, row.b, iz, iy, ix, c) : a.w,
                        ok);
        } else {
          st_shared16(dst, ok ? chunk_scalar(a, row.b, iz, iy, ix, c)
                              : make_uint4(0u, 0u, 0u, 0u));
        }
      }
    }
    // B: 64 K rows x BN columns of the packed weights
    for (int e = tid; e < BK * NB8; e += NTHREADS) {
      const int kr = (e & 7) + 8 * ((e >> 3) / NB8);
      const int ng = (e >> 3) % NB8;
      const int kg = k0 + kr;
      const int col = n0 + 8 * ng;
      const int ti = kg / a.cp;
      const int c = kg - ti * a.cp;
      const bool ok = kg < k_total && c < ci && col < a.co;
      const uint32_t dst = sb + ((kr >> 3) * NB8 + ng) * 128 + (kr & 7) * 16;
      const int64_t off =
          ok ? ((int64_t)tap_of(a, ti, cls) * ci + c) * a.co + col : 0;
      if (a.wvec) {
        cp_async16_cg(dst, a.w + off, ok);
      } else {
        Pack8 v;
        v.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* wu =
              reinterpret_cast<const unsigned short*>(a.w) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col + j < a.co) v.h[j] = wu[j];
          }
        }
        st_shared16(dst, v.u);
      }
    }
  };

  // the accumulators: the first MMA overwrites them (scale-d 0), so no
  // other instruction defines them and the MMAs stay asynchronous
  float acc[BN / 2];

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) load_stage(step0 + s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    // the slot written now was last read by step i - 2's MMAs, which every
    // warpgroup waited for before the barrier
    const int next = i + STAGES - 2;
    if (next < nsteps) load_stage(step0 + next, next % STAGES);
    cp_async_commit();
    const uint32_t sa = s0 + (i % STAGES) * STAGE + wg * 8 * 1024;
    const uint32_t sb = s0 + (i % STAGES) * STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A K-major: 8-row groups 1024 bytes apart, K halves 128;
      // B N-major: 8-column groups 128 bytes apart, K groups BN * 16
      Wgmma<BN, 0, 1>::mma(acc, make_desc(sa + kk * 256, 128, 1024),
                           make_desc(sb + kk * 2 * BN * 16, BN * 16, 128),
                           i > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  fence_regs(acc);

  // epilogue: thread holds rows 16 w + l / 4 (+ 8) of its warpgroup's 64,
  // columns 8 j + 2 (l % 4) (+ 1)
  const int w = (tid >> 5) & 3, l = tid & 31;
  const int64_t n_out = (int64_t)a.B * a.oD * a.oH * a.oW;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = wg * 64 + w * 16 + (l >> 2) + 8 * h;
    const Voxel o = class_voxel(a, tile_voxel(a, tile, rr), cls);
    if (!o.valid) continue;
    const int64_t vox =
        (((int64_t)o.b * a.oD + o.z) * a.oH + o.y) * a.oW + o.x;
#pragma unroll
    for (int j = 0; j < NB8; ++j) {
      const int col = n0 + 8 * j + 2 * (l & 3);
      if (col >= a.co) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const bool two = col + 1 < a.co;
      if (a.splits > 1) {
        float* dst = a.ws + ((int64_t)split * n_out + vox) * a.co + col;
        dst[0] = v0;
        if (two) dst[1] = v1;
        continue;
      }
      const float u0 = activate(v0 + a.bias[col], a.act, a.slope);
      const float u1 =
          two ? activate(v1 + a.bias[col + 1], a.act, a.slope) : 0.f;
      const int64_t off = vox * a.co + col;
      if (a.out_f32) {
        float* dst = static_cast<float*>(a.out) + off;
        if (two && (a.co & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(u0, u1);
        } else {
          dst[0] = u0;
          if (two) dst[1] = u1;
        }
      } else {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + off;
        if (two && (a.co & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(u0, u1);
        } else {
          dst[0] = __float2bfloat16(u0);
          if (two) dst[1] = __float2bfloat16(u1);
        }
      }
    }
  }
}

// The halo brick (design 1 above); mode 1 (S2) is the stride-2 input
// gradient. Registers are capped so that as many blocks as the shared
// memory admits fit on an SM: 4 at N 16, 3 at 32, 2 at 64.
template <int BN, bool S2, bool CHUNKED>
__global__ void __launch_bounds__(NTHREADS, BN == 16 ? 4 : BN == 32 ? 3 : 2)
conv_brick_kernel(const ConvArgs a) {
  constexpr int NB8 = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int hxn = S2 ? BRICK_X + 1 : HALO_X;
  constexpr int hyn = S2 ? BRICK_Y + 1 : HALO_Y;
  constexpr int hzn = S2 ? BRICK_Z + 1 : HALO_Z;
  constexpr int hvox = hxn * hyn * hzn;
  const uint32_t sx = smem_u32(smem);
  const int cgs = a.chunk / 8;                    // channel groups a chunk
  const uint32_t cg_stride = hvox * 16;           // bytes per group
  const uint32_t sw = sx + cgs * cg_stride;       // weights after the halo
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * BRICK_X;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * BRICK_Y;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * BRICK_Z;
  const int b = t / a.tiles_z;
  const int n0 = blockIdx.y * BN;
  const int ci = a.c1 + a.c2;
  const int wg = tid >> 7;
  const int w = (tid >> 5) & 3, l = tid & 31;
  const uint32_t b_lbo = NB8 * 128;
  float acc0[BN / 2], acc1[BN / 2];

  // K walks the channel chunks [c0, c0 + chunk): each chunk's halo and its
  // 27 x chunk x BN weights are loaded, then all 27 taps run on them
  for (int c0 = 0; c0 < (CHUNKED ? a.cp : 1); c0 += a.chunk) {
    if (c0 > 0) __syncthreads();  // the last chunk's MMAs are done
    // the halo: (voxel, channel group) items, the group fastest
    for (int e = tid; e < hvox * cgs; e += NTHREADS) {
      const int cg = e % cgs;
      const int v = e / cgs;
      const int hx = v % hxn;
      const int hy = (v / hxn) % hyn;
      const int hz = v / (hxn * hyn);
      const int lo = S2 ? 0 : 1 - a.org;
      int iz = z0 + hz - lo, iy = y0 + hy - lo, ix = x0 + hx - lo;
      const int c = c0 + cg * 8;
      bool ok = c < ci;
      if (a.reflect) {
        iz = reflect_index(iz, a.D);
        iy = reflect_index(iy, a.H);
        ix = reflect_index(ix, a.W);
      } else {
        ok = ok && iz >= 0 && iz < a.D && iy >= 0 && iy < a.H && ix >= 0 &&
             ix < a.W;
      }
      const uint32_t dst = sx + cg * cg_stride + v * 16;
      if (a.xvec) {
        cp_async16_ca(dst, ok ? chunk_src(a, b, iz, iy, ix, c) : a.w, ok);
      } else {
        st_shared16(dst, ok ? chunk_scalar(a, b, iz, iy, ix, c)
                            : make_uint4(0u, 0u, 0u, 0u));
      }
    }
    // the weights: 27 x chunk K rows x BN columns, N-major core matrices
    for (int e = tid; e < 27 * a.chunk * NB8; e += NTHREADS) {
      const int kr = (e & 7) + 8 * ((e >> 3) / NB8);
      const int ng = (e >> 3) % NB8;
      const int tap = kr / a.chunk;
      const int c = c0 + kr - tap * a.chunk;
      const int col = n0 + 8 * ng;
      const bool ok = c < ci && col < a.co;
      const int64_t off = ok ? ((int64_t)tap * ci + c) * a.co + col : 0;
      const uint32_t dst = sw + ((kr >> 3) * NB8 + ng) * 128 + (kr & 7) * 16;
      if (a.wvec) {
        cp_async16_cg(dst, a.w + off, ok);
      } else {
        Pack8 v;
        v.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* wu =
              reinterpret_cast<const unsigned short*>(a.w) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col + j < a.co) v.h[j] = wu[j];
          }
        }
        st_shared16(dst, v.u);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // a segment (mode 0: the 27 taps of every chunk; mode 1, one chunk: a
    // parity class's taps) starts from the first MMA's overwrite (scale-d
    // 0), so the accumulators are defined by MMAs alone
    const bool last = !CHUNKED || c0 + a.chunk >= a.cp;
    for (int cls = 0; cls < (S2 ? 8 : 1); ++cls) {
      const int ntaps = S2 ? class_taps(cls) : 27;
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
      for (int ti = 0; ti < ntaps; ++ti) {
        const int tap = S2 ? tap_of(a, ti, cls) : ti;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        // the halo voxel that output plane 2 wg, row 0, column 0 reads
        const int sz = S2 ? ((cls >> 2) + 1 - kd) >> 1 : kd;
        const int sy = S2 ? (((cls >> 1) & 1) + 1 - kh) >> 1 : kh;
        const int sxx = S2 ? ((cls & 1) + 1 - kw) >> 1 : kw;
        const uint32_t a0 =
            sx + (((2 * wg + sz) * hyn + sy) * hxn + sxx) * 16;
        for (int ks = 0; ks < a.chunk / 16; ++ks) {
          const uint64_t db =
              make_desc(sw + (tap * cgs + 2 * ks) * b_lbo, b_lbo, 128);
          const uint32_t a_k = a0 + 2 * ks * cg_stride;
          const int acc_on = c0 > 0 || ti > 0 || ks > 0;
          Wgmma<BN, 0, 1>::mma(acc0, make_desc(a_k, cg_stride, hxn * 16),
                               db, acc_on);
          Wgmma<BN, 0, 1>::mma(
              acc1, make_desc(a_k + hxn * hyn * 16, cg_stride, hxn * 16),
              db, acc_on);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (!last) continue;

      // epilogue: plane 2 wg + zz, rows 16 w + l / 4 (+ 8) = (y, x) of the
      // plane, columns 8 j + 2 (l % 4) (+ 1); mode 1 writes voxel 2 o + p
#pragma unroll
      for (int zz = 0; zz < 2; ++zz) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = w * 16 + (l >> 2) + 8 * h;
          int z = z0 + 2 * wg + zz, y = y0 + (rr >> 3), x = x0 + (rr & 7);
          if (S2) {
            z = 2 * z + (cls >> 2);
            y = 2 * y + ((cls >> 1) & 1);
            x = 2 * x + (cls & 1);
          }
          if (z >= a.oD || y >= a.oH || x >= a.oW) continue;
          const int64_t vox =
              (((int64_t)b * a.oD + z) * a.oH + y) * a.oW + x;
#pragma unroll
          for (int j = 0; j < NB8; ++j) {
            const int col = n0 + 8 * j + 2 * (l & 3);
            if (col >= a.co) continue;
            const bool two = col + 1 < a.co;
            const float r0 = zz ? acc1[4 * j + 2 * h] : acc0[4 * j + 2 * h];
            const float r1 =
                zz ? acc1[4 * j + 2 * h + 1] : acc0[4 * j + 2 * h + 1];
            const float v0 = activate(r0 + a.bias[col], a.act, a.slope);
            const float v1 =
                two ? activate(r1 + a.bias[col + 1], a.act, a.slope) : 0.f;
            const int64_t off = vox * a.co + col;
            if (a.out_f32) {
              float* dst = static_cast<float*>(a.out) + off;
              if (two && (a.co & 1) == 0) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
                if (two) dst[1] = v1;
              }
            } else {
              __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + off;
              if (two && (a.co & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(v0, v1);
              } else {
                dst[0] = __float2bfloat16(v0);
                if (two) dst[1] = __float2bfloat16(v1);
              }
            }
          }
        }
      }
    }
  }
}

// sums the split-K partials in split order, then bias, activation, store
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     void* out, int64_t n, int co,
                                     int splits, int act, float slope,
                                     int out_f32) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + e];
    const float v = activate(s + bias[e % co], act, slope);
    if (out_f32) {
      static_cast<float*>(out)[e] = v;
    } else {
      static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16(v);
    }
  }
}

template <int BN, int STAGES>
cudaError_t launch(const ConvArgs& a, int m_tiles, int n_tiles, int gz,
                   cudaStream_t stream) {
  const int smem = STAGES * (A_BYTES + BK * BN * 2);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<BN, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  conv_kernel<BN, STAGES><<<dim3(m_tiles, n_tiles, gz), NTHREADS, smem,
                            stream>>>(a);
  return cudaGetLastError();
}

template <int BN, bool S2, bool CHUNKED>
cudaError_t launch_brick_mode(const ConvArgs& a, int m_tiles, int n_tiles,
                              cudaStream_t stream) {
  const int halo =
      S2 ? (BRICK_X + 1) * (BRICK_Y + 1) * (BRICK_Z + 1) : HALO_VOX;
  const int smem = halo * a.chunk * 2 + 27 * a.chunk * BN * 2;
  cudaError_t err = cudaFuncSetAttribute(
      conv_brick_kernel<BN, S2, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_brick_kernel<BN, S2, CHUNKED><<<dim3(m_tiles, n_tiles), NTHREADS,
                                       smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_brick(const ConvArgs& a, int m_tiles, int n_tiles,
                         cudaStream_t stream) {
  // one chunk (the narrow convs, the stride-2 gradient) or several
  if (a.mode == 1) {
    return launch_brick_mode<BN, true, false>(a, m_tiles, n_tiles, stream);
  }
  return a.chunk == a.cp
             ? launch_brick_mode<BN, false, false>(a, m_tiles, n_tiles, stream)
             : launch_brick_mode<BN, false, true>(a, m_tiles, n_tiles, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// mode 0: a stride-1 conv of the (B, D, H, W) grid onto the output grid
// grown by `grow` on each side; mode 1: the stride-2 conv's input gradient
// from the (B, D, H, W) gradient grid onto the (oD, oH, oW) input grid
int conv_launch(const void* enc, const void* small, int f_shift,
                const void* w, const void* bias, void* out, void* ws,
                const int* plan, int B, int D, int H, int W, int c1, int c2,
                int co, int reflect, int act, float slope, int out_f32,
                void* stream, int grow = 0, int mode = 0, int oD = 0,
                int oH = 0, int oW = 0) {
  ConvArgs a;
  a.enc = static_cast<const __nv_bfloat16*>(enc);
  a.small = static_cast<const __nv_bfloat16*>(small);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.D = D;
  a.H = H;
  a.W = W;
  a.mode = mode;
  if (mode == 0) {
    a.oD = D + 2 * grow;
    a.oH = H + 2 * grow;
    a.oW = W + 2 * grow;
    a.gD = a.oD;
    a.gH = a.oH;
    a.gW = a.oW;
  } else {
    a.oD = oD;
    a.oH = oH;
    a.oW = oW;
    a.gD = ceil_div(oD, 2);
    a.gH = ceil_div(oH, 2);
    a.gW = ceil_div(oW, 2);
  }
  a.org = -grow;
  a.c1 = c1;
  a.c2 = c2;
  a.cp = ceil_div(c1 + c2, 8) * 8;
  a.co = co;
  a.f_shift = f_shift;
  const int bn = plan[P_BN];
  a.bx = plan[P_BX];
  a.by = plan[P_BY];
  a.bz = plan[P_BZ];
  const int bb = plan[P_BB];
  a.tiles_x = plan[P_TILES_X];
  a.tiles_y = plan[P_TILES_Y];
  a.tiles_z = plan[P_TILES_Z];
  const int tiles_b = plan[P_TILES_B];
  const int n_tiles = plan[P_N_TILES];
  a.splits = plan[P_SPLITS];
  a.steps_per_split = plan[P_STEPS];
  const int brick = plan[P_BRICK];
  const int stages = plan[P_STAGES];
  a.chunk = plan[P_CHUNK];
  const int cp16 = ceil_div(c1 + c2, 16) * 16;
  // the plan must cover the grid, N and K exactly as the kernel cuts them
  const int steps_all = ceil_div((mode == 1 ? 8 : 27) * a.cp, BK);
  const bool bad_brick =
      brick && (a.bx != 3 || a.by != 3 || a.bz != 2 || bb != 0 ||
                a.splits != 1 || bn > 64 || a.chunk < 16 ||
                a.chunk % 16 != 0 || cp16 % a.chunk != 0 ||
                (mode == 1 && a.chunk != cp16));
  if (bad_brick ||
      (!brick && (a.bx + a.by + a.bz + bb != 7 || a.splits < 1 ||
                  stages != (bn == 128 ? stages : 4) || stages < 3 ||
                  stages > 4 ||
                  (int64_t)a.splits * a.steps_per_split < steps_all)) ||
      a.bx < 0 || a.by < 0 || a.bz < 0 ||
      bb < 0 || (a.tiles_x << a.bx) < a.gW || (a.tiles_y << a.by) < a.gH ||
      (a.tiles_z << a.bz) < a.gD || (tiles_b << bb) < B ||
      n_tiles * bn < co ||
      (mode == 1 && a.splits != 1) || (a.splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.reflect = reflect;
  a.act = act;
  a.out_f32 = out_f32;
  a.slope = slope;
  a.xvec = (c1 % 8 == 0) && (c2 % 8 == 0) && (c1 == 0 || aligned16(enc)) &&
           (c2 == 0 || aligned16(small));
  a.wvec = (co % 8 == 0) && aligned16(w);
  a.fast = a.xvec && (a.cp % 32 == 0) && (c1 % 32 == 0);
  const int m_tiles = a.tiles_x * a.tiles_y * a.tiles_z * tiles_b;
  const int gz = mode == 1 ? 8 : a.splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (brick) {
    a.cp = cp16;  // whole K16 steps per tap
    switch (bn) {
      case 16: return static_cast<int>(launch_brick<16>(a, m_tiles, n_tiles, s));
      case 32: return static_cast<int>(launch_brick<32>(a, m_tiles, n_tiles, s));
      case 64: return static_cast<int>(launch_brick<64>(a, m_tiles, n_tiles, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bn) {
    case 16: err = launch<16, 4>(a, m_tiles, n_tiles, gz, s); break;
    case 32: err = launch<32, 4>(a, m_tiles, n_tiles, gz, s); break;
    case 64: err = launch<64, 4>(a, m_tiles, n_tiles, gz, s); break;
    case 128:
      err = stages == 3 ? launch<128, 3>(a, m_tiles, n_tiles, gz, s)
                        : launch<128, 4>(a, m_tiles, n_tiles, gz, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const int64_t n = (int64_t)B * a.oD * a.oH * a.oW * co;
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      a.ws, a.bias, out, n, co, a.splits, act, slope, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, D, H, W, co) = act(conv(cat(enc, up2x(small))) + bias)
extern "C" int conv3x3x3_upcat_ndhwc(
    const void* enc, const void* small, const void* w, const void* bias,
    void* out, void* ws, const int* plan, int B, int D, int H, int W, int c1,
    int c2, int co, int reflect, int act, float slope, int out_f32,
    void* stream) {
  return conv_launch(enc, small, 1, w, bias, out, ws, plan, B, D, H, W, c1,
                     c2, co, reflect, act, slope, out_f32, stream);
}

// out (B, D, H, W, co) = act(conv(cat(enc, up)) + bias)
extern "C" int conv3x3x3_cat_ndhwc(
    const void* enc, const void* up, const void* w, const void* bias,
    void* out, void* ws, const int* plan, int B, int D, int H, int W, int c1,
    int c2, int co, int reflect, int act, float slope, int out_f32,
    void* stream) {
  return conv_launch(enc, up, 0, w, bias, out, ws, plan, B, D, H, W, c1, c2,
                     co, reflect, act, slope, out_f32, stream);
}

// out (B, D, H, W, co) = act(conv(x) + bias)
extern "C" int conv3x3x3_ndhwc(const void* x, const void* w, const void* bias,
                               void* out, void* ws, const int* plan, int B,
                               int D, int H, int W, int ci, int co,
                               int reflect, int act, float slope, int out_f32,
                               void* stream) {
  return conv_launch(x, nullptr, 0, w, bias, out, ws, plan, B, D, H, W, ci,
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
                                     void* dx, void* ws, const int* plan,
                                     int B, int D, int H, int W, int co,
                                     int ci, int reflect, void* stream) {
  if (!reflect) {
    return conv_launch(dy, nullptr, 0, w_t, zero_bias, dx, ws, plan, B, D, H,
                       W, co, 0, ci, 0, 0, 0.f, 0, stream);
  }
  int rc = conv_launch(dy, nullptr, 0, w_t, zero_bias, g_ext, ws, plan, B, D,
                       H, W, co, 0, ci, 0, 0, 0.f, 1, stream, /*grow=*/1);
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

// dx (B, D, H, W, ci) bf16 of the stride-2 pad-1 conv from its output
// gradient dy (B, d, h, w, co), d = (D + 1) / 2, and the transposed packed
// weights w_t (27 * co, ci), row tap * co + c (taps not flipped); zero_bias
// is (ci,) f32 zeros
extern "C" int conv3x3x3_dgrad_s2_ndhwc(const void* dy, const void* w_t,
                                        const void* zero_bias, void* dx,
                                        const int* plan, int B, int d, int h,
                                        int w, int D, int H, int W, int co,
                                        int ci, void* stream) {
  return conv_launch(dy, nullptr, 0, w_t, zero_bias, dx, nullptr, plan, B, d,
                     h, w, co, 0, ci, 0, 0, 0.f, 0, stream, 0, /*mode=*/1, D,
                     H, W);
}
