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
//       halo built in the kernel, then the caller's pad adjoint: here the
//       split store and the shell pass, below)
//   V2  anatomix_tpu/ops/pallas/conv_down.py   conv_down2_block
//       (the ViT tokenizer's stride-2 convs, zero padding 1; the TPU kernel
//       reads the space-to-depth block tensor, whose block grid is the
//       output grid; this one reads channels-last directly)
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
// The ViT tokenizer's stride-2 convs (V2, on the three-term split at 3 Ci)
// are bound by bytes at the first stage (B2 128^3 x 96 -> 64^3 x 64: 0.8
// GB of input for 0.2 TFLOP) and by operations at the two deeper ones.
//
// Four designs share the entry points; `kernels/conv.py` `conv_plan`, a
// pure function of the shapes, picks one per launch and passes its tiling.
//
// 1. The halo brick (`conv_brick_kernel`), for N tiles up to 64 where the
//    output grid has enough 8 x 8 x 4 tiles (every full-resolution conv of
//    the 6M, dev and ViT paths). The tile's 10 x 10 x 6 input halo comes in
//    by cp.async through the padding's index map (`pad_index`, a mode per
//    axis: reflect -1 -> 1, n -> n-2; replicate clamps; circular wraps; or
//    zeros by src-size 0; channels [c1, c1+c2) from the second
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
// 3. The stride-2 conv (mode 2; V2). Output voxel o, tap k reads input
//    2 o - 1 + k, zeros outside the volume (odd extents give (n - 1) / 2 + 1
//    outputs). The gather ring runs it through that index map, with N
//    tiles of 128 and split K where its tiles leave SMs idle (the 64^3 ->
//    32^3 and 32^3 -> 16^3 stages). The first stage, bound by bytes, runs a
//    halo brick whose 17 x 17 x 9 halo is stored split by parity into 8
//    class bricks written straight from device memory by the cp.async index
//    map: a gather would read each input voxel 27 / 8 = 3.4x, the brick
//    about 1.3x. A core matrix needs 8 contiguous 16-byte rows, so a
//    descriptor cannot step 2 voxels; in a class brick each tap is a shift
//    of 0 or 1 voxel per axis, a plain descriptor move as in design 1.
//    Chunks of 8 channels (the halo 41 KB) pair two taps in each K16 step,
//    through two buffers, the next chunk loading while this one's MMAs run
//    (`conv_down_brick_kernel`).
// 4. The stride-2 conv's input gradient, below.
// Every accumulator is first written by an MMA (scale-d 0), so no other
// instruction defines it and ptxas keeps the MMAs asynchronous.
//
// The input gradient of a "same" conv (`conv3x3x3_dgrad_ndhwc`) is this
// kernel run as the transposed conv: flipped, transposed weights (packed by
// the caller, 27 * Co x Ci), zero padding, over the output grid grown by 1
// on each side (origin -1), so it reads the unpadded dy and treats the halo
// of 2 as zeros by index. For zero padding only the interior is computed,
// straight into dx. For the other paddings the (S+2)^3 f32 result g has to
// be folded, dx[i] = g[i+1] (+ g[0] if i == lo) (+ g[S+1] if i == hi) on
// each axis, the exact adjoint of torch's pad (replaces the XLA VJP of the
// pad that the JAX package's caller takes, conv_block_train.py:678): reflect
// lo 1, hi S-2; replicate lo 0, hi S-1; circular lo S-1, hi 0 (a zeros axis
// of a mixed padding, a lifted 1-D or 2-D net's, adds no face). The text
// below counts reflect's shell; the others' is the same size.
// What bounds the fold is bytes: stored whole in f32 and read back whole,
// g is 4.2x the bf16 dx at 128^3 x 16 (281 MB at B2), though only the shell
// (dx voxels with some axis index in {1, S-2}, 4.6 % of them at 128^3) sums
// more than one g voxel. So the store is split (FOLD, a template flag of
// the brick, ring and split-K reduce epilogues; `out_voxel`): an extended
// voxel with no axis coordinate in {0, 2, S-1, S+1} feeds exactly one dx
// voxel, and only that one, so the epilogue rounds it straight into
// dx[e - 1] in bf16 (the same one rounding of the same f32 value as a
// full-grid fold); only the shell's sources (9 % of g at 128^3) go to the
// f32 scratch g_ext. The scratch keeps g's full (S+2)^3 extent, written
// sparsely: the caching allocator hands it out without a copy, the
// epilogues and the shell pass index it as they index g, and a compact
// face buffer would save only address space. Then `pad_shell_kernel`
// visits the shell alone: 32-bit items over (voxel, 8 channels) and the
// batch on the grid's y, two 16-byte f32 loads per source (each shell
// source is read by exactly one thread), the 2-8 sources summed in the
// plain adjoint's order (z innermost, then y, then x), one 16-byte bf16
// store, no atomics: every dx voxel is written once, by one kernel, the
// same bits every run. Widths that are not a multiple of 8 take one
// channel a thread.
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
#include "pad.cuh"

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
  __nv_bfloat16* dx;           // the padded dgrad's split store (FOLD):
                               // (B, D, H, W, co), or null
  float* ws;                   // (splits, B * oD * oH * oW, co) or null
  int B, D, H, W;              // the gathered grid
  int oD, oH, oW, org;         // the output grid; mode 0 reads o + org
  int dvalid;                  // mode 0, D-valid: z reads o + 1 + org (the
                               // input carries its two D-halo planes)
  int gD, gH, gW;              // the tiled grid (mode 1: a class's)
  int c1, c2, cp, co;          // cp: c1 + c2 padded to 8 (brick: 16)
  int f_shift, mode;           // mode 0: stride 1; 1: stride-2 dgrad;
                               // 2: stride-2 forward (zero padding 1)
  int bx, by, bz;              // log2 of the tile's x, y, z extents
  int tiles_x, tiles_y, tiles_z;
  int splits, steps_per_split;
  int pad;                     // 2 bits an axis (D, H, W from bit 0): 0
                               // zeros, 1 reflect, 2 replicate, 3 circular
  int fold_pad;                // FOLD: the padding whose adjoint is stored
  int act, out_f32;
  int xvec, wvec, fast;        // 16-byte loads; one tap per 32 channels
  int chunk;                   // halo-brick mode: channels a K chunk
  float slope;
};


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

union Pack8 {  // eight bf16 values as raw 16-bit patterns
  uint4 u;
  unsigned short h[8];
};

// (v0, v1) into columns col, col + 1 (v1 only if `two`) at element `off` of
// an output of co columns, f32 or bf16
__device__ __forceinline__ void store_pair(void* out, int out_f32, int co,
                                           int64_t off, float v0, float v1,
                                           bool two) {
  if (out_f32) {
    float* dst = static_cast<float*>(out) + off;
    if (two && (co & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = v0;
      if (two) dst[1] = v1;
    }
  } else {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + off;
    if (two && (co & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    } else {
      dst[0] = __float2bfloat16(v0);
      if (two) dst[1] = __float2bfloat16(v1);
    }
  }
}

// whether coordinate e of an extended-grid axis of n = S + 2 under pad mode
// m is a shell source: a halo face (0 or S + 1, which a zeros axis drops),
// or e - 1 a dx index that a face is added onto (reflect {1, S - 2},
// replicate and circular {0, S - 1})
__device__ __forceinline__ bool shell_coord(int e, int n, int m) {
  if (e == 0 || e == n - 1) return true;
  if (m == 1) return e == 2 || e == n - 3;
  return m != 0 && (e == 1 || e == n - 2);
}

// where output voxel (b, z, y, x) is stored: element vox * co of `out`, as
// the launch says; or, in the padded dgrad's split store (FOLD), when no
// axis coordinate of the extended-grid voxel is a shell source, straight
// into dx[z - 1, y - 1, x - 1] in bf16, the only dx voxel it reaches
struct Dst {
  void* p;
  int64_t vox;
  int f32;
};

template <bool FOLD>
__device__ __forceinline__ Dst out_voxel(const ConvArgs& a, int b, int z,
                                         int y, int x) {
  Dst d{a.out, (((int64_t)b * a.oD + z) * a.oH + y) * a.oW + x, a.out_f32};
  if (FOLD && !(a.fold_pad == PAD_REFLECT3
                    ? shell_coord(z, a.oD, 1) || shell_coord(y, a.oH, 1) ||
                          shell_coord(x, a.oW, 1)
                    : shell_coord(z, a.oD, a.fold_pad & 3) ||
                          shell_coord(y, a.oH, (a.fold_pad >> 2) & 3) ||
                          shell_coord(x, a.oW, (a.fold_pad >> 4) & 3))) {
    d.p = a.dx;
    d.f32 = 0;
    d.vox = (((int64_t)b * a.D + z - 1) * a.H + y - 1) * a.W + x - 1;
  }
  return d;
}

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
// an even coordinate takes tap 1, an odd one taps 0 and 2 (DOWN: mode 2)
template <bool DOWN>
__device__ __forceinline__ int tap_of(const ConvArgs& a, int ti, int cls) {
  if (DOWN || a.mode == 0) return ti;
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
// the gradient at (o + 1 - k) / 2, where that is whole and in range; mode
// 2 (the stride-2 conv; DOWN, a separate instantiation so that the other
// modes compile without it) reads 2 o - 1 + k, zeros outside the volume
template <bool DOWN, bool GP>
__device__ __forceinline__ void source_voxel(const ConvArgs& a,
                                             const Voxel& o, int tap,
                                             int& iz, int& iy, int& ix,
                                             bool& ok) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  if (DOWN) {
    iz = 2 * o.z - 1 + kd;
    iy = 2 * o.y - 1 + kh;
    ix = 2 * o.x - 1 + kw;
    ok = ok && iz >= 0 && iz < a.D && iy >= 0 && iy < a.H && ix >= 0 &&
         ix < a.W;
    return;
  }
  if (a.mode == 1) {
    const int tz = o.z + 1 - kd, ty = o.y + 1 - kh, tx = o.x + 1 - kw;
    iz = tz >> 1;
    iy = ty >> 1;
    ix = tx >> 1;
    ok = ok && tz >= 0 && ty >= 0 && tx >= 0 && iz < a.D && iy < a.H &&
         ix < a.W;
    return;
  }
  iz = o.z + kd - 1 + a.org + a.dvalid;
  iy = o.y + kh - 1 + a.org;
  ix = o.x + kw - 1 + a.org;
  pad_voxel<GP>(a.pad, a.D, a.H, a.W, iz, iy, ix, ok);
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

// STAGES: the ring's depth; loads run STAGES - 2 steps ahead; DOWN: mode 2;
// FOLD: the padded dgrad's split store (`out_voxel`); GP: per-axis pad modes
template <int BN, int STAGES, bool DOWN, bool FOLD, bool GP>
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
      source_voxel<DOWN, GP>(a, row, tap_of<DOWN>(a, ti, cls), iz, iy, ix,
                             ok);
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
        if (ok) {
          source_voxel<DOWN, GP>(a, row, tap_of<DOWN>(a, ti, cls), iz, iy,
                                 ix, ok);
        }
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
          ok ? ((int64_t)tap_of<DOWN>(a, ti, cls) * ci + c) * a.co + col : 0;
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
    const Dst d = out_voxel<FOLD>(a, o.b, o.z, o.y, o.x);
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
      store_pair(d.p, d.f32, a.co, d.vox * a.co + col, u0, u1, two);
    }
  }
}

// the halo bricks' epilogue: planes 2 wg and 2 wg + 1 of the 8 x 8 x 4
// output tile at (z0, y0, x0) of batch item b, rows 16 w + l / 4 (+ 8) =
// (y, x) of a plane, columns 8 j + 2 (l % 4) (+ 1) from n0: bias,
// activation, store (`out_voxel`); S2 (mode 1) writes voxel 2 o + p of
// parity class cls
template <int BN, bool S2, bool FOLD>
__device__ __forceinline__ void store_tile(const ConvArgs& a,
                                           const float (&acc0)[BN / 2],
                                           const float (&acc1)[BN / 2],
                                           int b, int z0, int y0, int x0,
                                           int n0, int cls) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
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
      const Dst d = out_voxel<FOLD>(a, b, z, y, x);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (l & 3);
        if (col >= a.co) continue;
        const bool two = col + 1 < a.co;
        const float r0 = zz ? acc1[4 * j + 2 * h] : acc0[4 * j + 2 * h];
        const float r1 =
            zz ? acc1[4 * j + 2 * h + 1] : acc0[4 * j + 2 * h + 1];
        const float v0 = activate(r0 + a.bias[col], a.act, a.slope);
        const float v1 =
            two ? activate(r1 + a.bias[col + 1], a.act, a.slope) : 0.f;
        store_pair(d.p, d.f32, a.co, d.vox * a.co + col, v0, v1, two);
      }
    }
  }
}

// The halo brick (design 1 above); mode 1 (S2) is the stride-2 input
// gradient; FOLD the padded dgrad's split store; GP per-axis pad modes.
// Registers are capped so that as many blocks as the shared memory admits
// fit on an SM: 4 at N 16, 3 at 32, 2 at 64.
template <int BN, bool S2, bool CHUNKED, bool FOLD, bool GP>
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
      int iz = z0 + hz - lo + a.dvalid, iy = y0 + hy - lo,
          ix = x0 + hx - lo;
      const int c = c0 + cg * 8;
      bool ok = c < ci;
      pad_voxel<GP>(a.pad, a.D, a.H, a.W, iz, iy, ix, ok);
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
        const int tap = S2 ? tap_of<false>(a, ti, cls) : ti;
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
      if (!last || FOLD) continue;
      store_tile<BN, S2, false>(a, acc0, acc1, b, z0, y0, x0, n0, cls);
    }
  }
  // the split store's epilogue runs after the chunk loop, so that nothing
  // it computes is held across the MMAs, where the bricks sit at their
  // register caps
  if constexpr (FOLD) {
    store_tile<BN, false, true>(a, acc0, acc1, b, z0, y0, x0, n0, 0);
  }
}

// The stride-2 conv's halo brick (design 3 above, mode 2). An 8 x 8 x 4
// output tile reads a 17 x 17 x 9 input halo, stored split by parity into
// 8 class bricks: along each axis, class 0 holds the halo's even indices
// (input 2 o - 1, the taps 0 and 2; 9 or 5 voxels) and class 1 its odd
// ones (input 2 o, tap 1; 8 or 4), so tap (kd, kh, kw) of an output plane
// reads class (kd == 1, kh == 1, kw == 1) shifted by (kd == 2, kh == 2,
// kw == 2) voxels: a plain descriptor move whose 8-row groups are the
// class's x-rows. K walks channel chunks of 8 (one 16-byte voxel); each
// K16 step pairs two taps of one class whose shifts differ on one axis, the
// descriptor's leading byte offset the distance between them (1 voxel in
// x, a class row in y, a class plane in z), and the centre tap pairs with
// zero weights: 14 steps for 27 taps.
constexpr int S2F_CHUNK = 8;
constexpr int S2F_VOX =
    (2 * BRICK_X + 1) * (2 * BRICK_Y + 1) * (2 * BRICK_Z + 1);  // 2601
constexpr int S2F_STEPS = 14;

// extent of parity class p along an axis of n outputs: n + 1 (p 0), n
__device__ __forceinline__ int s2f_ext(int n, int p) { return n + 1 - p; }

// the first halo voxel of class cls (bits pz py px); classes lie in order
__device__ __forceinline__ int s2f_base(int cls) {
  int base = 0;
  for (int c = 0; c < cls; ++c) {
    base += s2f_ext(BRICK_Z, c >> 2) * s2f_ext(BRICK_Y, (c >> 1) & 1) *
            s2f_ext(BRICK_X, c & 1);
  }
  return base;
}

// the halo voxel that output plane zl, row 0, column 0 reads through tap
__device__ __forceinline__ int s2f_tap_voxel(int tap, int zl) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int py = kh == 1, px = kw == 1;
  const int ey = s2f_ext(BRICK_Y, py), ex = s2f_ext(BRICK_X, px);
  return s2f_base((kd == 1) * 4 + py * 2 + px) +
         ((zl + (kd == 2)) * ey + (kh == 2)) * ex + (kw == 2);
}

// K16 step s: its first tap, its second (-1: zero weights) and the halo
// voxels from the first to the second
__device__ __forceinline__ void s2f_step(int s, int& ta, int& tb,
                                         int& lead) {
  if (s < 9) {  // (kd, kh, 0) and (kd, kh, 2): one voxel along x
    ta = 3 * s;
    tb = ta + 2;
    lead = 1;
  } else if (s < 12) {  // (kd, 0, 1) and (kd, 2, 1): a row of 8
    ta = 9 * (s - 9) + 1;
    tb = ta + 6;
    lead = s2f_ext(BRICK_X, 1);
  } else if (s == 12) {  // (0, 1, 1) and (2, 1, 1): a plane of 8 x 8
    ta = 4;
    tb = 22;
    lead = s2f_ext(BRICK_X, 1) * s2f_ext(BRICK_Y, 1);
  } else {  // (1, 1, 1)
    ta = 13;
    tb = -1;
    lead = 0;
  }
}

// One block per SM: two chunk buffers (the next chunk's halo and weights
// load while this chunk's MMAs run) and the halo's source map.
template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_down_brick_kernel(const ConvArgs a) {
  constexpr int NB8 = BN / 8;
  constexpr int SLOTS = (S2F_VOX + NTHREADS - 1) / NTHREADS;
  constexpr int STAGE = S2F_VOX * 16 + S2F_STEPS * 16 * BN * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);  // buffer i: halo, then weights
  // then each halo voxel's input voxel, -1 for a zero, the same for every
  // chunk; only the thread that loads a voxel reads its entry
  int* src = reinterpret_cast<int*>(smem + 2 * STAGE);
  const uint32_t b_lbo = NB8 * 128;
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * BRICK_X;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * BRICK_Y;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * BRICK_Z;
  const int b = t / a.tiles_z;
  const int n0 = blockIdx.y * BN;
  const int ci = a.c1;
  const int wg = tid >> 7;

  for (int i = 0; i < SLOTS; ++i) {
    const int e = tid + i * NTHREADS;
    if (e >= S2F_VOX) continue;
    int cls = 0, base = 0;
#pragma unroll
    for (int c = 1; c < 8; ++c) {
      if (e >= s2f_base(c)) {
        cls = c;
        base = s2f_base(c);
      }
    }
    const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
    const int ex = s2f_ext(BRICK_X, px), ey = s2f_ext(BRICK_Y, py);
    const int v = e - base;
    const int ix = 2 * (x0 + v % ex) + px - 1;
    const int iy = 2 * (y0 + (v / ex) % ey) + py - 1;
    const int iz = 2 * (z0 + v / (ex * ey)) + pz - 1;
    const bool in =
        ix >= 0 && ix < a.W && iy >= 0 && iy < a.H && iz >= 0 && iz < a.D;
    src[e] = in ? ((b * a.D + iz) * a.H + iy) * a.W + ix : -1;
  }

  // chunk [c0, c0 + 8) into buffer `buf`: the halo voxels, then the
  // weights, K row 16 s + 8 half + c the channel c0 + c of step s's first
  // (half 0) or second tap, N-major core matrices
  auto load_chunk = [&](int c0, int buf) {
    const uint32_t sx = s0 + buf * STAGE, sw = sx + S2F_VOX * 16;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int e = tid + i * NTHREADS;
      if (e >= S2F_VOX) continue;
      const int vi = src[e];
      const bool ok = vi >= 0;
      const __nv_bfloat16* p = a.enc + (int64_t)max(vi, 0) * ci + c0;
      // read once per block: streamed through L2 only
      if (a.xvec) {
        cp_async16_cg(sx + e * 16, ok ? p : a.w, ok);
      } else {
        Pack8 v;
        v.u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const unsigned short* pu = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c0 + j < ci) v.h[j] = pu[j];
          }
        }
        st_shared16(sx + e * 16, v.u);
      }
    }
    for (int e = tid; e < S2F_STEPS * 16 * NB8; e += NTHREADS) {
      const int kr = (e & 7) + 8 * ((e >> 3) / NB8);
      const int ng = (e >> 3) % NB8;
      int ta, tb, lead;
      s2f_step(kr >> 4, ta, tb, lead);
      const int tap = (kr >> 3) & 1 ? tb : ta;
      const int c = c0 + (kr & 7);
      const int col = n0 + 8 * ng;
      const bool ok = tap >= 0 && c < ci && col < a.co;
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
  };

  load_chunk(0, 0);
  cp_async_commit();
  float acc0[BN / 2], acc1[BN / 2];
  for (int c0 = 0, buf = 0; c0 < a.cp; c0 += S2F_CHUNK, buf ^= 1) {
    // every warpgroup's MMAs of the last chunk are done: its buffer is free
    __syncthreads();
    if (c0 + S2F_CHUNK < a.cp) load_chunk(c0 + S2F_CHUNK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies have landed
    fence_proxy_async();
    __syncthreads();

    // the first chunk's first MMA overwrites the accumulators (scale-d 0)
    const uint32_t sx = s0 + buf * STAGE, sw = sx + S2F_VOX * 16;
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < S2F_STEPS; ++st) {
      int ta, tb, lead;
      s2f_step(st, ta, tb, lead);
      // A K-major: 8-row groups one class x-row apart, K halves `lead`
      // voxels; B N-major: 8-column groups 128 bytes apart, K groups b_lbo
      const uint32_t sbo = s2f_ext(BRICK_X, ta % 3 == 1) * 16;
      const uint64_t db = make_desc(sw + 2 * st * b_lbo, b_lbo, 128);
      const int acc_on = c0 > 0 || st > 0;
      Wgmma<BN, 0, 1>::mma(
          acc0, make_desc(sx + s2f_tap_voxel(ta, 2 * wg) * 16, lead * 16, sbo),
          db, acc_on);
      Wgmma<BN, 0, 1>::mma(
          acc1,
          make_desc(sx + s2f_tap_voxel(ta, 2 * wg + 1) * 16, lead * 16, sbo),
          db, acc_on);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
  }
  cp_async_wait<0>();
  store_tile<BN, false, false>(a, acc0, acc1, b, z0, y0, x0, n0, 0);
}

// sums the split-K partials in split order, then bias, activation, store
// (FOLD: the padded dgrad's split store, `out_voxel`; n < 2^31 there, so
// the voxel is decoded in 32 bits)
template <bool FOLD>
__global__ void splitk_reduce_kernel(const ConvArgs a, int64_t n) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += a.ws[k * n + e];
    if (FOLD) {
      const int vox = (int)e / a.co, c = (int)e - vox * a.co;
      const int x = vox % a.oW, zy = vox / a.oW;
      const int y = zy % a.oH, bz = zy / a.oH;
      const Dst d = out_voxel<true>(a, bz / a.oD, bz % a.oD, y, x);
      store_pair(d.p, d.f32, a.co, d.vox * a.co + c,
                 activate(s + a.bias[c], a.act, a.slope), 0.f, false);
    } else {
      store_pair(a.out, a.out_f32, a.co, e,
                 activate(s + a.bias[e % a.co], a.act, a.slope), 0.f, false);
    }
  }
}

template <int BN, int STAGES, bool DOWN, bool FOLD, bool GP = false>
cudaError_t launch_ring(const ConvArgs& a, int m_tiles, int n_tiles, int gz,
                        cudaStream_t stream) {
  const int smem = STAGES * (A_BYTES + BK * BN * 2);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<BN, STAGES, DOWN, FOLD, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_kernel<BN, STAGES, DOWN, FOLD, GP><<<dim3(m_tiles, n_tiles, gz),
                                            NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the gradients read with zero padding (dy, the stride-2 modes) and take
// the default instantiation; a forward conv under another padding than
// reflect or zeros on every axis takes the per-axis decode
template <int BN, int STAGES>
cudaError_t launch(const ConvArgs& a, int m_tiles, int n_tiles, int gz,
                   cudaStream_t stream) {
  if (a.mode == 2) {
    return launch_ring<BN, STAGES, true, false>(a, m_tiles, n_tiles, gz,
                                                stream);
  }
  if (a.dx) {
    return launch_ring<BN, STAGES, false, true>(a, m_tiles, n_tiles, gz,
                                                stream);
  }
  return generic_pad(a.pad)
             ? launch_ring<BN, STAGES, false, false, true>(a, m_tiles,
                                                           n_tiles, gz, stream)
             : launch_ring<BN, STAGES, false, false>(a, m_tiles, n_tiles, gz,
                                                     stream);
}

template <int BN, bool S2, bool CHUNKED, bool FOLD, bool GP = false>
cudaError_t launch_brick_mode(const ConvArgs& a, int m_tiles, int n_tiles,
                              cudaStream_t stream) {
  const int halo =
      S2 ? (BRICK_X + 1) * (BRICK_Y + 1) * (BRICK_Z + 1) : HALO_VOX;
  const int smem = halo * a.chunk * 2 + 27 * a.chunk * BN * 2;
  cudaError_t err = cudaFuncSetAttribute(
      conv_brick_kernel<BN, S2, CHUNKED, FOLD, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_brick_kernel<BN, S2, CHUNKED, FOLD, GP><<<dim3(m_tiles, n_tiles),
                                                 NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_down_brick(const ConvArgs& a, int m_tiles, int n_tiles,
                              cudaStream_t stream) {
  const int smem =
      2 * (S2F_VOX * 16 + S2F_STEPS * 16 * BN * 2) + S2F_VOX * 4;
  cudaError_t err = cudaFuncSetAttribute(
      conv_down_brick_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_down_brick_kernel<BN><<<dim3(m_tiles, n_tiles), NTHREADS, smem,
                               stream>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_brick(const ConvArgs& a, int m_tiles, int n_tiles,
                         cudaStream_t stream) {
  if (a.mode == 2) return launch_down_brick<BN>(a, m_tiles, n_tiles, stream);
  // one chunk (the narrow convs, the stride-2 gradient) or several
  if (a.mode == 1) {
    return launch_brick_mode<BN, true, false, false>(a, m_tiles, n_tiles,
                                                     stream);
  }
  const bool one = a.chunk == a.cp;
  if (a.dx) {
    return one ? launch_brick_mode<BN, false, false, true>(a, m_tiles,
                                                           n_tiles, stream)
               : launch_brick_mode<BN, false, true, true>(a, m_tiles,
                                                          n_tiles, stream);
  }
  if (generic_pad(a.pad)) {
    return one ? launch_brick_mode<BN, false, false, false, true>(
                     a, m_tiles, n_tiles, stream)
               : launch_brick_mode<BN, false, true, false, true>(
                     a, m_tiles, n_tiles, stream);
  }
  return one ? launch_brick_mode<BN, false, false, false>(a, m_tiles, n_tiles,
                                                          stream)
             : launch_brick_mode<BN, false, true, false>(a, m_tiles, n_tiles,
                                                         stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// mode 0: a stride-1 conv of the (B, D, H, W) grid onto the output grid
// grown by `grow` on each side; mode 1: the stride-2 conv's input gradient
// from the (B, D, H, W) gradient grid onto the (oD, oH, oW) input grid;
// mode 2: the stride-2 conv of the (B, D, H, W) grid, zero padding 1.
// fold_dx: the padded dgrad's split store of the adjoint of `fold_pad`
// (mode 0, grow 1, f32 `out` g_ext, no bias or activation), the shell
// sources into `out`, the rest straight into fold_dx. dvalid (mode 0, one operand, grow 0): D-valid, the
// input's D planes 0 and D - 1 are the halo the caller brought (a spatial
// shard's neighbours), so the output has D - 2 planes and only H and W are
// padded; z reads o + k, never through the padding's index map
int conv_launch(const void* enc, const void* small, int f_shift,
                const void* w, const void* bias, void* out, void* ws,
                const int* plan, int B, int D, int H, int W, int c1, int c2,
                int co, int pad, int act, float slope, int out_f32,
                void* stream, int grow = 0, int mode = 0, int oD = 0,
                int oH = 0, int oW = 0, void* fold_dx = nullptr,
                int dvalid = 0, int fold_pad = 0) {
  ConvArgs a;
  a.enc = static_cast<const __nv_bfloat16*>(enc);
  a.small = static_cast<const __nv_bfloat16*>(small);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.dx = static_cast<__nv_bfloat16*>(fold_dx);
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.D = D;
  a.H = H;
  a.W = W;
  a.mode = mode;
  a.dvalid = dvalid;
  if (mode == 0 || mode == 2) {
    a.oD = mode == 2 ? (D - 1) / 2 + 1 : D + 2 * grow - 2 * dvalid;
    a.oH = mode == 2 ? (H - 1) / 2 + 1 : H + 2 * grow;
    a.oW = mode == 2 ? (W - 1) / 2 + 1 : W + 2 * grow;
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
  const bool bad_chunk =
      mode == 2 ? a.chunk != S2F_CHUNK
                : (a.chunk < 16 || a.chunk % 16 != 0 || cp16 % a.chunk != 0 ||
                   (mode == 1 && a.chunk != cp16));
  const bool bad_brick =
      brick && (a.bx != 3 || a.by != 3 || a.bz != 2 || bb != 0 ||
                a.splits != 1 || bn > 64 || bad_chunk);
  if (bad_brick ||
      (!brick && (a.bx + a.by + a.bz + bb != 7 || a.splits < 1 ||
                  stages != (bn == 128 ? stages : 4) || stages < 3 ||
                  stages > 4 ||
                  (int64_t)a.splits * a.steps_per_split < steps_all)) ||
      a.bx < 0 || a.by < 0 || a.bz < 0 ||
      bb < 0 || (a.tiles_x << a.bx) < a.gW || (a.tiles_y << a.by) < a.gH ||
      (a.tiles_z << a.bz) < a.gD || (tiles_b << bb) < B ||
      n_tiles * bn < co ||
      (mode == 1 && a.splits != 1) || (a.splits > 1 && ws == nullptr) ||
      pad < 0 || pad > 63 || fold_pad < 0 || fold_pad > 63 ||
      (mode == 2 && (c2 != 0 || pad)) ||
      (dvalid && (dvalid != 1 || mode != 0 || grow != 0 || c2 != 0 ||
                  fold_dx || a.oD < 1)) ||
      (fold_dx && (mode != 0 || grow != 1 || !out_f32 || act != 0 ||
                   pad != 0 || fold_pad == 0 ||
                   (a.splits > 1 &&
                    (int64_t)B * a.oD * a.oH * a.oW * co >= INT32_MAX)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.pad = pad;
  a.fold_pad = fold_pad;
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
    if (mode != 2) a.cp = cp16;  // whole K16 steps per tap
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
  if (a.dx) {
    splitk_reduce_kernel<true><<<(unsigned)blocks, 256, 0, s>>>(a, n);
  } else {
    splitk_reduce_kernel<false><<<(unsigned)blocks, 256, 0, s>>>(a, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, D, H, W, co) = act(conv(cat(enc, up2x(small))) + bias)
extern "C" int conv3x3x3_upcat_ndhwc(
    const void* enc, const void* small, const void* w, const void* bias,
    void* out, void* ws, const int* plan, int B, int D, int H, int W, int c1,
    int c2, int co, int pad, int act, float slope, int out_f32,
    void* stream) {
  return conv_launch(enc, small, 1, w, bias, out, ws, plan, B, D, H, W, c1,
                     c2, co, pad, act, slope, out_f32, stream);
}

// out (B, D, H, W, co) = act(conv(cat(enc, up)) + bias)
extern "C" int conv3x3x3_cat_ndhwc(
    const void* enc, const void* up, const void* w, const void* bias,
    void* out, void* ws, const int* plan, int B, int D, int H, int W, int c1,
    int c2, int co, int pad, int act, float slope, int out_f32,
    void* stream) {
  return conv_launch(enc, up, 0, w, bias, out, ws, plan, B, D, H, W, c1, c2,
                     co, pad, act, slope, out_f32, stream);
}

// out (B, D, H, W, co) = act(conv(x) + bias)
extern "C" int conv3x3x3_ndhwc(const void* x, const void* w, const void* bias,
                               void* out, void* ws, const int* plan, int B,
                               int D, int H, int W, int ci, int co,
                               int pad, int act, float slope, int out_f32,
                               void* stream) {
  return conv_launch(x, nullptr, 0, w, bias, out, ws, plan, B, D, H, W, ci,
                     0, co, pad, act, slope, out_f32, stream);
}

// out (B, D - 2, H, W, co) = act(conv(x) + bias), D-valid: x (B, D, H, W,
// ci) holds its two D-halo planes, H and W are padded by `pad`
extern "C" int conv3x3x3_dvalid_ndhwc(const void* x, const void* w,
                                      const void* bias, void* out, void* ws,
                                      const int* plan, int B, int D, int H,
                                      int W, int ci, int co, int pad,
                                      int act, float slope, int out_f32,
                                      void* stream) {
  return conv_launch(x, nullptr, 0, w, bias, out, ws, plan, B, D, H, W, ci,
                     0, co, pad, act, slope, out_f32, stream, 0, 0, 0, 0,
                     0, nullptr, 1);
}

namespace {

// the dx indices that the halo faces 0 and n + 1 of an n-extent axis land
// on under pad mode m (1 reflect: 1, n - 2; 2 replicate: 0, n - 1; 3
// circular: n - 1, 0)
__device__ __forceinline__ int face_lo(int n, int m) {
  return m == 1 ? 1 : m == 2 ? 0 : n - 1;
}

__device__ __forceinline__ int face_hi(int n, int m) {
  return m == 1 ? n - 2 : m == 2 ? n - 1 : 0;
}

// the extended-grid indices whose gradient lands on voxel i of an n-extent
// axis under pad mode m, in the order the plain adjoint adds them: the
// interior i + 1, then face 0 if it lands on i, then face n + 1 if it does
// (a zeros axis adds none)
__device__ __forceinline__ int pad_sources(int i, int n, int m,
                                           int (&s)[3]) {
  s[0] = i + 1;
  int k = 1;
  if (m != 0 && i == face_lo(n, m)) s[k++] = 0;
  if (m != 0 && i == face_hi(n, m)) s[k++] = n + 1;
  return k;
}

// the shell indices of an n-extent axis under pad mode m (where a face
// lands), sorted, and their count (1 where they coincide, 0 for zeros)
struct AxisShell {
  int lo, hi, n;
};

__device__ __forceinline__ AxisShell axis_shell(int n, int m) {
  AxisShell s;
  s.lo = min(face_lo(n, m), face_hi(n, m));
  s.hi = max(face_lo(n, m), face_hi(n, m));
  s.n = m == 0 ? 0 : s.lo == s.hi ? 1 : 2;
  return s;
}

// the k-th index of the axis outside its shell
__device__ __forceinline__ int off_shell(int k, const AxisShell& s) {
  if (s.n >= 1 && k >= s.lo) ++k;
  if (s.n == 2 && k >= s.hi) ++k;
  return k;
}

// The padded dgrad's shell pass (design above). Thread `item` of batch
// item blockIdx.y owns V channels [c, c + V) of one shell voxel. The
// shell's voxels in order: the (z, y) rows that lie in it whole (z in the
// z shell: sz.n * H rows; else y in the y shell: (D - sz.n) * sy.n rows),
// x fastest; then the x shell's voxels of the other rows. Each sums its
// 1-3 sources per axis from g_ext in the plain adjoint's order (z
// innermost, then y, then x), so the f32 sum is the plain version's bits,
// and rounds once to bf16.
template <int V>
__global__ void __launch_bounds__(256)
pad_shell_kernel(const float* __restrict__ g,
                 __nv_bfloat16* __restrict__ dx, int D, int H, int W, int C,
                 int pad, int items) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= items) return;
  const int b = blockIdx.y;
  const int groups = C / V;
  const int v = item / groups;
  const int c = (item - v * groups) * V;
  const int mz = pad & 3, my = (pad >> 2) & 3, mx = (pad >> 4) & 3;
  const AxisShell sz = axis_shell(D, mz), sy = axis_shell(H, my),
                  sx = axis_shell(W, mx);
  const int rows = sz.n * H + (D - sz.n) * sy.n;
  int z, y, x;
  if (v < rows * W) {
    const int r = v / W;
    x = v - r * W;
    if (r < sz.n * H) {
      const int k = r / H;
      y = r - k * H;
      z = k ? sz.hi : sz.lo;
    } else {
      const int r2 = r - sz.n * H;
      const int k = r2 / sy.n;
      y = (r2 - k * sy.n) ? sy.hi : sy.lo;
      z = off_shell(k, sz);
    }
  } else {
    const int p = v - rows * W;
    const int t = p / sx.n;
    x = (p - t * sx.n) ? sx.hi : sx.lo;
    const int ty = t / (H - sy.n);
    y = off_shell(t - ty * (H - sy.n), sy);
    z = off_shell(ty, sz);
  }
  int ez[3], ey[3], ex[3];
  const int nz = pad_sources(z, D, mz, ez);
  const int ny = pad_sources(y, H, my, ey);
  const int nx = pad_sources(x, W, mx, ex);
  float acc[V];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= nx) break;
    float ay[V];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= ny) break;
      float az[V];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i >= nz) break;
        const float* src =
            g + ((((int64_t)b * (D + 2) + ez[i]) * (H + 2) + ey[j]) *
                     (W + 2) + ex[k]) * C + c;
        float t[V];
        if constexpr (V == 8) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
          t[0] = lo.x;
          t[1] = lo.y;
          t[2] = lo.z;
          t[3] = lo.w;
          t[4] = hi.x;
          t[5] = hi.y;
          t[6] = hi.z;
          t[7] = hi.w;
        } else {
          t[0] = __ldg(src);
        }
#pragma unroll
        for (int q = 0; q < V; ++q) az[q] = i ? az[q] + t[q] : t[q];
      }
#pragma unroll
      for (int q = 0; q < V; ++q) ay[q] = j ? ay[q] + az[q] : az[q];
    }
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = k ? acc[q] + ay[q] : ay[q];
  }
  __nv_bfloat16* dst = dx + ((((int64_t)b * D + z) * H + y) * W + x) * C + c;
  if constexpr (V == 8) {
    union {
      uint4 u;
      __nv_bfloat162 h[4];
    } pack;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pack.h[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(dst) = pack.u;
  } else {
    dst[0] = __float2bfloat16(acc[0]);
  }
}

}  // namespace

// out (B, (D - 1) / 2 + 1, ..., co) = act(conv(x, stride 2, zero padding 1)
// + bias)
extern "C" int conv3x3x3_down2_ndhwc(const void* x, const void* w,
                                     const void* bias, void* out, void* ws,
                                     const int* plan, int B, int D, int H,
                                     int W, int ci, int co, int act,
                                     float slope, int out_f32,
                                     void* stream) {
  return conv_launch(x, nullptr, 0, w, bias, out, ws, plan, B, D, H, W, ci,
                     0, co, 0, act, slope, out_f32, stream, 0, /*mode=*/2);
}

// dx (B, D, H, W, ci) bf16 of a 3x3x3 "same" conv from dy (B, D, H, W, co)
// and the flipped, transposed packed weights w_t (27 * co, ci); zero_bias is
// (ci,) f32 zeros; pad the forward conv's padding. Other than zeros on
// every axis: the split store, g_ext (B, D+2, H+2, W+2, ci) f32 scratch,
// written at the shell sources only; dx is whole only after the shell pass
// (`pad_shell_ndhwc`) on the same stream.
extern "C" int conv3x3x3_dgrad_ndhwc(const void* dy, const void* w_t,
                                     const void* zero_bias, void* g_ext,
                                     void* dx, void* ws, const int* plan,
                                     int B, int D, int H, int W, int co,
                                     int ci, int pad, void* stream) {
  if (!pad) {
    return conv_launch(dy, nullptr, 0, w_t, zero_bias, dx, ws, plan, B, D, H,
                       W, co, 0, ci, 0, 0, 0.f, 0, stream);
  }
  return conv_launch(dy, nullptr, 0, w_t, zero_bias, g_ext, ws, plan, B, D, H,
                     W, co, 0, ci, 0, 0, 0.f, 1, stream, /*grow=*/1,
                     /*mode=*/0, 0, 0, 0, dx, 0, pad);
}

// the padded dgrad's shell pass: each dx (B, D, H, W, C) bf16 voxel with
// some axis index where a halo face of that axis's mode of `pad` lands
// becomes the f32 sum of its sources in g_ext (B, D+2, H+2, W+2, C),
// rounded once; no other voxel is written
extern "C" int pad_shell_ndhwc(const void* g_ext, void* dx, int B, int D,
                               int H, int W, int C, int pad, void* stream) {
  const int mz = pad & 3, my = (pad >> 2) & 3, mx = (pad >> 4) & 3;
  auto too_small = [](int n, int m) { return n < (m == 1 ? 2 : 1); };
  if (B < 1 || B > 65535 || C < 1 || pad < 1 || pad > 63 ||
      too_small(D, mz) || too_small(H, my) || too_small(W, mx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = C % 8 == 0 && aligned16(g_ext) && aligned16(dx);
  auto count = [](int n, int m) {
    return m == 0 ? 0 : (m == 1 ? n == 3 : n == 1) ? 1 : 2;
  };
  const int nz = count(D, mz), ny = count(H, my), nx = count(W, mx);
  const int64_t voxels = ((int64_t)nz * H + (int64_t)(D - nz) * ny) * W +
                         (int64_t)(D - nz) * (H - ny) * nx;
  const int64_t items = voxels * (vec ? C / 8 : C);
  if (items > INT32_MAX - 256) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((items + 255) / 256), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    pad_shell_kernel<8><<<grid, 256, 0, s>>>(
        static_cast<const float*>(g_ext), static_cast<__nv_bfloat16*>(dx), D,
        H, W, C, pad, (int)items);
  } else {
    pad_shell_kernel<1><<<grid, 256, 0, s>>>(
        static_cast<const float*>(g_ext), static_cast<__nv_bfloat16*>(dx), D,
        H, W, C, pad, (int)items);
  }
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
