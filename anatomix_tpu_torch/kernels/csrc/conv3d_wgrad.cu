// Weight gradient of the 3x3x3 stride-1 "same" convolution on channels-last
// (NDHWC) bf16 volumes, written by hand for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the JAX package's Pallas TPU kernels
//   T-w anatomix_tpu/ops/pallas/conv_block_train.py  _wgrad_halo_wide,
//       _wgrad_halo, _wgrad   (dW of K1 in block space, f32 accumulators
//       resident across the whole sequential grid)
// with one implicit-GEMM kernel:
//   dW[(tap * Ci + ci), co] = sum over (b, p) of x_pad[b, p + tap, ci] *
//                             dy[b, p, co]
// i.e. M = 27 * Ci (taps x input channels), N = Co, K = B * D * H * W. The
// result is the packed (27 * Ci, Co) layout of `kernels/conv.py`, in f32.
//
// What bounds it on an H100: the same work as the forward conv (2 * B * S^3
// * 27 * Ci * Co FLOP), and it reads x and dy once (the 16-channel 128^3
// convs move ~64 bytes per voxel for ~14 kFLOP, near the card's ridge); the
// output is tiny. What is hard is the reduction over K = 4.2 M positions at
// 128^3 and only 1,024 at 8^3: the TPU carries its f32 accumulators across
// a sequential grid, but Hopper's blocks run in parallel and in no order.
// The design: a block owns one (16 input channels, N tile of Co) slice of
// dW for all 27 taps, keeps it in WMMA accumulators (f32) in registers, and
// reduces one contiguous chunk of 16x4x2 output bricks; at the end it adds
// its partial sums into the zeroed output with f32 atomicAdd. The number of
// chunks is chosen per shape from the (Ci, Co) tiles so that about four
// blocks per SM are in flight: at 128^3 16->16 a block reduces ~120 bricks,
// at 8^3 256->256 the grid is split along Ci and Co (64 tiles) and a block
// reduces 2 bricks. Per brick the block loads the (TZ+2)x(TY+2)x(TX+2) halo
// of x (padding by index maps: reflect -1 -> 1, n -> n-2, or zeros) and the
// dy brick into shared memory, positions outside the volume carrying a zero
// dy; each warp then runs its share of the 27 * (NT / 16) accumulators over
// the brick's 8 rows of 16 positions (bf16 16x16x16 MMAs, f32 sums; for N
// tiles up to 32 each brick's sums are added to the running ones on the CUDA
// cores, so no tensor-core accumulation chain is longer than 128 products).
// The atomics make the order of the final additions of ~500 f32 partials
// vary from run to run by a few f32 ulps. The result is held to 1e-3 of
// max |dW| against the f32 plain version: the step's dW are sums of
// millions of products that largely cancel (batch norm's backward leaves
// dy with zero sum per channel), so both sides' rounding shows at ~1e-4 of
// the result. Simple first: no cp.async ring, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TX = 16;  // output brick: 16 x 4 x 2 = 128 positions (GEMM K)
constexpr int TY = 4;
constexpr int TZ = 2;
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int HZ = TZ + 2;
constexpr int HALO = HX * HY * HZ;  // 432 halo voxels
constexpr int ROWS = TY * TZ;       // 8 rows of 16 positions per brick
constexpr int CK = 16;              // input channels per block (GEMM M)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BLOCKS_PER_SM = 4;
constexpr int NUM_SMS = 132;

struct WgradArgs {
  const __nv_bfloat16* x;   // (B, D, H, W, ci)
  const __nv_bfloat16* dy;  // (B, D, H, W, co)
  float* dw;                // (27 * ci, co), zeroed by the caller
  int D, H, W, ci, co;
  int tiles_x, tiles_y, tiles_z, ci_tiles;
  int64_t n_bricks;
  int64_t bricks_per_chunk;
  int reflect, xvec, dyvec;
};

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // the brick overhang past the volume carries a zero dy; keep it in bounds
  return min(max(i, 0), n - 1);
}

union Pack8 {  // eight bf16 values as raw 16-bit patterns
  uint4 u;
  unsigned short h[8];
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const WgradArgs a) {
  constexpr int NF = NT / 16;     // Co fragments of the N tile
  constexpr int FRAGS = 27 * NF;  // (tap, Co fragment) accumulators
  constexpr int FPW = (FRAGS + NWARPS - 1) / NWARPS;
  __shared__ __align__(128) unsigned short sX_raw[HALO * CK];
  __shared__ __align__(128) unsigned short sDy_raw[ROWS * 16 * NT];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(sX_raw);
  __nv_bfloat16* sDy = reinterpret_cast<__nv_bfloat16*>(sDy_raw);
  static_assert(NWARPS * 256 * 4 <= HALO * CK * 2,
                "the epilogue staging must fit in the halo buffer");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cb = (blockIdx.x % a.ci_tiles) * CK;
  const int n0 = (blockIdx.x / a.ci_tiles) * NT;
  const int64_t first = (int64_t)blockIdx.y * a.bricks_per_chunk;
  const int64_t end = first + a.bricks_per_chunk;
  const int64_t last = end < a.n_bricks ? end : a.n_bricks;
  const unsigned short* x_u = reinterpret_cast<const unsigned short*>(a.x);
  const unsigned short* dy_u = reinterpret_cast<const unsigned short*>(a.dy);

  // N tiles up to 32 (the long reductions at 64^3-128^3) sum each brick in
  // `part` and add it to `acc` on the CUDA cores, so the tensor cores'
  // accumulation chain is 128 products long and the long chain rounds to
  // nearest; at 64 the registers hold one set only
  constexpr bool kSplit = NT <= 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[kSplit ? FPW : 1];
#pragma unroll
  for (int j = 0; j < FPW; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int64_t br = first; br < last; ++br) {
    int64_t t = br;
    const int x0 = (int)(t % a.tiles_x) * TX;
    t /= a.tiles_x;
    const int y0 = (int)(t % a.tiles_y) * TY;
    t /= a.tiles_y;
    const int z0 = (int)(t % a.tiles_z) * TZ;
    const int64_t b = t / a.tiles_z;

    __syncthreads();  // the previous brick's MMAs are done with sX / sDy
    // x halo: HALO voxels x CK channels, 8 channels (16 bytes) per item
    for (int e = tid; e < HALO * (CK / 8); e += NTHREADS) {
      const int v = e >> 1;
      const int c = cb + (e & 1) * 8;
      const int hx = v % HX;
      const int hy = (v / HX) % HY;
      const int hz = v / (HX * HY);
      int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
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
      if (inside && c < a.ci) {
        const int64_t off = (((b * a.D + gz) * a.H + gy) * a.W + gx) * a.ci;
        if (a.xvec) {
          val.u = *reinterpret_cast<const uint4*>(a.x + off + c);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < a.ci) val.h[j] = x_u[off + c + j];
          }
        }
      }
      *reinterpret_cast<uint4*>(sX + v * CK + (e & 1) * 8) = val.u;
    }
    // dy brick: ROWS x 16 positions x NT channels, zero outside the volume
    for (int e = tid; e < ROWS * 16 * (NT / 8); e += NTHREADS) {
      const int n8 = (e % (NT / 8)) * 8;
      const int pos = e / (NT / 8);  // row * 16 + k
      const int row = pos >> 4;
      const int x = x0 + (pos & 15), y = y0 + row % TY, z = z0 + row / TY;
      const int cout = n0 + n8;
      Pack8 val;
      val.u = make_uint4(0u, 0u, 0u, 0u);
      if (x < a.W && y < a.H && z < a.D && cout < a.co) {
        const int64_t off =
            (((b * a.D + z) * a.H + y) * a.W + x) * a.co + cout;
        if (a.dyvec) {
          val.u = *reinterpret_cast<const uint4*>(a.dy + off);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (cout + j < a.co) val.h[j] = dy_u[off + j];
          }
        }
      }
      *reinterpret_cast<uint4*>(sDy + pos * NT + n8) = val.u;
    }
    __syncthreads();

    if constexpr (kSplit) {
#pragma unroll
      for (int j = 0; j < FPW; ++j) wmma::fill_fragment(part[j], 0.f);
    }
#pragma unroll 1
    for (int row = 0; row < ROWS; ++row) {
      const int wy = row % TY, wz = row / TY;
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        const int f = warp + j * NWARPS;
        if (f < FRAGS) {
          const int tap = f / NF, nf = f % NF;
          const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
          // A = x_pad^T: 16 input channels x the row's 16 positions shifted
          // by the tap (the halo voxels are CK channels apart)
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fa;
          wmma::load_matrix_sync(
              fa, sX + (((wz + kd) * HY + (wy + kh)) * HX + kw) * CK, CK);
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sDy + row * 16 * NT + nf * 16, NT);
          if constexpr (kSplit) {
            wmma::mma_sync(part[j], fa, fb, part[j]);
          } else {
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
    if constexpr (kSplit) {
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
#pragma unroll
        for (int t = 0; t < acc[j].num_elements; ++t) {
          acc[j].x[t] += part[j].x[t];
        }
      }
    }
  }

  // epilogue: stage each accumulator in shared memory, add it to dW
  __syncthreads();
  float* stage = reinterpret_cast<float*>(sX) + warp * 256;
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    const int f = warp + j * NWARPS;
    if (f < FRAGS) {
      const int tap = f / NF, nf = f % NF;
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int cin = cb + (e >> 4);
        const int cout = n0 + nf * 16 + (e & 15);
        if (cin < a.ci && cout < a.co) {
          atomicAdd(a.dw + ((int64_t)tap * a.ci + cin) * a.co + cout,
                    stage[e]);
        }
      }
      __syncwarp();
    }
  }
}

template <int NT>
cudaError_t launch(WgradArgs a, cudaStream_t stream) {
  const int co_tiles = (a.co + NT - 1) / NT;
  const int64_t tiles = (int64_t)a.ci_tiles * co_tiles;
  // about BLOCKS_PER_SM blocks per SM in flight, each over whole bricks
  int64_t chunks = (int64_t)BLOCKS_PER_SM * NUM_SMS / tiles;
  if (chunks < 1) chunks = 1;
  if (chunks > a.n_bricks) chunks = a.n_bricks;
  a.bricks_per_chunk = (a.n_bricks + chunks - 1) / chunks;
  chunks = (a.n_bricks + a.bricks_per_chunk - 1) / a.bricks_per_chunk;
  dim3 grid((unsigned)tiles, (unsigned)chunks);
  wgrad_kernel<NT><<<grid, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dw (27 * ci, co) f32, zeroed by the caller, += the weight gradient of the
// "same" conv of x (B, D, H, W, ci) with upstream gradient dy (B, D, H, W,
// co), both bf16; reflect or zero padding.
extern "C" int conv3x3x3_wgrad_ndhwc(const void* x, const void* dy, void* dw,
                                     int B, int D, int H, int W, int ci,
                                     int co, int reflect, void* stream) {
  WgradArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.dw = static_cast<float*>(dw);
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci = ci;
  a.co = co;
  a.tiles_x = (W + TX - 1) / TX;
  a.tiles_y = (H + TY - 1) / TY;
  a.tiles_z = (D + TZ - 1) / TZ;
  a.ci_tiles = (ci + CK - 1) / CK;
  a.n_bricks = (int64_t)B * a.tiles_x * a.tiles_y * a.tiles_z;
  a.bricks_per_chunk = 0;
  a.reflect = reflect;
  a.xvec = (ci % 8 == 0) && aligned16(x);
  a.dyvec = (co % 8 == 0) && aligned16(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co > 32) return static_cast<int>(launch<64>(a, s));
  if (co > 16) return static_cast<int>(launch<32>(a, s));
  return static_cast<int>(launch<16>(a, s));
}
