// Variants of the channel-less space-to-depth (L-c1, x (B, 2d, 2h, 2w) ->
// (B, d, h, w, 8)), timed against each other by c1_variants.py; the one the
// port ships is csrc/reshuffle.cu's s2d_c1_vec_kernel (variant 6 here).
//   0  one output voxel a thread: four pair loads, one 32-byte store (the
//      kernel before the redesign)
//   1  a thread loads one 16-byte run of each of the four input rows and
//      stores the 64 contiguous bytes they make (a warp's stores 64 bytes
//      apart), with streaming cache hints
//   2  variant 1 without the hints
//   3  one thread per 16-byte output run (a warp stores 512 contiguous
//      bytes), built from two (f32) or four (bf16) pair loads, flat index
//   4  variant 3 with streaming cache hints
//   5  16-byte loads and 16-byte stores, both coalesced, through shared
//      memory
//   6  variant 3 with the row index in the grid
// Entry point: c1_variant(variant, x, out, B, d, h, w, element bytes,
// stream); the pointers 16-byte aligned, w such that every row is whole
// 16-byte runs.
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

constexpr int NT = 256;
template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

template <typename T>
__global__ void __launch_bounds__(NT) v0(const T* __restrict__ x, T* __restrict__ out, uint32_t n_vox, uint32_t d, uint32_t h, uint32_t w) {
  const uint32_t e = blockIdx.x * NT + threadIdx.x;
  if (e >= n_vox) return;
  uint32_t t = e; const uint32_t k = t % w; t /= w; const uint32_t j = t % h; t /= h; const uint32_t i = t % d; const uint32_t b = t / d;
  Vec<T, 8> y;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t src = (((b * 2 * d + 2 * i + (p >> 1)) * 2 * h + 2 * j + (p & 1)) * 2 * w) + 2 * k;
    const Vec<T, 2> pair = *reinterpret_cast<const Vec<T, 2>*>(x + src);
    y.v[2 * p] = pair.v[0]; y.v[2 * p + 1] = pair.v[1];
  }
  *reinterpret_cast<Vec<T, 8>*>(out + (size_t)e * 8) = y;
}

template <bool HINT> __device__ __forceinline__ uint4 ld16(const uint4* p) { if constexpr (HINT) return __ldcs(p); else return *p; }
template <bool HINT> __device__ __forceinline__ void st16(uint4* p, uint4 v) { if constexpr (HINT) __stcs(p, v); else *p = v; }

template <typename P, bool HINT>
__global__ void __launch_bounds__(NT) v_runs(const uint4* __restrict__ x, uint4* __restrict__ out, uint32_t n_rows, uint32_t h, uint32_t nq) {
  constexpr int G = 16 / sizeof(P);
  const uint32_t q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  for (uint32_t row = blockIdx.y * blockDim.y + threadIdx.y; row < n_rows; row += gridDim.y * blockDim.y) {
    const uint32_t j = row % h, bi = row / h;
    const size_t r00 = ((size_t)(2 * bi) * 2 * h + 2 * j) * nq + q, dz = (size_t)2 * h * nq, dy = nq;
    uint4 L[4] = {ld16<HINT>(x + r00), ld16<HINT>(x + r00 + dy), ld16<HINT>(x + r00 + dz), ld16<HINT>(x + r00 + dz + dy)};
    uint4* o = out + ((size_t)row * nq + q) * 4;
    if constexpr (G == 2) {
      st16<HINT>(o + 0, make_uint4(L[0].x, L[0].y, L[1].x, L[1].y));
      st16<HINT>(o + 1, make_uint4(L[2].x, L[2].y, L[3].x, L[3].y));
      st16<HINT>(o + 2, make_uint4(L[0].z, L[0].w, L[1].z, L[1].w));
      st16<HINT>(o + 3, make_uint4(L[2].z, L[2].w, L[3].z, L[3].w));
    } else {
      st16<HINT>(o + 0, make_uint4(L[0].x, L[1].x, L[2].x, L[3].x));
      st16<HINT>(o + 1, make_uint4(L[0].y, L[1].y, L[2].y, L[3].y));
      st16<HINT>(o + 2, make_uint4(L[0].z, L[1].z, L[2].z, L[3].z));
      st16<HINT>(o + 3, make_uint4(L[0].w, L[1].w, L[2].w, L[3].w));
    }
  }
}

// one thread per 16-byte output chunk, pair loads
template <typename P, bool HINT>
__global__ void __launch_bounds__(NT) v_chunk(const P* __restrict__ x, uint4* __restrict__ out, uint32_t n_chunks, uint32_t h, uint32_t w, uint32_t nch) {
  const uint32_t e = blockIdx.x * NT + threadIdx.x;
  if (e >= n_chunks) return;
  const uint32_t row = e / nch, c = e - row * nch;
  const uint32_t j = row % h, bi = row / h;
  // pairs per input row: w
  const size_t r00 = ((size_t)(2 * bi) * 2 * h + 2 * j) * w, dz = (size_t)2 * h * w, dy = w;
  uint4 v;
  if constexpr (sizeof(P) == 8) {
    const uint32_t k = c >> 1, hh = c & 1;
    const size_t base = r00 + hh * dz + k;
    P a, b;
    if constexpr (HINT) { a = __ldcs(x + base); b = __ldcs(x + base + dy); } else { a = x[base]; b = x[base + dy]; }
    v = make_uint4(a.x, a.y, b.x, b.y);
  } else {
    const size_t base = r00 + c;
    P a0, a1, a2, a3;
    if constexpr (HINT) { a0 = __ldcs(x + base); a1 = __ldcs(x + base + dy); a2 = __ldcs(x + base + dz); a3 = __ldcs(x + base + dz + dy); }
    else { a0 = x[base]; a1 = x[base + dy]; a2 = x[base + dz]; a3 = x[base + dz + dy]; }
    v = make_uint4(a0, a1, a2, a3);
  }
  st16<HINT>(out + e, v);
}

// smem staged: tile of rows, 16-byte loads and stores, each coalesced
template <typename P>
__global__ void __launch_bounds__(NT) v_smem(const uint4* __restrict__ x, uint4* __restrict__ out, uint32_t n_rows, uint32_t h, uint32_t nch) {
  constexpr int G = 16 / sizeof(P);
  __shared__ uint4 buf[NT];
  P* bp = reinterpret_cast<P*>(buf);
  const uint32_t t = threadIdx.x, rows_per = NT / nch;
  const uint32_t rr = t / nch, c = t % nch;
  const uint32_t p = c & 3, m = c >> 2;  // plane, 16-byte run within the plane row
  const uint32_t q4 = nch / 4;  // runs per plane row
  for (uint32_t row0 = blockIdx.x * rows_per; row0 < n_rows; row0 += gridDim.x * rows_per) {
    const uint32_t row = row0 + rr;
    if (row < n_rows) {
      const uint32_t j = row % h, bi = row / h;
      const size_t src = ((size_t)(2 * bi + (p >> 1)) * 2 * h + 2 * j + (p & 1)) * q4 + m;
      uint4 L = x[src];
      const P* lp = reinterpret_cast<const P*>(&L);
#pragma unroll
      for (int g = 0; g < G; ++g) bp[rr * nch * G + (m * G + g) * 4 + p] = lp[g];
    }
    __syncthreads();
    if (row < n_rows) out[(size_t)row0 * nch + t] = buf[t];
    __syncthreads();
  }
}

// v3 with the row in the grid: x over a row's chunks, y over rows
template <typename P>
__global__ void __launch_bounds__(NT) v_chunk2(const P* __restrict__ x, uint4* __restrict__ out, uint32_t n_rows, uint32_t h, uint32_t w, uint32_t nch) {
  const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nch) return;
  for (uint32_t row = blockIdx.y * blockDim.y + threadIdx.y; row < n_rows; row += gridDim.y * blockDim.y) {
    const uint32_t j = row % h, bi = row / h;
    const size_t r00 = ((size_t)(2 * bi) * 2 * h + 2 * j) * w, dz = (size_t)2 * h * w, dy = w;
    uint4 v;
    if constexpr (sizeof(P) == 8) {
      const size_t base = r00 + (c & 1) * dz + (c >> 1);
      const P a = x[base], b = x[base + dy];
      v = make_uint4(a.x, a.y, b.x, b.y);
    } else {
      const size_t base = r00 + c;
      v = make_uint4(x[base], x[base + dy], x[base + dz], x[base + dz + dy]);
    }
    out[(size_t)row * nch + c] = v;
  }
}

static unsigned nb(int64_t n) { return (unsigned)((n + NT - 1) / NT); }

template <typename T, typename P>
int run(int v, const void* x, void* out, int B, int d, int h, int w, cudaStream_t st) {
  const uint32_t n_rows = B * d * h;
  if (v == 0) { uint32_t n = n_rows * w; v0<T><<<nb(n), NT, 0, st>>>((const T*)x, (T*)out, n, d, h, w); }
  else if (v == 1 || v == 2) {
    constexpr int G = 16 / sizeof(P);
    const uint32_t nq = w / G; uint32_t tx = 32; while (tx > 1 && tx / 2 >= nq) tx /= 2;
    dim3 block(tx, NT / tx); uint32_t gy = (n_rows + block.y - 1) / block.y; dim3 grid((nq + tx - 1) / tx, gy < 65535u ? gy : 65535u);
    if (v == 1) v_runs<P, true><<<grid, block, 0, st>>>((const uint4*)x, (uint4*)out, n_rows, h, nq);
    else v_runs<P, false><<<grid, block, 0, st>>>((const uint4*)x, (uint4*)out, n_rows, h, nq);
  } else if (v == 3 || v == 4) {
    const uint32_t nch = w * 4 * sizeof(P) / 16; const uint32_t n = n_rows * nch;
    if (v == 3) v_chunk<P, false><<<nb(n), NT, 0, st>>>((const P*)x, (uint4*)out, n, h, w, nch);
    else v_chunk<P, true><<<nb(n), NT, 0, st>>>((const P*)x, (uint4*)out, n, h, w, nch);
  } else if (v == 5) {
    const uint32_t nch = w * 4 * sizeof(P) / 16; const uint32_t rows_per = NT / nch;
    v_smem<P><<<(n_rows + rows_per - 1) / rows_per, NT, 0, st>>>((const uint4*)x, (uint4*)out, n_rows, h, nch);
  } else if (v == 6) {
    const uint32_t nch = w * 4 * sizeof(P) / 16; uint32_t tx = 256; while (tx > 32 && tx / 2 >= nch) tx /= 2;
    dim3 block(tx, NT / tx); uint32_t gy = (n_rows + block.y - 1) / block.y; dim3 grid((nch + tx - 1) / tx, gy < 65535u ? gy : 65535u);
    v_chunk2<P><<<grid, block, 0, st>>>((const P*)x, (uint4*)out, n_rows, h, w, nch);
  } else return -1;
  return (int)cudaGetLastError();
}

extern "C" int c1_variant(int v, const void* x, void* out, int B, int d, int h, int w, int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (elem == 4) return run<uint32_t, uint2>(v, x, out, B, d, h, w, st);
  return run<uint16_t, uint32_t>(v, x, out, B, d, h, w, st);
}
