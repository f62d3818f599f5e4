// The conv kernels' padding (K1, K3 and D3 in conv3d.cu, T-w in
// conv3d_wgrad.cu): a mode per axis in 2 bits of `pad` (D, H, W from bit
// 0; `kernels/conv.pad_code`), and the voxel a halo coordinate reads.
#pragma once

// the voxel that coordinate i of an n-extent axis reads under pad mode m
// (0 zeros: `ok` false outside the volume; 1 reflect; 2 replicate; 3
// circular)
__device__ __forceinline__ int pad_index(int i, int n, int m, bool& ok) {
  if (m == 0) {
    ok = ok && i >= 0 && i < n;
    return i;
  }
  if (m == 1) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  } else if (m == 3) {
    if (i < 0) i += n;
    else if (i >= n) i -= n;
  }
  // a tile's overhang past the volume is never stored (K1, K3, D3) or
  // meets a zero dy (T-w); keep it in bounds
  return min(max(i, 0), n - 1);
}

// reflect on every axis (the UNets' default) or zeros on every axis: the
// kernels' default instantiation (GP false) takes these alone, as two
// branches; the per-axis mode decode of the other paddings (GP true, the
// launcher's choice from `pad`) costs the gather loops 5-10 percent
constexpr int PAD_REFLECT3 = 1 | 1 << 2 | 1 << 4;

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// (z, y, x) through each axis's pad mode of `pad`
template <bool GP>
__device__ __forceinline__ void pad_voxel(int pad, int D, int H, int W,
                                          int& iz, int& iy, int& ix,
                                          bool& ok) {
  if (GP) {
    iz = pad_index(iz, D, pad & 3, ok);
    iy = pad_index(iy, H, (pad >> 2) & 3, ok);
    ix = pad_index(ix, W, (pad >> 4) & 3, ok);
  } else if (pad) {
    iz = reflect_index(iz, D);
    iy = reflect_index(iy, H);
    ix = reflect_index(ix, W);
  } else {
    ok = ok && iz >= 0 && iz < D && iy >= 0 && iy < H && ix >= 0 &&
         ix < W;
  }
}

// whether `pad` needs the per-axis decode
inline bool generic_pad(int pad) { return pad != 0 && pad != PAD_REFLECT3; }
