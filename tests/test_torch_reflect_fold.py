"""The reflect pad's adjoint as the port's input-gradient kernels split it
(`kernels/conv_train.py`, `csrc/conv3d.cu`), on the CPU: the split store
writes every extended-grid voxel that is no shell source straight into dx
and the shell's sources into a scratch; the shell pass sums each shell
voxel's sources. Its plain version against `_reflect_pad_adjoint` (bit for
bit) and against `jax.vjp` of the JAX package's reflect pad; the shell's
cover, its sources and the kernel's item order replayed in Python; the
dgrad wrappers on CPU tensors against their plain versions. The kernels
themselves are held against these plain versions on the card
(`test_torch_gpu.py`, `chip_smoke.py`)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels import conv_train as kt

EXTENTS = [(2, 2, 2), (3, 3, 3), (2, 5, 9), (4, 4, 4), (8, 5, 3),
           (16, 16, 16), (34, 18, 10)]
CONV3D = (Path(kt.__file__).resolve().parent / "csrc" / "conv3d.cu")


def _g(ext, C, seed=0):
    """f32 (2, D+2, H+2, W+2, C) extended-grid gradient from a numpy seed."""
    rng = np.random.default_rng(seed + sum(ext) + C)
    return rng.standard_normal((2, *(e + 2 for e in ext), C)).astype(
        np.float32)


def _shell_mask(ext):
    """(D, H, W) bool: some axis index in {1, n - 2}."""
    axes = [np.isin(np.arange(n), [1, n - 2]) for n in ext]
    return axes[0][:, None, None] | axes[1][None, :, None] | \
        axes[2][None, None, :]


def _kernel_voxel(v, D, H, W):
    """The (z, y, x) that thread item v // groups of `reflect_shell_kernel`
    decodes (`csrc/conv3d.cu`: axis_shell, off_shell, the full rows, then
    the x shell's voxels), in the kernel's integer arithmetic."""
    def axis_shell(n):
        lo, hi = min(1, n - 2), max(1, n - 2)
        return lo, hi, 1 if lo == hi else 2

    def off_shell(k, s):
        lo, hi, cnt = s
        k += k >= lo
        k += cnt == 2 and k >= hi
        return k

    sz, sy, sx = axis_shell(D), axis_shell(H), axis_shell(W)
    rows = sz[2] * H + (D - sz[2]) * sy[2]
    if v < rows * W:
        r, x = divmod(v, W)
        if r < sz[2] * H:
            k, y = divmod(r, H)
            z = sz[1] if k else sz[0]
        else:
            k, yi = divmod(r - sz[2] * H, sy[2])
            y, z = (sy[1] if yi else sy[0]), off_shell(k, sz)
    else:
        t, xi = divmod(v - rows * W, sx[2])
        x = sx[1] if xi else sx[0]
        ty, yk = divmod(t, H - sy[2])
        y, z = off_shell(yk, sy), off_shell(ty, sz)
    return z, y, x


def _kernel_voxel_count(D, H, W):
    """The shell's voxels per batch item as `reflect_shell_ndhwc` counts
    them for its grid."""
    nz, ny, nx = (1 if n == 3 else 2 for n in (D, H, W))
    return (nz * H + (D - nz) * ny) * W + (D - nz) * (H - ny) * nx


@pytest.mark.parametrize("C", [1, 8, 48])
@pytest.mark.parametrize("ext", EXTENTS)
def test_split_route_is_bit_equal_to_the_plain_adjoint(ext, C):
    """(a) The split store then the shell pass give `_reflect_pad_adjoint`'s
    f32 bits, though the scratch holds NaN wherever the kernel writes
    nothing."""
    g = torch.from_numpy(_g(ext, C))
    ref = kt._reflect_pad_adjoint(g)
    got = kt.reflect_pad_adjoint_split(g)
    assert got.shape == (2, *ext, C) and not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("ext", EXTENTS)
def test_every_dx_voxel_is_written_once_from_its_reflect_sources(ext):
    """(b) The split store writes dx exactly off the shell; the shell pass
    exactly on it, its voxel list once each and in the kernel's item
    order; each shell voxel's sources per axis are `reflect_sources`, and
    every shell source (and nothing else) of the extended grid is read
    exactly once."""
    D, H, W = ext
    shell = _shell_mask(ext)
    g = torch.from_numpy(_g(ext, 3))
    dx, g_ext = kt.reflect_split_store_plain(g)
    assert np.array_equal(torch.isnan(dx).all(-1).any(0).numpy(), shell)
    assert not torch.isnan(dx[:, torch.from_numpy(~shell)]).any()
    src = kt.shell_source_mask(D, H, W).numpy()
    assert np.array_equal(~torch.isnan(g_ext).any(-1).any(0).numpy(), src)

    vox = kt.reflect_shell_voxels(D, H, W).tolist()
    assert len(vox) == len(set(map(tuple, vox))) == shell.sum()
    assert all(shell[tuple(v)] for v in vox)
    assert len(vox) == _kernel_voxel_count(D, H, W)
    assert [list(_kernel_voxel(v, D, H, W)) for v in range(len(vox))] == vox

    sentinel = torch.full((2, *ext, 3), 7.0)
    out = kt.reflect_shell_plain(g_ext, sentinel.clone())
    assert torch.equal(out[:, torch.from_numpy(~shell)],
                       sentinel[:, torch.from_numpy(~shell)])

    reads = np.zeros(src.shape, np.int64)
    for z, y, x in vox:
        srcs = [kt.reflect_sources(i, n) for i, n in zip((z, y, x), ext)]
        for a, (i, n) in enumerate(zip((z, y, x), ext)):
            s, used = kt._shell_sources(torch.tensor([i]), n)
            assert s[0][used[0]].tolist() == srcs[a]
        for ez in srcs[0]:
            for ey in srcs[1]:
                for ex in srcs[2]:
                    reads[ez, ey, ex] += 1
    assert np.array_equal(reads, src.astype(np.int64))


def test_reflect_sources_mirror_the_kernel():
    """(b) `reflect_sources` and the shell pass's source slots are those of
    `csrc/conv3d.cu` reflect_sources, read from the source."""
    body = re.search(r"int reflect_sources\(int i, int n, int \(&s\)\[3\]\) "
                     r"\{(.*?)\n\}", CONV3D.read_text(), re.S).group(1)
    assert [ln.strip() for ln in body.strip().splitlines()] == [
        "s[0] = i + 1;", "s[1] = i == 1 ? 0 : n + 1;", "s[2] = n + 1;",
        "return 1 + (i == 1) + (i == n - 2);"]
    for n in range(2, 9):
        for i in range(n):
            slots = [i + 1, 0 if i == 1 else n + 1, n + 1]
            count = 1 + (i == 1) + (i == n - 2)
            assert kt.reflect_sources(i, n) == slots[:count]


@pytest.mark.parametrize("ext", EXTENTS)
def test_split_route_matches_jax_reflect_pad_vjp(ext):
    """(c) The route against `jax.vjp` of `jnp.pad(..., mode="reflect")`
    (the pad the JAX package's train conv takes the VJP of) on the same g:
    f32 add order only, <= 1e-6 relative."""
    g = _g(ext, 8, seed=1)
    v = jnp.zeros((2, *ext, 8), jnp.float32)
    _, vjp = jax.vjp(lambda t: jnp.pad(
        t, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)), mode="reflect"), v)
    ref = np.asarray(vjp(jnp.asarray(g))[0], np.float64)
    got = kt.reflect_pad_adjoint_split(torch.from_numpy(g)).double().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
@pytest.mark.parametrize("shape,ci,co", [((2, 2, 3, 5), 8, 4),
                                         ((1, 6, 5, 7), 16, 16),
                                         ((2, 3, 3, 3), 5, 3)])
def test_dgrad_wrappers_on_cpu_match_plain(pad, shape, ci, co):
    """(d) `conv3x3x3_dgrad_ndhwc` on CPU tensors is its plain version, and
    the reflect route's two wrappers (`reflect_dgrad_store`, then
    `reflect_shell_ndhwc`) give its bits."""
    rng = np.random.default_rng(ci * co)
    dy = torch.from_numpy(rng.standard_normal((*shape, co)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((27 * ci, co)) * 0.1).astype(
        np.float32))
    ref = kt.conv3x3x3_dgrad_ndhwc_plain(dy, w, pad_type=pad)
    got = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
    assert got.shape == (*shape, ci) and torch.equal(got, ref)
    if pad == "reflect":
        dx, g_ext = kt.reflect_dgrad_store(dy, w)
        assert torch.equal(kt.reflect_shell_ndhwc(g_ext, dx), ref)
