"""The reflect pad's adjoint as the port's input-gradient kernels split it
(`kernels/conv_train.py`, `csrc/conv3d.cu`), on the CPU: the split store
writes every extended-grid voxel that is no shell source straight into dx
and the shell's sources into a scratch; the shell pass sums each shell
voxel's sources. Its plain version against `_pad_adjoint` (bit for bit)
and against `jax.vjp` of the JAX package's reflect pad; the shell's cover,
its sources and the kernel's item order replayed in Python; the dgrad
wrappers on CPU tensors against their plain versions. The kernels
themselves are held against these plain versions on the card
(`test_torch_gpu.py`, `chip_smoke.py`). The replicate and circular pads
take the same route (`test_torch_pad_modes.py`)."""

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


def _kernel_voxel(v, D, H, W, mode="reflect"):
    """The (z, y, x) that thread item v // groups of `pad_shell_kernel`
    decodes (`csrc/conv3d.cu`: axis_shell, off_shell, the full rows, then
    the x shell's voxels), in the kernel's integer arithmetic."""
    def axis_shell(n):
        lo_t, hi_t = kt.face_targets(n, mode) or (0, 0)
        lo, hi = min(lo_t, hi_t), max(lo_t, hi_t)
        return lo, hi, 0 if mode == "zeros" else 1 if lo == hi else 2

    def off_shell(k, s):
        lo, hi, cnt = s
        k += cnt >= 1 and k >= lo
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


def _kernel_voxel_count(D, H, W, mode="reflect"):
    """The shell's voxels per batch item as `pad_shell_ndhwc` counts them
    for its grid."""
    one = 3 if mode == "reflect" else 1
    nz, ny, nx = (1 if n == one else 2 for n in (D, H, W))
    return (nz * H + (D - nz) * ny) * W + (D - nz) * (H - ny) * nx


@pytest.mark.parametrize("C", [1, 8, 48])
@pytest.mark.parametrize("ext", EXTENTS)
def test_split_route_is_bit_equal_to_the_plain_adjoint(ext, C):
    """(a) The split store then the shell pass give `_pad_adjoint`'s f32
    bits, though the scratch holds NaN wherever the kernel writes
    nothing."""
    g = torch.from_numpy(_g(ext, C))
    ref = kt._pad_adjoint(g, "reflect")
    got = kt.pad_adjoint_split(g, "reflect")
    assert got.shape == (2, *ext, C) and not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("ext", EXTENTS)
def test_every_dx_voxel_is_written_once_from_its_reflect_sources(ext):
    """(b) The split store writes dx exactly off the shell; the shell pass
    exactly on it, its voxel list once each and in the kernel's item
    order; each shell voxel's sources per axis are `pad_sources`, and
    every shell source (and nothing else) of the extended grid is read
    exactly once."""
    D, H, W = ext
    shell = _shell_mask(ext)
    g = torch.from_numpy(_g(ext, 3))
    dx, g_ext = kt.pad_split_store_plain(g, "reflect")
    assert np.array_equal(torch.isnan(dx).all(-1).any(0).numpy(), shell)
    assert not torch.isnan(dx[:, torch.from_numpy(~shell)]).any()
    src = kt.shell_source_mask(D, H, W).numpy()
    assert np.array_equal(~torch.isnan(g_ext).any(-1).any(0).numpy(), src)

    vox = kt.pad_shell_voxels(D, H, W, "reflect").tolist()
    assert len(vox) == len(set(map(tuple, vox))) == shell.sum()
    assert all(shell[tuple(v)] for v in vox)
    assert len(vox) == _kernel_voxel_count(D, H, W)
    assert [list(_kernel_voxel(v, D, H, W)) for v in range(len(vox))] == vox

    sentinel = torch.full((2, *ext, 3), 7.0)
    out = kt.pad_shell_plain(g_ext, sentinel.clone(), "reflect")
    assert torch.equal(out[:, torch.from_numpy(~shell)],
                       sentinel[:, torch.from_numpy(~shell)])

    reads = np.zeros(src.shape, np.int64)
    for z, y, x in vox:
        srcs = [kt.pad_sources(i, n, "reflect")
                for i, n in zip((z, y, x), ext)]
        for a, (i, n) in enumerate(zip((z, y, x), ext)):
            s, used = kt._shell_sources(torch.tensor([i]), n, "reflect")
            assert s[0][used[0]].tolist() == srcs[a]
        for ez in srcs[0]:
            for ey in srcs[1]:
                for ex in srcs[2]:
                    reads[ez, ey, ex] += 1
    assert np.array_equal(reads, src.astype(np.int64))


def kernel_pad_sources(i, n, m):
    """`csrc/conv3d.cu` pad_sources for pad mode code m, replayed from the
    source's own lines (face_lo, face_hi and pad_sources, read from the
    file and checked line by line)."""
    text = CONV3D.read_text()
    bodies = [re.search(r"int %s\((.*?)\) \{(.*?)\n\}" % name, text,
                        re.S).group(2) for name in
              ("face_lo", "face_hi", "pad_sources")]
    assert [[ln.strip() for ln in b.strip().splitlines()]
            for b in bodies] == [
        ["return m == 1 ? 1 : m == 2 ? 0 : n - 1;"],
        ["return m == 1 ? n - 2 : m == 2 ? n - 1 : 0;"],
        ["s[0] = i + 1;", "int k = 1;",
         "if (m != 0 && i == face_lo(n, m)) s[k++] = 0;",
         "if (m != 0 && i == face_hi(n, m)) s[k++] = n + 1;",
         "return k;"]]
    lo = 1 if m == 1 else 0 if m == 2 else n - 1
    hi = n - 2 if m == 1 else n - 1 if m == 2 else 0
    return ([i + 1] + [0] * (m != 0 and i == lo)
            + [n + 1] * (m != 0 and i == hi))


def test_reflect_sources_mirror_the_kernel():
    """(b) `pad_sources` under reflect and the shell pass's source slots
    are those of `csrc/conv3d.cu` pad_sources, read from the source."""
    for n in range(2, 9):
        for i in range(n):
            want = kernel_pad_sources(i, n, 1)
            assert kt.pad_sources(i, n, "reflect") == want
            s, used = kt._shell_sources(torch.tensor([i]), n, "reflect")
            assert s[0][used[0]].tolist() == want


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
    got = kt.pad_adjoint_split(torch.from_numpy(g),
                               "reflect").double().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
@pytest.mark.parametrize("shape,ci,co", [((2, 2, 3, 5), 8, 4),
                                         ((1, 6, 5, 7), 16, 16),
                                         ((2, 3, 3, 3), 5, 3)])
def test_dgrad_wrappers_on_cpu_match_plain(pad, shape, ci, co):
    """(d) `conv3x3x3_dgrad_ndhwc` on CPU tensors is its plain version, and
    the reflect route's two wrappers (`pad_dgrad_store`, then
    `pad_shell_ndhwc`) give its bits."""
    rng = np.random.default_rng(ci * co)
    dy = torch.from_numpy(rng.standard_normal((*shape, co)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((27 * ci, co)) * 0.1).astype(
        np.float32))
    ref = kt.conv3x3x3_dgrad_ndhwc_plain(dy, w, pad_type=pad)
    got = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
    assert got.shape == (*shape, ci) and torch.equal(got, ref)
    if pad == "reflect":
        dx, g_ext = kt.pad_dgrad_store(dy, w, pad)
        assert torch.equal(kt.pad_shell_ndhwc(g_ext, dx, pad), ref)
