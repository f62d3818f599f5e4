"""The replicate and circular pads on the port's conv kernels, on the CPU:
their adjoints as the input-gradient kernels split them (`kernels/
conv_train.py`, `csrc/conv3d.cu`; the reflect route is
`test_torch_reflect_fold.py`'s), the per-axis padding of a lifted 1-D or
2-D UNet (zeros on the lifted axes), and the wrappers' plain versions.

- `_pad_adjoint` against `jax.vjp` of `jnp.pad(mode="edge" | "wrap")` (the
  pads the JAX package's convs take, `anatomix_tpu/ops/conv.py:27-30`) at
  1e-6, at extents 1, 2, 3, 5 and 8;
- `pad_sources` and the shell kernel's item order replayed from
  `conv3d.cu`, every shell source read exactly once;
- the split route (split store, then shell pass) bit-equal to the plain
  adjoint;
- the forward, weight-gradient and input-gradient plain versions against
  torch autograd of `F.pad` + `F.conv3d`, and the T-w workspace's size.
The kernels themselves are held against these plain versions on the card
(`test_torch_gpu.py`, `chip_smoke.py --options`)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_reflect_fold import (
    _kernel_voxel,
    _kernel_voxel_count,
    kernel_pad_sources,
)

from anatomix_tpu_torch.kernels import conv as kc
from anatomix_tpu_torch.kernels import conv_train as kt
from anatomix_tpu_torch.ops.conv import unpack_conv_weight

MODES = ("replicate", "circular")
JNP = {"replicate": "edge", "circular": "wrap", "reflect": "reflect",
       "zeros": "constant"}
CODE = {"zeros": 0, "reflect": 1, "replicate": 2, "circular": 3}
EXTENTS = [(1, 1, 1), (2, 2, 2), (3, 3, 3), (5, 8, 1), (8, 5, 3),
           (1, 3, 8), (2, 5, 8)]


def _g(ext, C, seed=0):
    rng = np.random.default_rng(seed + sum(ext) + C)
    return rng.standard_normal((2, *(e + 2 for e in ext), C)).astype(
        np.float32)


def _jax_pad_vjp(g, ext, modes):
    """`jax.vjp` of the JAX package's per-axis pads of 1 at `g`."""
    def pad(t):
        for ax, m in zip((1, 2, 3), modes):
            w = [(0, 0)] * 5
            w[ax] = (1, 1)
            t = jnp.pad(t, w, mode=JNP[m])
        return t
    v = jnp.zeros((2, *ext, g.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(pad, v)
    return np.asarray(vjp(jnp.asarray(g))[0], np.float64)


@pytest.mark.parametrize("ext", EXTENTS)
@pytest.mark.parametrize("mode", MODES)
def test_pad_adjoint_matches_jax_vjp(mode, ext):
    """The plain adjoint of the replicate / circular pad, and the split
    route, against `jax.vjp` of `jnp.pad`: f32 add order only, <= 1e-6."""
    g = _g(ext, 8, seed=1)
    ref = _jax_pad_vjp(g, ext, (mode,) * 3)
    for fn in (kt._pad_adjoint, kt.pad_adjoint_split):
        got = fn(torch.from_numpy(g), mode).double().numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("modes", [("zeros", "reflect", "reflect"),
                                   ("zeros", "zeros", "circular"),
                                   ("zeros", "replicate", "replicate")])
def test_mixed_pad_adjoint_of_a_lifted_net(modes):
    """A lifted 2-D or 1-D net pads its leading axes with zeros: the
    adjoint per axis, against JAX's, and the split route's bits."""
    ext = (1, 5, 6) if modes[1] != "zeros" else (1, 1, 9)
    g = _g(ext, 3, seed=2)
    ref = _jax_pad_vjp(g, ext, modes)
    plain = kt._pad_adjoint(torch.from_numpy(g), modes)
    assert np.abs(plain.double().numpy() - ref).max() <= 1e-6 * np.abs(
        ref).max()
    got = kt.pad_adjoint_split(torch.from_numpy(g), modes)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("ext", EXTENTS)
@pytest.mark.parametrize("mode", MODES)
def test_split_route_is_bit_equal_to_the_plain_adjoint(mode, ext, C):
    """The split store then the shell pass give `_pad_adjoint`'s f32 bits,
    though the scratch holds NaN wherever the kernel writes nothing."""
    g = torch.from_numpy(_g(ext, C))
    ref = kt._pad_adjoint(g, mode)
    got = kt.pad_adjoint_split(g, mode)
    assert got.shape == (2, *ext, C) and not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("ext", EXTENTS)
@pytest.mark.parametrize("mode", MODES)
def test_every_shell_source_is_read_once(mode, ext):
    """The shell's voxels once each, in the kernel's item order (replayed
    from `pad_shell_kernel`'s decode) and count; each one's sources per
    axis are `csrc/conv3d.cu` pad_sources (replayed from the source's own
    lines); every shell source of the extended grid, and nothing else, is
    read exactly once."""
    D, H, W = ext
    shell_idx = [set(kt.face_targets(n, mode)) for n in ext]
    shell = np.zeros(ext, bool)
    for z, y, x in itertools.product(*map(range, ext)):
        shell[z, y, x] = (z in shell_idx[0] or y in shell_idx[1]
                          or x in shell_idx[2])
    vox = kt.pad_shell_voxels(D, H, W, mode).tolist()
    assert len(vox) == len(set(map(tuple, vox))) == shell.sum()
    assert len(vox) == _kernel_voxel_count(D, H, W, mode)
    assert [list(_kernel_voxel(v, D, H, W, mode))
            for v in range(len(vox))] == vox
    src = kt.shell_source_mask(D, H, W, mode).numpy()
    g = torch.from_numpy(_g(ext, 3))
    dx, g_ext = kt.pad_split_store_plain(g, mode)
    assert np.array_equal(~torch.isnan(g_ext).any(-1).any(0).numpy(), src)
    assert np.array_equal(torch.isnan(dx).all(-1).any(0).numpy(), shell)
    reads = np.zeros(src.shape, np.int64)
    for z, y, x in vox:
        srcs = []
        for i, n in zip((z, y, x), ext):
            want = kernel_pad_sources(i, n, CODE[mode])
            assert kt.pad_sources(i, n, mode) == want
            s, used = kt._shell_sources(torch.tensor([i]), n, mode)
            assert s[0][used[0]].tolist() == want
            srcs.append(want)
        for e in itertools.product(*srcs):
            reads[e] += 1
    # the halo faces feed the shell only: each once; the interior shell
    # sources once
    assert np.array_equal(reads, src.astype(np.int64))


def _conv_case(shape, ci, co, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*shape, ci)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((27 * ci, co)) * 0.2).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((*shape, co)).astype(
        np.float32))
    return x, w, dy


@pytest.mark.parametrize("pad,shape,ci,co", [
    (pad, shape, ci, co)
    for pad in ("replicate", "circular")
    for shape, ci, co in (((2, 3, 5, 4), 5, 3), ((1, 1, 6, 7), 8, 16),
                          ((2, 2, 1, 3), 3, 4))
] + [(("zeros", "reflect", "circular"), (2, 1, 5, 4), 5, 3),
     (("zeros", "zeros", "replicate"), (1, 1, 1, 9), 8, 16)])
def test_conv_plain_versions_match_torch_autograd(pad, shape, ci, co):
    """The forward, dW and dx plain versions (and the CPU wrappers, which
    run them; the dgrad's two-launch split route too) against torch
    autograd of the per-axis `F.pad` + `F.conv3d` at 1e-5."""
    x, w, dy = _conv_case(shape, ci, co, ci * co)
    bias = torch.zeros(co)
    got = kc.conv3x3x3_ndhwc(x, w, bias, pad_type=pad, out_dtype=torch.float32)
    xr = x.clone().requires_grad_()
    wt = unpack_conv_weight(w, ci).clone().requires_grad_()
    modes = (pad,) * 3 if isinstance(pad, str) else pad
    xc = xr.permute(0, 4, 1, 2, 3)
    for ax, m in enumerate(modes):
        p = [0] * 6
        p[2 * (2 - ax):2 * (2 - ax) + 2] = [1, 1]
        xc = F.pad(xc, p, mode="constant" if m == "zeros" else m)
    ref = F.conv3d(xc, wt).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    gx, gw = torch.autograd.grad(ref, (xr, wt), dy)
    dw = kt.conv3x3x3_wgrad_ndhwc(x, dy, pad_type=pad)
    torch.testing.assert_close(unpack_conv_weight(dw, ci), gw, rtol=1e-5,
                               atol=1e-4)
    dx = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
    torch.testing.assert_close(dx, gx, rtol=1e-5, atol=1e-4)
    st, g_ext = kt.pad_dgrad_store(dy, w, pad)
    assert torch.equal(kt.pad_shell_ndhwc(g_ext, st, pad), dx)


def test_wgrad_workspace_holds_one_partial_per_split():
    """T-w's ordered reduction: a plan of several splits gets an f32
    workspace of one (27 Ci, Co) partial per split, a plan of one split
    none; the largest on the dev UNet's and the 6M step's shapes stays a
    few tens of MB."""
    largest = 0
    for B, grid, ci, co in [(2, (128,) * 3, 16, 16), (2, (128,) * 3, 96, 32),
                            (2, (4,) * 3, 1024, 1024), (2, (8,) * 3, 1536,
                                                        512),
                            (3, (64,) * 3, 96, 32), (2, (128,) * 3, 1, 32)]:
        plan = kt.wgrad_plan(B, grid, ci, co)
        ws = kt.wgrad_workspace(plan, ci, co, "meta")
        if plan.splits == 1:
            assert ws is None
        else:
            assert ws.shape == (plan.splits, 27 * ci, co)
            assert ws.dtype == torch.float32
            largest = max(largest, ws.numel() * 4)
    assert 0 < largest <= 64 * 2 ** 20


def test_pad_extents_are_checked():
    """Reflect needs an extent of 2 on each of its axes; replicate,
    circular and zeros take 1."""
    kc.check_pad_extents((1, 1, 1), "replicate")
    kc.check_pad_extents((1, 4, 4), ("zeros", "reflect", "reflect"))
    with pytest.raises(ValueError, match="reflect"):
        kc.check_pad_extents((1, 4, 4), "reflect")
    with pytest.raises(ValueError, match="pad_type"):
        kc.pad_code("mirror")
    assert kc.pad_code(("zeros", "reflect", "circular")) == (1 << 2) | (
        3 << 4)
