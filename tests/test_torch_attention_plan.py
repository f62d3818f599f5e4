"""The attention kernels' shared-memory layout, descriptor reads, ring
schedule and tile recurrence, replayed in numpy on the CPU.

`anatomix_tpu_torch/kernels/csrc/flash_attention.cu` stages every q, K, V
and dO tile once as no-swizzle core matrices (`load_rows`: one warp per 8 x
8 core, lane l on row l / 4 and head dims 2 (l % 4), + 1; zeros past N and
past hd) and reads each tile through wgmma matrix descriptors, K-major for
S = q K^T and dP = dO V^T, MN-major (the transpose bit) for P V and dS K.
These tests rebuild the shared-memory bytes from the copy's index map, read
them back through the descriptors as `hopper.cuh` documents them, and hold
the products to numpy's on the same integer-valued operands (exact in
float64). The accumulator -> register-A repacking (`pack_a`), the ring's
slot schedule and the forward's online-softmax recurrence (fresh-accumulator
fold, ragged last tile, the pipelined order of the max and the fold) are
replayed the same way. The tile sizes are read from the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = (Path(__file__).resolve().parents[1] / "anatomix_tpu_torch" / "kernels"
       / "csrc" / "flash_attention.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


KT = _const("KT")            # keys per ring tile
RING = _const("RING")        # ring stages
DQ_WG = _const("DQ_WG")      # dq's warpgroups a block
_FWD = re.search(r"return HDP <= (\d+) \? (\d+) : (\d+);", SRC)


def _fwd_wg(hdp):
    """fwd_wg<HDP>(): the forward's warpgroups a block."""
    return int(_FWD.group(2)) if hdp <= int(_FWD.group(1)) else int(
        _FWD.group(3))


def _hdp(hd):
    """The head-dim instantiation the launchers pick (HDP)."""
    return next(p for p in (16, 32, 48, 64, 80, 128) if hd <= p)


def _stage(src, r0, R, hdp):
    """`load_rows<R, HDP, NT>`: rows [r0, r0 + R) of a (N, hd) head as the
    bf16 elements (2 bytes each) of the core-matrix tile, and how often the
    copy wrote each element. Core c = (j, i) (head-dim group j, row group
    i) is filled by one warp at bytes c * 128 + lane * 4."""
    N, hd = src.shape
    RG = R // 8
    c = np.arange(RG * (hdp // 8))[:, None]
    lane = np.arange(32)[None, :]
    j, i = c // RG, c % RG
    row = r0 + 8 * i + (lane >> 2)
    col = 8 * j + 2 * (lane & 3)
    ok = (row < N) & (col < hd)
    elem = (c * 128 + lane * 4) // 2
    tile = np.zeros(R * hdp)
    hits = np.zeros(R * hdp, dtype=np.int64)
    for h in (0, 1):
        # hd is even: a pair is inside hd or past it whole
        tile[(elem + h)[ok]] = src[row[ok], col[ok] + h]
        np.add.at(hits, (elem + h).ravel(), 1)
    return tile, hits


def _read(tile, start, lbo, sbo, mn_major, MN, K=16):
    """What a wgmma reads through a no-swizzle descriptor (start, leading
    byte offset = between core matrices adjacent along K, stride byte
    offset = along M or N; `hopper.cuh`): the operand as (MN, K). K-major:
    a core row is one M/N index with 8 K; MN-major: one K with 8 M/N."""
    mn = np.arange(MN)[:, None]
    k = np.arange(K)[None, :]
    if mn_major:
        byte = start + (k // 8) * lbo + (mn // 8) * sbo + (k % 8) * 16 + (
            mn % 8) * 2
    else:
        byte = start + (mn // 8) * sbo + (k // 8) * lbo + (mn % 8) * 16 + (
            k % 8) * 2
    assert (byte % 2 == 0).all()
    return tile[byte // 2]


def _ints(rng, *shape):
    # small integers: every product and sum below is exact in float64
    return rng.integers(-8, 9, size=shape).astype(np.float64)


def _padded(a, r0, R, hdp):
    """Rows [r0, r0 + R) of `a` zero-filled past N and to hdp columns."""
    N, hd = a.shape
    out = np.zeros((R, hdp))
    rows = a[r0:min(r0 + R, N)]
    out[:len(rows), :hd] = rows
    return out


@pytest.mark.parametrize("N", [4104, 130, 50])
@pytest.mark.parametrize("hd", [66, 64, 16])
def test_staged_tiles_reproduce_the_three_products(N, hd):
    """One staged K tile, read K-major, gives q K^T and, read MN-major,
    dS K; one staged V tile gives dO V^T (K-major) and P V (MN-major);
    the q / dO block read K-major is the A operand of S and dP. Every
    element of every tile is written once, zeros past N and past hd. The
    first and the last (ragged) query block, every key tile."""
    rng = np.random.default_rng(N + hd)
    hdp = _hdp(hd)
    q, k, v, do = (_ints(rng, N, hd) for _ in range(4))
    kg = KT // 8 * 128
    tiles = range((N + KT - 1) // KT)
    staged = {}
    for t in tiles:
        for name, a in (("k", k), ("v", v)):
            tile, hits = _stage(a, t * KT, KT, hdp)
            assert (hits == 1).all()
            staged[name, t] = tile
    for bq, name, qop in ((_fwd_wg(hdp) * 64, "fwd", q),
                          (DQ_WG * 64, "dq", do)):
        if name == "dq" and hd > 80:
            continue
        qg = bq // 8 * 128
        blocks = sorted({0, (N - 1) // bq})
        for b in blocks:
            sq, hits = _stage(qop, b * bq, bq, hdp)
            assert (hits == 1).all()
            ref_q = _padded(qop, b * bq, bq, hdp)
            for wg in range(bq // 64):
                qa = wg * 8 * 128
                # the A operand, K-major, over HDP / 16 head-dim steps
                a = np.concatenate([_read(sq, qa + 2 * kk * qg, qg, 128,
                                          False, 64)
                                    for kk in range(hdp // 16)], axis=1)
                np.testing.assert_array_equal(a, ref_q[64 * wg:64 * wg + 64])
                for t in tiles:
                    b_op = "k" if name == "fwd" else "v"
                    ref_t = _padded(k if b_op == "k" else v, t * KT, KT, hdp)
                    s = sum(_read(sq, qa + 2 * kk * qg, qg, 128, False, 64)
                            @ _read(staged[b_op, t], 2 * kk * kg, kg, 128,
                                    False, KT).T
                            for kk in range(hdp // 16))
                    np.testing.assert_array_equal(s, a @ ref_t.T)
        # the 64-key A operand of the second product (P or dS) against the
        # same tiles read MN-major: P V (forward), dS K (dq)
        for t in tiles:
            b_op = "v" if name == "fwd" else "k"
            ref_t = _padded(v if b_op == "v" else k, t * KT, KT, hdp)
            p = _ints(rng, 64, KT)
            o = sum(p[:, 16 * kk:16 * kk + 16]
                    @ _read(staged[b_op, t], 2 * kk * 128, 128, kg, True,
                            hdp).T
                    for kk in range(KT // 16))
            np.testing.assert_array_equal(o, p @ ref_t)
            # past hd the padding reads 0, past N the rows read 0
            assert not o[:, hd:].any()


@pytest.mark.parametrize("hdp", [16, 80, 128])
def test_head_dim_padding_and_rows_past_n_are_zero(hdp):
    """A one-row head: every staged element but row 0's first hd reads
    0."""
    hd = hdp - 14 if hdp > 16 else 16
    src = np.arange(1, hd + 1, dtype=np.float64)[None, :]
    tile, hits = _stage(src, 0, KT, hdp)
    assert (hits == 1).all()
    kg = KT // 8 * 128
    full = np.concatenate([_read(tile, 2 * kk * kg, kg, 128, False, KT)
                           for kk in range(hdp // 16)], axis=1)
    assert full.shape == (KT, hdp)
    np.testing.assert_array_equal(full[0, :hd], src[0])
    assert not full[1:].any() and not full[0, hd:].any()


def _acc_layout():
    """The m64nN accumulator (`Wgmma`, `hopper.cuh`): for thread t of the
    warpgroup and register i of an 8-column block j, its (row, column)."""
    t = np.arange(128)[:, None, None]
    j = np.arange(8)[None, :, None]
    i = np.arange(4)[None, None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (i // 2)
    col = 8 * j + 2 * (t % 4) + i % 2
    return row, col  # (128, 8, 4): d[4 j + i]


def _a_fragment_layout():
    """The register-A fragment of `WgmmaRS`: for thread t, register r of a
    K step and half h of its bf16 pair, its (row, K)."""
    t = np.arange(128)[:, None, None]
    r = np.arange(4)[None, :, None]
    h = np.arange(2)[None, None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (r % 2)
    kcol = 2 * (t % 4) + h + 8 * (r // 2)
    return row, kcol  # (128, 4, 2)


def test_pack_a_turns_the_accumulator_into_the_next_a_operand():
    """`pack_a`: a[j / 2][(j % 2) * 2 + 0] = (d[4 j], d[4 j + 1]),
    a[j / 2][(j % 2) * 2 + 1] = (d[4 j + 2], d[4 j + 3]); read back through
    the register-A layout, K step kk is columns 16 kk .. 16 kk + 15 of the
    accumulator's 64 x 64 tile, for every thread."""
    S = np.random.default_rng(0).standard_normal((64, 64))
    arow, acol = _acc_layout()
    d = S[arow, acol].reshape(128, 32)
    a = np.zeros((128, 4, 4, 2))
    for j in range(8):
        a[:, j // 2, (j % 2) * 2 + 0] = d[:, [4 * j, 4 * j + 1]]
        a[:, j // 2, (j % 2) * 2 + 1] = d[:, [4 * j + 2, 4 * j + 3]]
    frow, fk = _a_fragment_layout()
    for kk in range(4):
        A = np.full((64, 16), np.nan)
        A[frow, fk] = a[:, kk]
        np.testing.assert_array_equal(A, S[:, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 5, 65])
def test_ring_schedule_never_overwrites_a_tile_in_use(ntiles):
    """The forward's and dq's ring in program order: the prologue loads
    tiles 0 .. RING - 2 (one commit group each) and waits for tile 0
    (`cp_async_wait<RING - 2>`); iteration t of the loop over every tile
    but the last waits (`<RING - 3>`), passes the barrier, loads tile t +
    RING - 1 into its slot, then reads K of tile t + 1 and V (forward) or
    K (dq) of tile t; the last tile is read after the loop. Each read finds
    its tile landed in its slot, and each load goes to a slot whose tile
    every read is done with (all reads of earlier iterations retire before
    the barrier)."""
    slot = [None] * RING          # tile held by each slot
    landed = set()
    groups = []                   # commit groups, each a list of tiles
    reads_left = {}               # tile -> reads still to come

    def load(t):
        assert slot[t % RING] is None or reads_left[slot[t % RING]] == 0
        slot[t % RING] = t
        reads_left[t] = 2         # its K (S or dP) and its V or K (P V, dS K)
        return t

    def wait(pending):
        while len(groups) > pending:
            landed.update(groups.pop(0))

    def read(t):
        assert t in landed and slot[t % RING] == t
        reads_left[t] -= 1

    for s in range(RING - 1):
        groups.append([load(s)] if s < ntiles else [])
    wait(RING - 2)
    read(0)                       # tile 0's S
    for t in range(ntiles - 1):
        wait(RING - 3)
        nxt = t + RING - 1
        groups.append([load(nxt)] if nxt < ntiles else [])
        read(t + 1)               # S of tile t + 1
        read(t)                   # P V / dS K of tile t
    read(ntiles - 1)              # the last tile's P V / dS K
    assert all(n == 0 for n in reads_left.values())
    assert sorted(reads_left) == list(range(ntiles))


def _forward_tiles(q, k, v, scale):
    """The kernel's recurrence per query row in float64, in its order:
    softmax of tile 0, then per iteration the softmax of tile t + 1 (new
    max, alpha, exp, sum) before the fold of tile t, O = O alpha_t + P_t V_t
    (P_t V_t a fresh accumulator), and the last tile's fold after the loop;
    keys past N -inf before the max. Returns (out, natural lse)."""
    N = k.shape[0]
    log2e = 1.0 / np.log(2.0)
    st = {"m": np.full(q.shape[0], -np.inf), "l": np.zeros(q.shape[0])}

    def softmax(t):
        s = q @ k[t * KT:(t + 1) * KT].T * scale * log2e
        s = np.concatenate([s, np.full((q.shape[0], KT - s.shape[1]),
                                       -np.inf)], axis=1)
        mn = np.maximum(st["m"], s.max(axis=1))
        assert np.isfinite(mn).all()   # every tile starts below N
        st["al"] = np.exp2(st["m"] - mn)
        st["m"] = mn
        p = np.exp2(s - mn[:, None])
        st["l"] = st["l"] * st["al"] + p.sum(axis=1)
        return p

    def pv(p, t):
        vt = np.zeros((KT, v.shape[1]))
        rows = v[t * KT:(t + 1) * KT]
        vt[:len(rows)] = rows
        return p @ vt

    ntiles = (N + KT - 1) // KT
    o = np.zeros((q.shape[0], v.shape[1]))
    p = softmax(0)
    for t in range(ntiles - 1):
        a = st["al"]
        p_next = softmax(t + 1)
        o = o * a[:, None] + pv(p, t)
        p = p_next
    o = o * st["al"][:, None] + pv(p, ntiles - 1)
    lse = (st["m"] + np.log2(st["l"])) * np.log(2.0)
    return o / st["l"][:, None], lse


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130, 4104])
@pytest.mark.parametrize("hd", [66, 16])
def test_forward_tile_recurrence_matches_softmax(N, hd):
    """The float64 recurrence against torch.softmax(q k^T scale) v and
    torch.logsumexp, for the first query block's rows and the last query
    (the one past the ragged block's first), to 1e-12."""
    rng = np.random.default_rng(N * 7 + hd)
    q, k, v = (rng.standard_normal((N, hd)) * 2.0 for _ in range(3))
    scale = hd ** -0.5
    rows = sorted(set(range(min(N, _fwd_wg(_hdp(hd)) * 64))) | {N - 1})
    out, lse = _forward_tiles(q[rows], k, v, scale)
    logits = torch.from_numpy(q[rows] @ k.T * scale)
    ref = (torch.softmax(logits, dim=-1) @ torch.from_numpy(v)).numpy()
    ref_lse = torch.logsumexp(logits, dim=-1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(
        ref).max())
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-12 * max(
        np.abs(ref_lse).max(), 1.0))


@pytest.mark.parametrize("N", [1, 65, 130])
def test_dq_tile_recurrence_matches_the_gradient(N):
    """dq's walk in float64: P from the forward's lse (keys past N 0), dS =
    P (dP - di), dQ = sum over key tiles of dS_t K_t, scaled once at the
    end; against torch.autograd of softmax(q k^T scale) v."""
    rng = np.random.default_rng(N)
    hd = 66
    q, k, v, do = (rng.standard_normal((N, hd)) for _ in range(4))
    scale = hd ** -0.5
    out, lse = _forward_tiles(q, k, v, scale)
    di = (out * do).sum(axis=1)
    dq = np.zeros((N, hd))
    for t in range((N + KT - 1) // KT):
        kt, vt = k[t * KT:(t + 1) * KT], v[t * KT:(t + 1) * KT]
        p = np.exp2(q @ kt.T * scale / np.log(2.0)
                    - lse[:, None] / np.log(2.0))
        ds = p * (do @ vt.T - di[:, None])
        dq += ds @ kt
    dq *= scale
    qt = torch.from_numpy(q).requires_grad_()
    o = torch.softmax(qt @ torch.from_numpy(k).T * scale, dim=-1) @ \
        torch.from_numpy(v)
    (ref,) = torch.autograd.grad(o, qt, torch.from_numpy(do))
    np.testing.assert_allclose(dq, ref.numpy(), rtol=0,
                               atol=1e-11 * max(np.abs(ref.numpy()).max(),
                                                1.0))
