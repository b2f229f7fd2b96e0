"""The tile plan of the conv core that K2 and K3 share
(gandtr_tpu_torch/kernels/conv3x3_plan.py, the host's copy of
csrc/conv3x3_igemm.cuh's `Plan` and `geometry`), emulated on the CPU.

The emulation walks the plan as the kernel does: tiles of one image each,
a (TH+2) x (TW+2) halo per 64-channel chunk (zero or reflect padded, with
the reflect clamp beyond a ragged edge), the 9 taps as shifted windows of
the halo times the (tap, chunk, channel-tile) block of the (9C, C) weight
matrix as given, masked stores, and for K3 each tile's (count, mean, M2)
combined by Chan's formula. On integer-valued bf16 inputs every sum is
exact, so the emulated GEMM must equal the plain versions' convolutions bit
for bit; on the JAX kernel test's random block it must stay within K3's
bounds of fused_resblock_plain and of the JAX kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gandtr_tpu.ops import resblock_pallas as rp
from gandtr_tpu_torch.kernels import conv3x3_plan
from gandtr_tpu_torch.ops.resblock import fused_resblock_plain
from gandtr_tpu_torch.ops.vggconv import conv3x3_same_plain

torch.set_num_threads(1)
EPS = 1e-5


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _reflect(i, n):
    """The halo policy's reflect1: -1 -> 1, n -> n - 2, then clamped (only
    pixels past a ragged tile edge reach the clamp)."""
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _tiles(N, H, W, C):
    """(n, ty, tx, ct) in the kernel's tile order."""
    geo = conv3x3_plan.geometry(H, W, C)
    for n in range(N):
        for ty in range(geo.tiles_y):
            for tx in range(geo.tiles_x):
                for ct in range(geo.co_tiles):
                    yield n, ty, tx, ct


def emulate_conv(x, wmat, pad):
    """The core's sums for x (N, H, W, C), wmat (9C, C), in float64, and the
    tile of each output (for the statistics)."""
    N, H, W, C = x.shape
    p = conv3x3_plan.plan(C)
    geo = conv3x3_plan.geometry(H, W, C)
    KC = conv3x3_plan.KC
    # the weight as the TMA map reads it: (tap, ci, co), zeros past C
    wt = np.zeros((9, geo.nchunks * KC, geo.co_tiles * p.bn))
    wt[:, :C, :C] = wmat.reshape(9, C, C)
    out = np.zeros((N, H, W, C))
    written = np.zeros((N, H, W, C), np.int64)
    for n, ty, tx, ct in _tiles(N, H, W, C):
        y0, x0, co0 = ty * p.th, tx * p.tw, ct * p.bn
        hy = y0 - 1 + np.arange(p.th + 2)
        hx = x0 - 1 + np.arange(p.tw + 2)
        halo = np.zeros((p.th + 2, p.tw + 2, geo.nchunks * KC))
        if pad == "zero":
            iy, ix = (hy >= 0) & (hy < H), (hx >= 0) & (hx < W)
            halo[np.ix_(iy, ix, np.arange(C))] = x[n][np.ix_(hy[iy], hx[ix])]
        else:
            halo[:, :, :C] = x[n][np.ix_(_reflect(hy, H), _reflect(hx, W))]
        acc = np.zeros((p.th * p.tw, p.bn))
        for c in range(geo.nchunks):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                a = halo[ky:ky + p.th, kx:kx + p.tw, c * KC:(c + 1) * KC]
                acc += a.reshape(p.th * p.tw, KC) @ wt[tap, c * KC:(c + 1) * KC,
                                                       co0:co0 + p.bn]
        q = np.arange(p.th * p.tw)
        y, xx = y0 + q // p.tw, x0 + q % p.tw
        ok = (y < H) & (xx < W)
        co = np.arange(co0, min(C, co0 + p.bn))
        out[n, y[ok][:, None], xx[ok][:, None], co[None]] = acc[ok][:, :len(co)]
        written[n, y[ok][:, None], xx[ok][:, None], co[None]] += 1
    assert (written == 1).all(), "every output once, no tile across images"
    return out


def tile_stats(t):
    """Per (n, c) mean and 1/sqrt(var + eps) of t (N, H, W, C) as K3 gets
    them: each tile's count, mean and M2 over its valid pixels, combined in
    tile order by Chan's formula."""
    N, H, W, C = t.shape
    p = conv3x3_plan.plan(C)
    geo = conv3x3_plan.geometry(H, W, C)
    mean = np.zeros((N, C))
    var = np.zeros((N, C))
    for n in range(N):
        na, ma, m2 = 0.0, np.zeros(C), np.zeros(C)
        for ty in range(geo.tiles_y):
            for tx in range(geo.tiles_x):
                v = t[n, ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw]
                v = v.reshape(-1, C)
                nb, mb = len(v), v.mean(axis=0)
                m2b = ((v - mb) ** 2).sum(axis=0)
                d = mb - ma
                ma = ma + d * nb / (na + nb)
                m2 = m2 + m2b + d * d * na * nb / (na + nb)
                na += nb
        mean[n], var[n] = ma, m2 / na
    return mean[:, None, None], 1.0 / np.sqrt(var + EPS)[:, None, None]


def emulate_block(x, w1, b1, w2, b2):
    """K3 on the emulated core, at the kernel's rounding points."""
    C = x.shape[-1]

    def conv(a, w, b):
        acc = emulate_conv(a, w.reshape(9 * C, C), "reflect")
        return _bf16(_bf16(acc) + _bf16(b))

    t1 = conv(x, w1, b1)
    m1, i1 = tile_stats(t1)
    a = _bf16(np.maximum((t1 - m1) * i1, 0.0))
    t2 = conv(a, w2, b2)
    m2, i2 = tile_stats(t2)
    return _bf16((t2 - m2) * i2 + x)


def _ints(rng, shape, lo, hi):
    return rng.randint(lo, hi + 1, shape).astype(np.float64)


@pytest.mark.parametrize("shape", [(2, 30, 26, 64), (2, 15, 13, 128),
                                   (3, 5, 7, 64), (1, 17, 70, 128)])
def test_k2_tiling_equals_the_plain_conv(shape):
    """Zero (SAME) halo; the small images have fewer pixels than one tile,
    where a flat pixel range would have crossed images."""
    N, H, W, C = shape
    rng = np.random.RandomState(C + H)
    x, w = _ints(rng, shape, -3, 3), _ints(rng, (3, 3, C, C), -2, 2)
    got = emulate_conv(x, w.reshape(9 * C, C), "zero")
    want = conv3x3_same_plain(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(w).to(torch.bfloat16), None,
                              False, torch.float32).double().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 17, 23, 64), (1, 9, 40, 128),
                                   (1, 10, 12, 256), (1, 6, 5, 16),
                                   (1, 4, 35, 80)])
def test_k3_tiling_equals_the_reflect_conv(shape):
    """Reflect halo, several channel tiles (256), a partial last chunk and
    channel tile (16, 80); and the tile statistics against the direct ones."""
    N, H, W, C = shape
    rng = np.random.RandomState(C + W)
    x, w = _ints(rng, shape, -3, 3), _ints(rng, (3, 3, C, C), -2, 2)
    got = emulate_conv(x, w.reshape(9 * C, C), "reflect")
    xp = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="reflect")
    want = F.conv2d(xp, torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy())
    mean, inv = tile_stats(got)
    np.testing.assert_allclose(mean, got.mean(axis=(1, 2), keepdims=True),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        inv, 1 / np.sqrt(got.var(axis=(1, 2), keepdims=True) + EPS),
        rtol=1e-9)


@pytest.mark.parametrize("shape", [(2, 17, 23, 64), (2, 16, 24, 256)])
def test_k3_block_on_the_tiling_within_bounds(shape):
    """The whole block on the emulated core against fused_resblock_plain and
    (at C = 256, which it takes) the JAX kernel in interpret mode, within
    tests/test_resblock_pallas.py:47-49's bounds."""
    N, H, W, C = shape
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(N, H, W, C) * 0.5)
    w1, w2 = (_bf16(rng.randn(3, 3, C, C) * 0.05) for _ in range(2))
    b1, b2 = (_bf16(rng.randn(C) * 0.1) for _ in range(2))
    got = emulate_block(x, w1, b1, w2, b2)
    wants = [fused_resblock_plain(*(torch.from_numpy(a.astype(np.float32))
                                    for a in (x, w1, b1, w2, b2)))
             .float().numpy()]
    if C % 128 == 0:
        jx = [jnp.asarray(a, jnp.float32) for a in (x, w1, b1, w2, b2)]
        wants.append(np.asarray(rp.fused_resblock(
            jx[0].astype(jnp.bfloat16), *jx[1:], interpret=True),
            np.float32))
    for want in wants:
        d = np.abs(got - want)
        assert d.max() < 0.06 and d.mean() < 0.01
