"""The cell partition of the CLAHE kernel (csrc/clahe.cu), on the CPU.

The kernel runs one CTA per interpolation cell: the pixels whose raw tile
index floor(pos * (1 / tile) - 0.5), in cv2's float32 chain, is the pair
(a, b). Each CTA finds its rows as [first(a), first(a + 1)) with
`first_at_least`, which starts near (k + 0.5) * tile and steps to the run
boundary. A mistake there would be silent on most shapes, so this mirrors
the rule in PyTorch and checks that the cells' rows cover [0, h) exactly
once, each row in the cell of its own raw index (the chain of
ops/clahe.py::clahe_u8_masked_plain's `axis`), for every h in 1..1024 and
every grid in 1..16, with the tile size of either pad rule. Then the
kernel's whole work is emulated CTA by CTA in numpy (its LUT builds over
each cell's tiles, its V-byte chunks, the band cut among the CTAs) and held
bit for bit against both plain versions, with every pixel written once."""
import numpy as np
import pytest
import torch

from gandtr_tpu_torch.ops.clahe import (_clip_histogram, clahe_u8_masked_plain,
                                        clahe_u8_plain)

torch.set_num_threads(1)


def _raw(pos, inv):
    """floor(pos * inv - 0.5) with each float32 step rounded on its own."""
    return torch.floor(pos.to(torch.float32) * inv - 0.5).long()


def first_at_least(k, valid, ts, inv):
    """The kernel's `first_at_least`, elementwise over tensors: the first
    position in [0, valid] whose raw index is >= k."""
    p = torch.clamp(k * ts + (ts + 1) // 2, min=0)
    p = torch.minimum(p, valid)
    for _ in range(valid.max().item() + 2):
        down = (p > 0) & (_raw(p - 1, inv) >= k)
        if not down.any():
            break
        p = p - down.long()
    for _ in range(valid.max().item() + 2):
        up = (p < valid) & (_raw(p, inv) < k)
        if not up.any():
            break
        p = p + up.long()
    return p


def _tile_size(valid, grid, other_divides):
    """cv2's tile size along an axis: pad to a multiple of the grid, a full
    extra tile when this axis divides and the other does not."""
    both = (valid % grid == 0) & other_divides
    return (valid + torch.where(both, 0, grid - valid % grid)) // grid


@pytest.mark.parametrize("other_divides", [True, False])
@pytest.mark.parametrize("grid", range(1, 17))
def test_cells_partition_every_size(grid, other_divides):
    h = torch.arange(1, 1025)
    ts = _tile_size(h, grid, torch.tensor(other_divides))
    inv = (1.0 / ts.double()).float()          # clahe_u8_masked_plain's axis
    firsts = torch.stack([first_at_least(k, h, ts, inv)
                          for k in range(-1, grid + 1)], 1)
    assert (firsts[:, 0] == 0).all() and (firsts[:, -1] == h).all()
    assert (firsts[:, 1:] >= firsts[:, :-1]).all()
    y = torch.arange(1024)
    inside = y[None, :] < h[:, None]
    raw = _raw(y[None, :].expand(1024, -1), inv[:, None])
    # the cell that owns row y: -1 + the number of cells 0..grid-1 starting
    # at or before it
    cell = (firsts[:, 1:-1, None] <= y[None, None, :]).sum(1) - 1
    assert torch.equal(cell[inside], raw[inside])


# ---- the kernel's whole work, CTA by CTA

def _source_index(i, valid, n, masked):
    if masked:
        r = np.where(i < valid, i, 2 * valid - 2 - i)
        return np.clip(r, 0, n - 1)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = i % period
    return np.where(i >= n, period - i, i)


def _first(k, valid, ts, inv):
    return int(first_at_least(torch.tensor(k), torch.tensor(valid),
                              torch.tensor(ts), torch.tensor(inv)))


def _zero(out, writes, flat_lo, flat_hi):
    out.reshape(-1)[flat_lo:flat_hi] = 0
    writes.reshape(-1)[flat_lo:flat_hi] += 1


def _emulate(img, hw, clip, grid):
    """csrc/clahe.cu's clahe_kernel on numpy arrays: (out, writes)."""
    N, H, W = img.shape
    V = 16 if W % 16 == 0 else 4 if W % 4 == 0 else 1
    masked = hw is not None
    ty = tx = grid
    ncells = (ty + 1) * (tx + 1)
    out = np.full(img.shape, 77, np.uint8)
    writes = np.zeros(img.shape, np.int64)
    f32 = np.float32
    for n in range(N):
        h, w = (min(int(hw[n, 0]), H), min(int(hw[n, 1]), W)) if masked \
            else (H, W)
        src, dst, wr = img[n], out[n], writes[n]
        for cell in range(ncells):
            a, b = cell // (tx + 1) - 1, cell % (tx + 1) - 1
            if masked:
                band = (H - h) * W
                _zero(dst, wr, h * W + band * cell // ncells,
                      h * W + band * (cell + 1) // ncells)
                for y in range(cell, h, ncells):
                    _zero(dst, wr, y * W + w, (y + 1) * W)
            both = h % ty == 0 and w % tx == 0
            th = (h + (0 if both else ty - h % ty)) // ty
            tw = (w + (0 if both else tx - w % tx)) // tx
            invy, invx = f32(1) / f32(th), f32(1) / f32(tw)
            y_lo, y_hi = _first(a, h, th, invy), _first(a + 1, h, th, invy)
            x_lo, x_hi = _first(b, w, tw, invx), _first(b + 1, w, tw, invx)
            if y_lo >= y_hi or x_lo >= x_hi:
                continue
            ty0, ty1 = min(max(a, 0), ty - 1), min(max(a + 1, 0), ty - 1)
            tx0, tx1 = min(max(b, 0), tx - 1), min(max(b + 1, 0), tx - 1)
            area = th * tw
            # histograms of the cell's tiles, in place and by reflection
            Y0, rows, ysplit = ty0 * th, (ty1 - ty0 + 1) * th, ty0 * th + th
            X0, X1, xsplit = tx0 * tw, (tx1 + 1) * tw, tx0 * tw + tw
            Xd = max(X0, min(X1, w))
            c0 = X0 & ~(V - 1)
            nch = -(-(Xd - c0) // V) if Xd > X0 else 0
            assert c0 + nch * V <= W          # whole chunks stay in the row
            py = np.arange(Y0, Y0 + rows)
            sy = _source_index(py, h, H, masked)
            px = np.concatenate([np.arange(X0, Xd), np.arange(Xd, X1)])
            sx = np.concatenate([np.arange(X0, Xd),
                                 _source_index(np.arange(Xd, X1), w, W,
                                               masked)])
            tile = 2 * (py >= ysplit)[:, None] + (px >= xsplit)[None, :]
            hist = np.zeros((4, 256), np.int64)
            np.add.at(hist, (tile, src[sy[:, None], sx[None, :]]), 1)
            if clip > 0:
                climit = (int(f32(clip) * f32(area) / f32(256)) if masked
                          else int(clip * area / 256.0))
                climit = max(climit, 1)
            else:
                climit = area
            cdf = _clip_histogram(torch.from_numpy(hist), climit).cumsum(
                -1).numpy().astype(f32)
            lut = np.clip(np.rint(cdf * (f32(255) / f32(area))), 0, 255)
            t12, t21 = int(tx1 != tx0), 2 * int(ty1 != ty0)
            # interpolation over whole V-byte chunks; stores only the cell's
            i0 = x_lo & ~(V - 1)
            assert i0 + -(-(x_hi - i0) // V) * V <= W
            ys = np.arange(y_lo, y_hi)
            xs = np.arange(x_lo, x_hi)
            fy = ys.astype(f32) * invy - f32(0.5)
            wy = (fy - np.floor(fy))[:, None]
            fx = xs.astype(f32) * invx - f32(0.5)
            wx = (fx - np.floor(fx))[None, :]
            omy, omx = f32(1) - wy, f32(1) - wx
            p = src[y_lo:y_hi, x_lo:x_hi]
            top = lut[0][p] * omx + lut[t12][p] * wx
            bot = lut[t21][p] * omx + lut[t21 + t12][p] * wx
            dst[y_lo:y_hi, x_lo:x_hi] = np.clip(np.rint(top * omy + bot * wy),
                                                0, 255).astype(np.uint8)
            wr[y_lo:y_hi, x_lo:x_hi] += 1
    return out, writes


def _smooth(shape, seed):
    rng = np.random.RandomState(seed)
    *lead, H, W = shape
    yy, xx = np.mgrid[:H, :W]
    base = (yy * 3 + xx * 5) % 61 + 90
    return np.clip(base + rng.randint(-25, 25, tuple(lead) + (H, W)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("shape,grid,clip", [
    ((2, 37, 53), 8, 1.0),      # V = 1
    ((1, 3, 5), 8, 1.0),        # the pad exceeds the image: cv2's full rule
    ((2, 32, 37), 8, 4.0),      # H divides, W does not: an extra tile row
    ((1, 24, 40), 4, 1.0),      # both divide; V = 4
    ((2, 20, 48), 4, 4.0),      # V = 16
    ((1, 64, 80), 8, 0.0),      # no clipping
])
def test_emulated_kernel_static_equals_plain(shape, grid, clip):
    img = _smooth(shape, 0)
    out, writes = _emulate(img, None, clip, grid)
    assert (writes == 1).all()
    want = clahe_u8_plain(torch.from_numpy(img), clip, grid).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("bucket,grid,clip", [
    ((40, 48), 8, 1.0), ((40, 48), 4, 4.0), ((37, 52), 8, 4.0),
    ((36, 37), 8, 1.0)])
def test_emulated_kernel_masked_equals_plain(bucket, grid, clip):
    H, W = bucket
    rects = [(H, W), (3, 5), (32, 37), (17, 29), (H - 1, 8)]
    rects = [(min(h, H), min(w, W)) for h, w in rects]
    img = _smooth((len(rects), H, W), 1)
    hw = np.asarray(rects, np.int32)
    out, writes = _emulate(img, hw, clip, grid)
    assert (writes == 1).all()
    want = clahe_u8_masked_plain(torch.from_numpy(img), torch.from_numpy(hw),
                                 clip, grid).numpy()
    np.testing.assert_array_equal(out, want)
