"""Valid-region mask propagation for padded-bucket forwards (counterpart of
gandtr_tpu/ops/maskprop.py), NHWC.

Images of different sizes share one zero-padded bucket buffer: each image
occupies the top-left (h, w) rectangle and the band outside it is zero at
the input of every spatial op. A conv with zero padding then sees, at the
valid border, exactly the zeros an exact-shape forward's own padding gives,
so the valid region equals the exact-shape result. The ops that break the
invariant (a bias or BatchNorm shift, instance norm, reflect padding, a
max-pool window across the border) have masked forms here.

A `MaskState` holds the rectangle sizes as two (N,) int64 tensors on the
device (never read on the host, so nothing synchronises) and materialises
an (N, H, W) {0, 1} mask only where a multiply needs one. Sizes follow
torch's floor rule `(in + 2p - k) // s + 1`. Where the caller padded the
batch on the host, the state also keeps the sizes there (`host_hw`), for
the ops that must slice each image (ops/resize.py::masked_scale_resize).
"""
import torch
import torch.nn.functional as F

from gandtr_tpu_torch.parallel import spatial


def sizes_from_mask(mask):
    """(N, H, W) top-left rectangle mask -> (h, w), each (N,) int64: row 0
    and column 0 of a non-empty rectangle always meet it."""
    valid = mask > 0
    return valid[:, :, 0].sum(dim=1), valid[:, 0, :].sum(dim=1)


def mask_from_sizes(hw, H, W, dtype=torch.float32):
    """(N, H, W) {0, 1} mask of the top-left (h, w) rectangles."""
    h, w = hw
    rows = torch.arange(H, device=h.device)[None, :] < h[:, None]
    cols = torch.arange(W, device=w.device)[None, :] < w[:, None]
    return (rows[:, :, None] & cols[:, None, :]).to(dtype)


class MaskState:
    """The valid rectangle of each image through a forward. Inactive (every
    method a no-op) when built from no mask."""

    def __init__(self, hw=None, host_hw=None):
        self.hw = hw
        self._host_hw = None if host_hw is None else \
            [(int(h), int(w)) for h, w in host_hw]
        self._cache = {}

    @classmethod
    def maybe(cls, mask, host_hw=None):
        """From an (N, H, W) mask tensor, or None; `host_hw`, the same sizes
        as N (h, w) pairs on the host, where the caller has them. A mask
        is refused under a row-sharded grid (parallel/spatial.py)."""
        if mask is not None:
            spatial.refuse("a masked (padded-bucket) input")
        return cls(None if mask is None else sizes_from_mask(mask), host_hw)

    def host_hw(self):
        """The sizes as a list of (h, w) ints, as the caller gave them."""
        if self._host_hw is None:
            raise ValueError(
                "this op slices each image and needs the rectangle sizes "
                "on the host: pass `host_hw` with the mask")
        return self._host_hw

    @property
    def active(self):
        return self.hw is not None

    def hw_tensor(self):
        """(N, 2) int32 (h, w): what the masked CLAHE kernel takes."""
        return torch.stack(self.hw, dim=1).to(torch.int32).contiguous()

    def mask(self, H, W, dtype=torch.float32):
        """(N, H, W) mask at one resolution (made once per state)."""
        key = (H, W, dtype)
        if key not in self._cache:
            self._cache[key] = mask_from_sizes(self.hw, H, W, dtype)
        return self._cache[key]

    def apply(self, x):
        """Re-zero the band of an (N, H, W, C) tensor."""
        if not self.active:
            return x
        return x * self.mask(x.shape[1], x.shape[2], x.dtype)[..., None]

    def downsample(self, kernel, stride, padding, dilation=1):
        """After a conv or pool window (torch floor sizes)."""
        if not self.active:
            return self
        keff = dilation * (kernel - 1) + 1
        return MaskState(tuple(
            ((s + 2 * padding - keff) // stride + 1).clamp(min=0)
            for s in self.hw))

    def upsample(self, factor=2):
        """After a 2x transposed conv (k3 s2 p1 op1): out = in * factor."""
        if not self.active:
            return self
        return MaskState(tuple(s * factor for s in self.hw))


def masked_max_pool(x, state, kernel, stride, padding=0):
    """Max pool of an (N, H, W, C) tensor that equals the exact-shape pool on
    the valid region: the band is the dtype's lowest value in the window
    (torch pads a max pool with -inf) and zero again after. Returns
    (pooled, new_state)."""
    xc = x.permute(0, 3, 1, 2)
    if state is None or not state.active:
        return F.max_pool2d(xc, kernel, stride, padding).permute(0, 2, 3, 1), \
            state
    m = state.mask(x.shape[1], x.shape[2], torch.bool)[:, None]
    low = torch.finfo(x.dtype).min
    out = F.max_pool2d(xc.masked_fill(~m, low), kernel, stride, padding)
    new = state.downsample(kernel, stride, padding)
    om = new.mask(out.shape[2], out.shape[3], torch.bool)[:, None]
    out = torch.where(om, out, torch.zeros((), dtype=out.dtype,
                                           device=out.device))
    return out.permute(0, 2, 3, 1), new


def masked_reflect_pad(x, state, pad):
    """Reflect-pad each (N, H, W, C) image at its own valid boundary: row
    -i reads row i, row h - 1 + i reads row h - 1 - i, gathered with per-image
    indices (clamped into the buffer; rows deep in the band read garbage that
    the following conv leaves outside the new valid rectangle). Returns
    (padded, state of the (h + 2 pad, w + 2 pad) rectangle)."""
    if state is None or not state.active:
        from gandtr_tpu_torch.models.layers import pad2d
        return pad2d(x, pad, "reflect"), state
    N, H, W, C = x.shape
    h, w = state.hw

    def reflect_idx(n_out, size):
        j = torch.arange(n_out, device=x.device)[None, :] - pad
        s = size[:, None]
        j = torch.where(j < 0, -j, j)
        j = torch.where(j >= s, 2 * s - 2 - j, j)
        return j.clamp(0, max(n_out - 2 * pad - 1, 0))

    ih = reflect_idx(H + 2 * pad, h)
    iw = reflect_idx(W + 2 * pad, w)
    out = x.gather(1, ih[:, :, None, None].expand(N, H + 2 * pad, W, C))
    out = out.gather(2, iw[:, None, :, None].expand(N, H + 2 * pad,
                                                     W + 2 * pad, C))
    return out, MaskState((h + 2 * pad, w + 2 * pad))


def masked_instance_norm(x, state, eps=1e-5):
    """Instance norm (affine=False) over each image's valid region, zero on
    the band. x: (N, H, W, C)."""
    if state is None or not state.active:
        from gandtr_tpu_torch.ops.norm import instance_norm
        return instance_norm(x, eps=eps)
    m = state.mask(x.shape[1], x.shape[2], x.dtype)[..., None]
    cnt = m.sum(dim=(1, 2), keepdim=True)
    mean = (x * m).sum(dim=(1, 2), keepdim=True) / cnt
    var = ((x - mean) ** 2 * m).sum(dim=(1, 2), keepdim=True) / cnt
    return (x - mean) * m * torch.rsqrt(var + eps)
