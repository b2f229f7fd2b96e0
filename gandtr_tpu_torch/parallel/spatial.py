"""Spatial sharding over torch.distributed (counterpart of the spatial half
of gandtr_tpu/parallel/mesh.py: `spatial_mesh`, `max_spatial_shards`).

The JAX package shards an image's rows over the `sp` axis of a 2-D
`("data", "sp")` mesh, and GSPMD adds the halo exchanges of the pads and
convolutions and the all-reduces of instance norm and GeM. In PyTorch
nothing adds them, so the layers do it themselves while a grid is active:

    sm = spatial_mesh(n_data, n_sp)      # parallel/mesh.py, on every rank
    y = spatial_apply(net, x, sm)        # shard, run, gather

Rank r sits at data row r // n_sp and spatial column r % n_sp. It holds
its data row's share of the batch (`mesh.global_batch_array`) and band s
(its column) of the image rows of an NHWC tensor, by `band_plan`: every
edge between two bands lies on a multiple of the net's total
downsampling D (`total_downsample`), each band but the last holds
ceil(H / n_sp / D) D rows and the last the rest. The edges then stay
aligned at every depth of the net, and the last band, which may turn odd
at some depth, sits at the image's true bottom edge, where a layer's own
floor or ceil rule is the whole image's. Under `with sharded(sm, D, H):`
every tensor a layer sees is such a band, and every size a layer is given
is the band's (HED's resize to its input size asks for the band's rows).
A layer that reads the input image whole takes the bands' rows from the
input's plan, which `sharded` holds (`input_rows`); one that needs them for
a map at depth asks the sp group (`band_rows`). The layers look the grid up through `active()` /
`banded()`, as BatchNorm looks up `mesh.active()`:

- `halo_rows` extends a band by rows of the ranks above and below (one
  batched isend / irecv with each neighbour); at the image's true top and
  bottom the rows come from the pad mode (zero, reflect, replicate) or,
  with mode None, there are none. It is an autograd Function: its backward
  sends each halo's gradient back to the rank that owns those rows, which
  adds it.
- `pad2d` takes its rows through `halo_rows` and tags the result with the
  rows it added (`halo_of`); a `Conv` that follows consumes them. A `Conv`
  with its own padding exchanges its halo itself; a stride s needs bands
  of a multiple of s rows, except the last, which takes the image's own
  bottom pad; dilation widens the halo. A transposed conv takes the rows
  below and crops its output band. ResNet's padded 3x3 max-pool takes a
  row from the band above and pads with -inf at the true edges only.
- instance norm, GeM and SPoC sum their statistics, and the band's count
  of positions, over the `sp` group with `mesh.all_reduce_sum`'s Function
  (`sp_sum`), and MAC takes the maximum (`sp_amax`, its gradient split
  among ties as torch.amax's), so their gradients reach every band;
  BatchNorm in training counts over the whole data x sp grid.
- HED's bilinear resize gathers the small score map's rows over `sp`
  (`gather_image_rows`) and applies its band's rows of the interpolation
  matrix; the multiscale resize gathers the input image's rows, resizes
  the whole image as one process does and keeps this band of the result
  under the new height's plan; CLAHE gathers the uint8 lightness, runs K1
  on the whole image and keeps the band; VGG16's K2 takes a band extended
  by a neighbour row at each inner edge (its own zero pad is the true
  edge's) and its output is cropped.
- K3 declines under a grid (ops/resblock.py::eligible): its instance-norm
  statistics cover only the rows it is given.

Every other layer that mixes rows or reads the whole image raises
`NotImplementedError` under a grid (`refuse`, ROADMAP A.6.6): masked
inputs and K4, blur-pool sampling, the U-Nets, R-MAC / Rpool, attention,
the edge filter, the geometric median, the nearest and masked resizes,
`GlobalLocalModule` and the grouping layers.

The JAX package's guards (`gandtr_tpu/parallel/mesh.py::spatial_mesh`)
are for two silent errors of XLA's partitioner. Hazard 1, its `fastconv`
rewrites partitioned wrongly, has no counterpart: the port has no
`fastconv`. Hazard 2, a shard thinner than a conv's halo, raises
`ValueError` here, as does a plan whose last band would hold less than a
row at the net's deepest map; `mesh.max_spatial_shards` (the JAX
package's rule) suggests an n_sp.

Backends: under gloo the ranks may share one card (tensors are staged
through the host, `mesh._collective`) or run on the CPU; under NCCL each
rank has its own card.
"""
import contextlib

import torch
import torch.distributed as dist
from torch import nn

from gandtr_tpu_torch.parallel import mesh

REFUSED = "under a row-sharded grid (ROADMAP A.6.6)"
_GUARD = ("; pick n_sp with parallel.mesh.max_spatial_shards(H, "
          "total_downsample, max_halo)")


class SpatialMesh:
    """A data x spatial grid over the process group: `n_data` rows of
    `n_sp` ranks. `sp_group` holds this rank's data row (the ranks that
    share its images), `data_group` its spatial column. Every rank builds
    every group, in the same order."""

    def __init__(self, n_data, n_sp):
        n_data, n_sp = int(n_data), int(n_sp)
        world = mesh.world_size()
        if n_data < 1 or n_sp < 1 or n_data * n_sp != world:
            raise ValueError(
                "a %d x %d data x spatial grid needs a process group of %d "
                "ranks, the world is %d" % (n_data, n_sp, n_data * n_sp,
                                            world))
        self.n_data, self.n_sp, self.world = n_data, n_sp, world
        self.rank = mesh.rank()
        self.data_index, self.sp_index = divmod(self.rank, n_sp)
        self.sp_group = self.data_group = None
        if mesh.is_initialized():
            sp_groups = [dist.new_group([d * n_sp + s for s in range(n_sp)])
                         for d in range(n_data)]
            data_groups = [dist.new_group([d * n_sp + s
                                           for d in range(n_data)])
                           for s in range(n_sp)]
            self.sp_group = sp_groups[self.data_index]
            self.data_group = data_groups[self.sp_index]

    @property
    def above(self):
        """The rank holding the band above, or None at the image's top."""
        return self.rank - 1 if self.sp_index > 0 else None

    @property
    def below(self):
        return self.rank + 1 if self.sp_index < self.n_sp - 1 else None


_ACTIVE = None
_DOWNSAMPLE = 1
_INPUT_ROWS = None


def active():
    """The active grid (`SpatialMesh`), or None."""
    return _ACTIVE


def banded():
    """The active grid where it cuts the rows (n_sp > 1), else None."""
    sm = _ACTIVE
    return sm if sm is not None and sm.n_sp > 1 else None


def downsample():
    """The total downsampling D of the net the active grid runs: what a
    band plan made inside it (a rescaled image's) aligns its edges to."""
    return _DOWNSAMPLE


def input_rows(x):
    """Each band's rows of the net's input, in sp order, from the plan
    `sharded` holds, for a layer that reads the input image whole (CLAHE,
    the multiscale resize); x is this rank's band of it."""
    sm, rows = banded(), _INPUT_ROWS
    if rows is None or x.shape[1] != rows[sm.sp_index]:
        raise ValueError(
            "a band of %d rows where the input's plan is %s: the input's "
            "layers run under sharded(sm, downsample, height)"
            % (x.shape[1], rows))
    return rows


@contextlib.contextmanager
def sharded(sm, downsample=1, height=None):
    """Run the layers under the grid `sm`, for a net of total downsampling
    `downsample` whose input has `height` rows (its band plan)."""
    global _ACTIVE, _DOWNSAMPLE, _INPUT_ROWS
    prev = _ACTIVE, _DOWNSAMPLE, _INPUT_ROWS
    _ACTIVE, _DOWNSAMPLE = sm, int(downsample)
    _INPUT_ROWS = None if height is None or sm.n_sp == 1 else [
        rows for _, rows in band_plan(height, sm.n_sp, downsample)]
    try:
        yield sm
    finally:
        _ACTIVE, _DOWNSAMPLE, _INPUT_ROWS = prev


def refuse(what):
    """Raise where `what` would run on a band under a row-sharded grid."""
    if banded() is not None:
        raise NotImplementedError("%s is not ported %s" % (what, REFUSED))


def check_rows(rows, need, what):
    """Hazard 2's guard: a band of `rows` rows against what a layer needs."""
    if rows < need:
        raise ValueError("%s needs bands of at least %d rows, this band has "
                         "%d%s" % (what, need, rows, _GUARD))


def check_divisible(rows, by, what):
    """A band of `rows` rows must split by `by`, unless it is the last band
    (`sm.below` None), which ends at the image's true bottom edge."""
    sm = banded()
    if rows % by and (sm is None or sm.below is not None):
        raise ValueError("%s needs bands of a multiple of %d rows, this band "
                         "has %d%s" % (what, by, rows, _GUARD))


# ---- point-to-point rows and the reductions over sp

def _p2p(sends, recvs, like):
    """Post every send ((tensor, rank)) and receive ((shape, rank)) at once
    and wait for all; the received tensors come back on `like`'s device.
    gloo takes host tensors (ranks that share a card stage through it)."""
    if not sends and not recvs:
        return []
    stage = like.device.type == "cuda" and dist.get_backend() != "nccl"
    ops, bufs = [], []
    for t, peer in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, peer))
    for shape, peer in recvs:
        b = torch.empty(shape, dtype=like.dtype,
                        device="cpu" if stage else like.device)
        ops.append(dist.P2POp(dist.irecv, b, peer))
        bufs.append(b)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(like.device) for b in bufs]


def _rows_shape(x, n):
    return (x.shape[0], n) + tuple(x.shape[2:])


class _HaloExchange(torch.autograd.Function):
    """(the `lo` rows above the band, the `hi` rows below it) from the
    neighbouring ranks; empty at the image's top and bottom. The backward
    sends each halo's gradient to its owner and adds what comes back."""

    @staticmethod
    def forward(ctx, x, lo, hi, sm):
        ctx.lo, ctx.hi, ctx.sm = lo, hi, sm
        sends, recvs = [], []
        if sm.above is not None and hi:
            sends.append((x[:, :hi], sm.above))
        if sm.below is not None and lo:
            sends.append((x[:, x.shape[1] - lo:], sm.below))
        if sm.above is not None and lo:
            recvs.append((_rows_shape(x, lo), sm.above))
        if sm.below is not None and hi:
            recvs.append((_rows_shape(x, hi), sm.below))
        got = iter(_p2p(sends, recvs, x))
        top = next(got) if sm.above is not None and lo else \
            x.new_empty(_rows_shape(x, 0))
        bottom = next(got) if sm.below is not None and hi else \
            x.new_empty(_rows_shape(x, 0))
        ctx.rows = x.shape[1]
        return top, bottom

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        lo, hi, sm, rows = ctx.lo, ctx.hi, ctx.sm, ctx.rows
        like = g_top if g_top is not None else g_bottom
        sends, recvs = [], []
        if sm.above is not None and lo:
            sends.append((g_top, sm.above))
        if sm.below is not None and hi:
            sends.append((g_bottom, sm.below))
        if sm.above is not None and hi:
            recvs.append((_rows_shape(like, hi), sm.above))
        if sm.below is not None and lo:
            recvs.append((_rows_shape(like, lo), sm.below))
        got = iter(_p2p(sends, recvs, like))
        grad = like.new_zeros(_rows_shape(like, rows))
        if sm.above is not None and hi:
            grad[:, :hi] += next(got)
        if sm.below is not None and lo:
            grad[:, rows - lo:] += next(got)
        return grad, None, None, None


_EDGE_MODES = {"zero": "zero", "constant": "zero", "reflect": "reflect",
               "refl": "reflect", "replicate": "replicate",
               "repl": "replicate", None: None}


def _edge_rows(x, lo, hi, mode):
    """The band with `lo` rows above and `hi` below made locally by the pad
    mode (models/layers.py's slices for reflect and replicate)."""
    from gandtr_tpu_torch.models.layers import _reflect_cat, _replicate_cat
    if not (lo or hi) or mode is None:
        return x
    if mode == "reflect":
        return _reflect_cat(x, lo, hi, 1)
    if mode == "replicate":
        return _replicate_cat(x, lo, hi, 1)
    return torch.cat([x.new_zeros(_rows_shape(x, lo)), x,
                      x.new_zeros(_rows_shape(x, hi))], 1)


def halo_rows(x, lo, hi, mode="zero", edge_hi=None):
    """The band x (N, rows, ...) extended by `lo` rows from the rank above
    and `hi` from the rank below. At the image's true top and bottom the
    rows are made by `mode` (zero, reflect, replicate), or left out with
    None; `edge_hi` rows at the true bottom where given (the image's own
    pad, where it differs from the rows a band reads below). Every rank
    of the group passes the same `lo` and `hi`. A band thinner than its
    halo raises ValueError (hazard 2)."""
    sm = banded()
    if sm is None or not (lo or hi or edge_hi):
        return x
    if mode not in _EDGE_MODES:
        raise NotImplementedError("pad mode %s" % mode)
    mode = _EDGE_MODES[mode]
    edge_hi = hi if edge_hi is None else edge_hi
    rows = x.shape[1]
    check_rows(rows, max(lo, hi, edge_hi if sm.below is None else 0)
               + (mode == "reflect"),
               "a halo of %d rows above and %d below (%s)" % (lo, hi, mode))
    top, bottom = _HaloExchange.apply(x, lo, hi, sm)
    x = _edge_rows(x, lo if sm.above is None else 0,
                   edge_hi if sm.below is None else 0, mode)
    return torch.cat([top, x, bottom], 1)


def max_pool_band(x, kernel, stride, padding):
    """F.max_pool2d(kernel, stride, padding) of the image whose band is the
    NHWC x: `padding` rows from the band above (the pad's -inf at the
    image's true top), the rows below that the band's last window reads
    (none for ResNet's 3x3 stride-2 pad-1 pool), and at the true bottom
    the image's own `padding` -inf rows, so the last band keeps the
    image's floor rule. Bands but the last must split by `stride`. The
    halo's gradient goes back to its owner (`halo_rows`)."""
    sm = banded()
    k, s, p = kernel, stride, padding
    check_divisible(x.shape[1], s, "a stride-%d max-pool" % s)
    x = halo_rows(x, p, max(k - p - s, 0), None)
    top = p if sm.above is None else 0
    bottom = p if sm.below is None else 0
    y = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                (p, p, top, bottom), value=float("-inf"))
    return torch.nn.functional.max_pool2d(y, k, s).permute(0, 2, 3, 1)


def tag_halo(x, lo, hi):
    """Mark x as a band with `lo` and `hi` halo rows already added (the
    output of a pad), for the conv that consumes it."""
    x.gandtr_halo = (int(lo), int(hi))
    return x


def halo_of(x):
    """(lo, hi): the halo rows a pad added to x, (0, 0) for a plain band."""
    return getattr(x, "gandtr_halo", (0, 0))


class _BandAmax(torch.autograd.Function):
    """The maximum over (H, W) of the image whose band is x, over a group.
    As torch.amax's, the gradient is split evenly among the tied positions
    of every band (a dead ReLU channel is a tie over the whole image); as
    `mesh.all_reduce_sum`'s, it is first summed over the group, since the
    grid's loss is the sum of its ranks' losses."""

    @staticmethod
    def forward(ctx, x, group):
        out = mesh._collective(dist.all_reduce, x.amax(dim=(1, 2)),
                               op=dist.ReduceOp.MAX, group=group)
        tied = x == out[:, None, None]
        count = mesh.all_reduce_(tied.sum(dim=(1, 2)).to(torch.float32),
                                 group)
        ctx.group = group
        ctx.save_for_backward(tied, count)
        return out

    @staticmethod
    def backward(ctx, grad):
        tied, count = ctx.saved_tensors
        grad = mesh.all_reduce_(grad.contiguous().clone(), ctx.group)
        share = (grad.float() / count).to(grad.dtype)
        return share[:, None, None] * tied, None


def sp_sum(x, sm=None):
    """Differentiable sum of x over the grid's sp group (this data row)."""
    sm = sm or banded()
    return mesh.all_reduce_sum(x, group=sm.sp_group)


def sp_amax(x, sm=None):
    """Differentiable maximum over (H, W) of the image whose band is the
    (N, rows, W, C) x: (N, C), the same on every rank of the sp group."""
    sm = sm or banded()
    return _BandAmax.apply(x, sm.sp_group)


def sp_mean(x, sm=None):
    """The mean over (H, W) of the image whose band is the float32 (N,
    rows, W, ...) x, keeping those dims: the band's sum and its count of
    positions summed over the sp group in one all-reduce (the bands may
    differ in rows)."""
    sm = sm or banded()
    total = x.sum(dim=(1, 2), keepdim=True)
    count = total.new_full(total.shape[:-1] + (1,), x.shape[1] * x.shape[2])
    total = sp_sum(torch.cat([total, count], -1), sm)
    return total[..., :-1] / total[..., -1:]


def spatial_moments(v, sm=None):
    """(mean, biased variance) over (H, W) of an (N, rows, W, C) float32
    band, each an all-reduced sum over the sp group: the two passes of
    instance norm."""
    mean = sp_mean(v, sm)
    return mean, sp_mean((v - mean) ** 2, sm)


def band_plan(H, n_sp, downsample=1):
    """[(first row, rows)] of the n_sp bands of an image of H rows: each
    band but the last holds ceil(H / n_sp / D) D rows (D the net's total
    downsampling), the last the rest, so that every edge between bands is
    a multiple of D rows and stays a whole row at every depth. Equal bands
    where n_sp D divides H. ValueError (hazard 2) where the last band would
    hold less than a row at the deepest map (fewer than D rows)."""
    D = int(downsample)
    step = -(-H // (n_sp * D)) * D
    last = H - (n_sp - 1) * step
    if last < D:
        raise ValueError(
            "%d image rows leave %d rows to the last of %d bands of %d, "
            "less than a row at a total downsampling of %d%s"
            % (H, last, n_sp, step, D, _GUARD))
    return [(s * step, step if s < n_sp - 1 else last) for s in range(n_sp)]


def band_rows(rows, sm=None):
    """Each band's count of rows, in sp order, where this rank's is `rows`:
    a list, or for a tuple of counts a list of lists (one all-reduce of a
    one-hot count for all)."""
    sm = sm or banded()
    many = isinstance(rows, (tuple, list))
    c = torch.zeros((len(rows) if many else 1, sm.n_sp), dtype=torch.int64)
    c[:, sm.sp_index] = torch.tensor(rows if many else [rows])
    c = mesh.all_reduce_(c, sm.sp_group).tolist()
    return c if many else c[0]


def gather_image_rows(x, sm=None, counts=None):
    """The whole image's rows (dim 1) from every band of the sp group, on
    each of its ranks: each band written into zeros at its offset and the
    sum all-reduced (exact: x + 0 = x). `counts` is each band's rows
    (asked of the group where not given). Differentiable: a band's
    gradient is the sum of every rank's gradient of its rows."""
    sm = sm or banded()
    counts = band_rows(x.shape[1], sm) if counts is None else counts
    s = sm.sp_index
    above, below = sum(counts[:s]), sum(counts[s + 1:])
    full = torch.cat([x.new_zeros(_rows_shape(x, above)), x,
                      x.new_zeros(_rows_shape(x, below))], 1)
    return mesh.all_reduce_sum(full, group=sm.sp_group)


def band_of(full, counts, sm=None):
    """This rank's band of a whole image (dim 1), the bands holding
    `counts` rows each."""
    sm = sm or banded()
    first = sum(counts[:sm.sp_index])
    return full[:, first:first + counts[sm.sp_index]]


# ---- placing and collecting data

def total_downsample(module):
    """The product of the strides of a net's strided convolutions and
    pools along its main path: the factor by which its deepest map is
    smaller than its input (4 for the ResNet generator, 16 for HED and
    VGG16, 32 for ResNet). A module's `side_branches` (the names of its
    children that run beside the main path at the same stride, as a
    Bottleneck's strided `downsample`) are not counted."""
    f = 1
    if isinstance(module, (nn.Conv2d, nn.MaxPool2d)):
        s = module.stride
        f *= s[0] if isinstance(s, tuple) else int(s)
    side = getattr(module, "side_branches", ())
    for name, child in module.named_children():
        if name not in side:
            f *= total_downsample(child)
    return f


def _module_of(net):
    """The nn.Module behind a module, a WrappedNet or a hub model."""
    for _ in range(3):
        if isinstance(net, nn.Module):
            return net
        net = getattr(net, "net", None) or getattr(net, "module", None)
    return None


def shard_spatial(x, sm, downsample=1):
    """This rank's batch rows (as `mesh.global_batch_array` gives them) and
    its band of image rows of an NHWC tensor, by `band_plan` for the net's
    total downsampling (ValueError where the plan breaks hazard 2)."""
    N, H = x.shape[0], x.shape[1]
    if N % sm.n_data:
        raise ValueError("batch %d does not divide over %d data rows"
                         % (N, sm.n_data))
    x = mesh.global_batch_array(x, sm.data_index, sm.n_data)
    if sm.n_sp == 1:
        return x
    plan = band_plan(H, sm.n_sp, downsample)
    return band_of(x, [rows for _, rows in plan], sm).contiguous()


def gather_spatial(y, sm):
    """The inverse of `shard_spatial` for an output: an image band's rows
    gathered over sp, then every data row's batch rows. A descriptor
    (N, D) is already the same on every rank of its data row. Returns the
    global output on every rank, without autograd."""
    y = y.detach()
    if y.dim() == 4 and sm.n_sp > 1:
        y = gather_image_rows(y, sm)
    if sm.n_data == 1:
        return y
    return mesh.gather_rows(y, group=sm.data_group)


def spatial_apply(net, x, sm, downsample=None):
    """`net(x)` on the global batch x (N, H, W, C), run on this rank's
    share and band under the grid and gathered (the JAX test's
    `device_put(P("data", "sp"))` and `jit`). `downsample` is the net's
    total downsampling (`total_downsample` of its module by default; give
    it for a plain function)."""
    if downsample is None:
        module = _module_of(net)
        downsample = total_downsample(module) if module is not None else 1
    band = shard_spatial(x, sm, downsample)
    with sharded(sm, downsample, x.shape[1]):
        y = net(band)
    return gather_spatial(y, sm)
