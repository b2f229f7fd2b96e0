"""Data parallelism over torch.distributed (counterpart of
gandtr_tpu/parallel/mesh.py).

The JAX package runs a step with GSPMD over a 1-D `data` mesh: the batch
is sharded, the state replicated, and the step computes exactly what the
single-device step computes on the global batch. Here that is one process
a card, started by

    torchrun --nproc-per-node N -m gandtr_tpu_torch.scenarios.run <target> ...

with NCCL between cards and gloo for CPU tensors. Without `WORLD_SIZE` in
the environment there is no process group, and every step is the single
process's.

Under a group, `data_parallel_step` wraps a step so that it holds the
global-batch semantics:

- every rank is handed the whole global batch (each runs the same loader
  with the same seed, so every random draw is the single process's) and
  takes rows [r B/N, (r+1) B/N) of it (`global_batch_array`);
- each optimizer's step all-reduces (SUM) the gradients of its
  parameters first (`all_reduce_grads`, a pre-step hook that
  `attach_optimizers` sets); a step whose losses are means over the batch
  scales them by B_local / B, one whose loss sums over the batch (the
  fine-tune's contrastive loss over tuples) does not: the gradient is the
  gradient of the global loss, where DistributedDataParallel's averaging
  would divide a summed loss by N;
- BatchNorm in training mode normalizes by the global batch's statistics
  (`models/layers.py::BatchNorm` asks `active()`), with an all-reduce that
  autograd differentiates;
- the metrics come back as the global batch's (each a mean over the batch
  rows), the debug images as the last row of the global batch (the last
  rank's), and the maps a step emits for the teacher cache (`target_M`)
  gathered whole;
- a step that needs the global batch of one of its values (the GAN image
  pool, CUT's negatives) gathers it with `gather_rows`.

The collectives are all-reduces, broadcasts and (under NCCL) all-gathers,
on CUDA tensors under NCCL and on host tensors under gloo (`_collective`
stages a tensor on the other side where needed: gloo runs two ranks on
one card).
"""
import contextlib
import os
import warnings

import torch
import torch.distributed as dist


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def rank():
    return dist.get_rank() if is_initialized() else 0


def is_writer():
    """Rank 0 alone writes checkpoints, events, reports and images."""
    return rank() == 0


def init_distributed():
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Returns this rank's device:
    `cuda:LOCAL_RANK` (pinned as the current device, NCCL) where a card is
    present, else the CPU (gloo). Does nothing at world size 1 and returns
    None, as the JAX package's does."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local)
    if not is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo",
                                rank=int(os.environ.get("RANK", "0")),
                                world_size=world)
    return torch.device("cuda", local) if cuda else torch.device("cpu")


def process_local_batch(global_batch):
    """This process's share of a global batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError("batch %d does not divide over %d processes"
                         % (global_batch, n))
    return global_batch // n


def local_rows(n_global, r=None, n=None):
    """(lo, hi): rank r's rows of an evenly split global batch."""
    r = rank() if r is None else r
    n = world_size() if n is None else n
    share = n_global // n
    return r * share, (r + 1) * share


def global_batch_array(batch, r=None, n=None):
    """This rank's rows of the global batch (the JAX function assembles the
    global array from each process's rows; here each rank keeps its
    own)."""
    lo, hi = local_rows(batch.shape[0], r, n)
    return batch[lo:hi]


def _collective(fn, t, *args, **kwargs):
    """Run an in-place collective on `t`. NCCL takes CUDA tensors only, so
    a CPU tensor goes to the current card and back; for gloo a CUDA tensor
    goes through the host (ranks that share one card, as the tests and
    the smoke run them)."""
    cuda = t.device.type == "cuda"
    if cuda == (dist.get_backend() == "nccl"):
        fn(t, *args, **kwargs)
        return t
    tmp = t.cpu() if cuda else t.cuda()
    fn(tmp, *args, **kwargs)
    t.copy_(tmp)
    return t


def all_reduce_(t):
    """Sum `t` over the ranks, in place."""
    return _collective(dist.all_reduce, t)


def broadcast_(t, src=0):
    return _collective(dist.broadcast, t, src=src)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the sum over the ranks of the
    gradients: the global statistics of a synchronized BatchNorm."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone())


def all_reduce_sum(x):
    """Differentiable sum of `x` over the ranks."""
    return _AllReduceSum.apply(x)


def gather_rows(x, counts=None):
    """The rows of every rank stacked in rank order, on every rank, without
    autograd. `counts` is each rank's number of rows (all equal when not
    given). Under NCCL an all-gather of each rank's rows padded to the
    largest count; under gloo (which may hold CUDA tensors of ranks that
    share a card) an all-reduce: each rank writes its rows into a zero
    buffer and the sum is exact (x + 0 = x)."""
    n, r = world_size(), rank()
    counts = [x.shape[0]] * n if counts is None else list(counts)
    if x.device.type == "cuda" and dist.get_backend() == "nccl":
        m = max(counts)
        mine = x.detach()
        if mine.shape[0] < m:
            mine = torch.cat([mine, mine.new_zeros(
                (m - mine.shape[0],) + tuple(mine.shape[1:]))])
        out = mine.new_empty((n * m,) + tuple(mine.shape[1:]))
        dist.all_gather_into_tensor(out, mine.contiguous())
        if all(c == m for c in counts):
            return out
        return torch.cat([out[i * m:i * m + c] for i, c in enumerate(counts)])
    offsets = [sum(counts[:i]) for i in range(n + 1)]
    out = x.new_zeros((offsets[-1],) + tuple(x.shape[1:]))
    out[offsets[r]:offsets[r + 1]] = x.detach()
    return all_reduce_(out)


def strided_share(n_items, r=None, n=None):
    """Rank r's items of n_items: r, r + N, r + 2N, ..."""
    r = rank() if r is None else r
    n = world_size() if n is None else n
    return list(range(r, n_items, n))


def gather_positions(x, positions):
    """Rows owned rank by rank back into one tensor in input order, on
    every rank. `positions[r]` lists the input positions of rank r's rows
    (every rank passes the same lists); `x` is this rank's rows in that
    order. A rank without rows passes a (0, ...) tensor; the trailing shape
    is agreed on with a MAX all-reduce."""
    counts = [len(p) for p in positions]
    shape = torch.zeros(8, dtype=torch.int64)
    shape[:x.dim() - 1] = torch.tensor(x.shape[1:], dtype=torch.int64)
    _collective(dist.all_reduce, shape, op=dist.ReduceOp.MAX)
    tail = tuple(int(v) for v in shape[:x.dim() - 1])
    if x.shape[0] == 0:
        x = x.new_zeros((0,) + tail)
    rows = gather_rows(x, counts)
    order = torch.as_tensor([i for p in positions for i in p],
                            dtype=torch.long, device=rows.device)
    out = torch.empty_like(rows)
    out[order] = rows
    return out


def replicate_tree(*trees):
    """Broadcast from rank 0, in place, every tensor of the given modules,
    optimizers, training states (their nets and optimizers), dicts and
    lists: parameters and buffers, and an optimizer's
    state (Adam's moments and step counts). Every rank must hold the same
    structure (the same build, or the same files loaded)."""
    if world_size() <= 1:
        return
    for t in _tensors(trees):
        with torch.no_grad():
            broadcast_(t, 0)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        for t in tree.state_dict(keep_vars=True).values():
            yield t.data
    elif isinstance(tree, torch.optim.Optimizer):
        for group in tree.param_groups:
            for p in group["params"]:
                for k in sorted(tree.state.get(p, {})):
                    v = tree.state[p][k]
                    if isinstance(v, torch.Tensor):
                        yield v
    elif isinstance(getattr(tree, "models", None), dict):
        # a training state: its nets and its optimizer(s)
        yield from _tensors(tree.models)
        yield from _tensors(getattr(tree, "optimizers", None)
                            or getattr(tree, "optimizer", None))
    elif hasattr(tree, "optimizer") and isinstance(
            getattr(tree, "optimizer"), torch.optim.Optimizer):
        yield from _tensors(tree.optimizer)      # an AlternationGate
    elif isinstance(tree, dict):
        for k in tree:
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "module") and isinstance(tree.module,
                                                torch.nn.Module):
        yield from _tensors(tree.module)         # a WrappedNet


class _Active:
    """The data-parallel step being run: this rank, the world, the rows of
    the global batch it holds, and what it synchronizes."""

    def __init__(self, n_global, grad_reduction, sync_batchnorm):
        self.rank, self.world = rank(), world_size()
        self.lo, self.hi = local_rows(n_global, self.rank, self.world)
        self.row_share = (self.hi - self.lo) / n_global
        self.grad_share = self.row_share if grad_reduction == "mean" \
            else 1.0
        self.sync_batchnorm = sync_batchnorm

    def local(self, x):
        """This rank's rows of a global-batch tensor."""
        return x[self.lo:self.hi]


_ACTIVE = None


def active():
    """The running data-parallel step (`_Active`), or None."""
    return _ACTIVE


@contextlib.contextmanager
def _activate(ctx):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def all_reduce_grads(params, scale=1.0):
    """Sum the gradients of `params` over the ranks (one flat buffer a
    dtype and device), times `scale`. A parameter without a gradient has
    none on every rank (the ranks run the same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    groups = {}
    for g in grads:
        groups.setdefault((g.dtype, g.device), []).append(g)
    for gs in groups.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce_(flat)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _torch_optimizer(opt):
    return opt if isinstance(opt, torch.optim.Optimizer) else opt.optimizer


def attach_optimizers(optimizers):
    """Give each optimizer (a torch optimizer or an AlternationGate) the
    pre-step hook that all-reduces its gradients while a data-parallel step
    runs; outside one the hook does nothing."""
    def hook(opt, args, kwargs):
        ctx = active()
        if ctx is not None:
            all_reduce_grads([p for g in opt.param_groups
                              for p in g["params"]], ctx.grad_share)
    for opt in optimizers:
        _torch_optimizer(opt).register_step_pre_hook(hook)


def data_parallel_step(step_fn, grad_reduction="mean", sync_batchnorm=True):
    """Wrap a `(state, *batches) -> (state, metrics[, debug])` step for the
    process group: each batch argument is the global batch on its leading
    axis and the step runs on this rank's rows. `grad_reduction` is how
    the step's loss reduces over the batch: "mean" (the GAN losses) scales
    the summed gradients by B_local / B, "sum" (the fine-tune's loss over
    tuples) leaves the sum.
    The optimizers must be attached (`attach_optimizers`). The metrics
    come back as the global batch's; the debug dict as the module
    docstring says. A batch that does not divide over the ranks (a
    loader's short last batch) warns as `maybe_data_parallel` does, and
    every rank runs the whole step on it. Marked `gandtr_dp`, as the JAX
    package marks it."""
    def wrapped(state, *args):
        n_global, world = args[0].shape[0], world_size()
        if n_global % world:
            # a short last batch: every rank runs the whole step on the
            # same rows (deterministic, so the replicas stay equal), where
            # the JAX package's sharding raises
            warnings.warn("data-parallel disabled: batch %d not divisible "
                          "by %d devices" % (n_global, world))
            return step_fn(state, *args)
        ctx = _Active(n_global, grad_reduction, sync_batchnorm)
        with _activate(ctx):
            out = step_fn(state, *(ctx.local(a) for a in args))
        state, metrics = out[0], out[1]
        metrics = _global_metrics(metrics, ctx.row_share)
        if len(out) == 2:
            return state, metrics
        return state, metrics, _global_debug(out[2], ctx)

    wrapped.gandtr_dp = True  # the builds gate dispatch_chunk off this
    if hasattr(step_fn, "stage"):      # the device scalecrop's device half
        wrapped.stage = step_fn.stage
    return wrapped


def _global_metrics(metrics, row_share):
    """Each metric is a mean over the batch rows: the global value is the
    sum over the ranks of each rank's value times its share of the rows."""
    keys = list(metrics)
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys]) * row_share
    all_reduce_(vals)
    return {k: vals[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def _global_debug(debug, ctx):
    """The debug images of the global batch's last row (the last rank's),
    and `target_M` gathered whole."""
    out = {}
    for k, v in debug.items():
        if k == "target_M":
            out[k] = gather_rows(v)
        else:
            out[k] = broadcast_(v.detach().contiguous().clone(),
                                ctx.world - 1)
    return out


def maybe_data_parallel(step, par_cfg, batch_size, grad_reduction="mean",
                        sync_batchnorm=True):
    """The counterpart of the JAX builds' `_maybe_data_parallel`: the step
    as it is without a process group or with `parallel: false`; else the
    data-parallel step over the group. `parallel: {devices: N}` takes
    min(N, world size), as JAX takes min(N, visible devices); an N below
    the world size raises (each rank is one card of the run). A batch that
    does not divide over the ranks warns with the JAX package's text, and
    every rank then runs the whole step."""
    if par_cfg in (False, None) or not is_initialized():
        return step
    world = world_size()
    n_req = int(par_cfg.get("devices", 0) or 0) \
        if isinstance(par_cfg, dict) else 0
    n_dev = min(n_req, world) if n_req else world
    if n_dev < world:
        raise ValueError(
            "parallel: {devices: %d} is below the process group's world size "
            "%d: start as many processes as cards to use" % (n_req, world))
    if batch_size and batch_size % n_dev:
        warnings.warn("data-parallel disabled: batch %d not divisible by %d "
                      "devices" % (batch_size, n_dev))
        return step
    return data_parallel_step(step, grad_reduction=grad_reduction,
                              sync_batchnorm=sync_batchnorm)


def spatial_mesh(*args, **kwargs):
    """The JAX package's data x spatial mesh shards the image axes of the
    convolutions (GSPMD inserts the halo exchanges). Not ported: in
    PyTorch every conv would need a halo exchange, and no stage runs it
    (only the JAX package's tests do)."""
    raise NotImplementedError("spatial sharding is not ported yet "
                              "(ROADMAP A.6.5)")


def max_spatial_shards(image_hw, total_downsample, max_halo=2):
    """Largest spatial shard count that keeps every layer's shard at least
    as wide as its conv halo: the deepest feature map has
    image_hw / total_downsample rows, and each shard must hold >= max_halo
    of them; the count must divide image_hw. At least 1."""
    deepest = image_hw // total_downsample
    n = max(deepest // max_halo, 1)
    while n > 1 and image_hw % n:
        n -= 1
    return n
