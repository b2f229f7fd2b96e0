"""Ranks of a gloo process group on the CPU for the port's data-parallel
and spatial tests (tests/test_torch_data_parallel*.py,
tests/test_torch_spatial*.py). The workers import only the port, never
JAX: `spawn(job, world, **args)` runs `JOBS[job](**args)` in
`world` processes started with torch.multiprocessing and returns each
rank's result. A failing rank fails the spawn."""
import copy
import os
import shutil
import socket
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, path, backend):
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        # gloo ranks share the first card, NCCL ranks take one each
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    job, args = torch.load(path, weights_only=False)
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=world)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = JOBS[job](**args)
        out["warnings"] = [str(w.message) for w in caught]
        torch.save(out, "%s.%d" % (path, rank))
    finally:
        dist.destroy_process_group()


def spawn(job, world=2, backend="gloo", **args):
    """[rank 0's result, rank 1's, ...] of JOBS[job](**args), the ranks
    joined by `backend` ("nccl": a card a rank)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "job.pt")
        torch.save((job, args), path)
        mp.spawn(_rank_main, args=(world, free_port(), path, backend),
                 nprocs=world, join=True)
        return [torch.load("%s.%d" % (path, r), weights_only=False)
                for r in range(world)]


def _states(models):
    return {name: {k: v.detach().cpu().clone() for k, v in
                   net.module.state_dict().items()}
            for name, net in models.items()}


def _load(models, weights):
    for name, sd in (weights or {}).items():
        models[name].module.load_state_dict(sd, strict=True)


def gan_steps(cfg, batches, weights=None, device="cpu"):
    """The GAN build of `cfg` on `device` (the CPU by default; each rank
    of a card test shares one card), `weights` loaded, one step a batch:
    each step's metrics and the last step's weights."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    exp = build_gan_experiment(copy.deepcopy(cfg), device=device)
    _load(exp["models"], weights)
    state, metrics, debug = exp["state"], [], None
    for X, Y in batches:
        state, m, debug = exp["step"](state, torch.from_numpy(X).to(device),
                                      torch.from_numpy(Y).to(device))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": _states(exp["models"]),
            "debug": {k: v.cpu().clone() for k, v in debug.items()},
            "pools": {k: p.state_dict() for k, p in state.pools.items()},
            "data_parallel": getattr(exp["step"], "gandtr_dp", False)}


def gan_knobs(cfg, batches, u8_batch, weights=None):
    """HED^N-GAN's knobs under the group: the teacher cache over the
    batches twice (misses, then hits) beside the plain step from the same
    weights, and the device scalecrop step on `u8_batch` (x_u8, x_hw,
    y_u8, y_hw); and `parallel: {devices: 1}` below the world size."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    out = {}
    plain_cfg, cache_cfg, dsc_cfg = (copy.deepcopy(cfg) for _ in range(3))
    plain_cfg.pop("data")
    cache_cfg.pop("data")
    cache_cfg["learning"]["training"]["epoch_iteration"][
        "cache_teacher_targets"] = {"max_items": 4}
    runs = {}
    for name, c in (("plain", plain_cfg), ("cache", cache_cfg)):
        exp = build_gan_experiment(c, device="cpu")
        _load(exp["models"], weights)
        state, metrics = exp["state"], []
        for _ in range(2):
            for X, Y in batches:
                args = (exp["step"].batch_to_args((X, Y)) if name == "cache"
                        else (torch.from_numpy(X), torch.from_numpy(Y)))
                state, m, _ = exp["step"](state, *args)
                metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (metrics, _states(exp["models"]))
        if name == "cache":
            out["hits_misses"] = (exp["step"].hits, exp["step"].misses)
            out["cache_parallel"] = getattr(exp["step"].internal_step,
                                            "gandtr_dp", False)
    out["plain"], out["cache"] = runs["plain"], runs["cache"]
    dsc_cfg["data"]["train"]["device_scalecrop"] = True
    exp = build_gan_experiment(dsc_cfg, device="cpu")
    _load(exp["models"], weights)
    _, m, _ = exp["step"](exp["state"], *(torch.from_numpy(a)
                                          for a in u8_batch))
    out["dsc"] = {k: float(v) for k, v in m.items()}
    out["dsc_parallel"] = getattr(exp["step"], "gandtr_dp", False)
    low = copy.deepcopy(plain_cfg)
    low["learning"]["training"]["parallel"] = {"devices": 1}
    try:
        build_gan_experiment(low, device="cpu")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def gan_resume(cfg, root):
    """The train stage's straight run in <root>/a and, from a copy of it
    after epoch 1 made by rank 0, the resumed run in <root>/b: rank 0
    returns both directories' epoch-2 files."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    exp = build_gan_experiment(copy.deepcopy(cfg), directory=a, device="cpu")

    def hook(state, epoch):
        if epoch == 1 and dist.get_rank() == 0:
            shutil.copytree(a, b, symlinks=True)
    exp["training"].state_hook = hook
    exp["training"].run(exp["state"])
    dist.barrier()
    probe = build_gan_experiment(copy.deepcopy(cfg), directory=b,
                                 device="cpu")
    state, start = probe["training"].resume_or_start(probe["state"])
    probe["training"].run(state, start_epoch=start)
    dist.barrier()
    out = {"start": start, "files": {}}
    if dist.get_rank() == 0:
        for d in (a, b):
            out["files"][d[-1]] = {
                name: torch.load(os.path.join(d, "epochs", name),
                                 weights_only=False)
                for name in sorted(os.listdir(os.path.join(d, "epochs")))
                if name.endswith("_02.ckpt") or name.endswith("_02.pkl")}
    return out


def finetune_step(params, batch, weights=None, db=None, images=None,
                  extract_batch=None):
    """The fine-tune build of `params` on the CPU, `weights` loaded, one
    step on `batch` (imgs_u8, hws, labels, pmask; None: no step): the
    loss, the embed's gradients (the global ones, as the optimizer stepped
    with them) and weights after the step; with `db`, the mining
    extraction's descriptors of every image first."""
    from gandtr_tpu_torch.scenarios import finetune_build
    if extract_batch:
        finetune_build.EXTRACT_BATCH = int(extract_batch)
    exp = finetune_build.build_finetune_experiment(
        copy.deepcopy(params), db=db, images=images, device="cpu")
    _load(exp["models"], weights)
    out = {"data_parallel": getattr(exp["step"], "gandtr_dp", False)}
    if db is not None:
        out["mined"] = exp["dataset"].extract_fn(range(len(images)))
    if batch is None:
        return out
    state, m = exp["step"](exp["state"], *(torch.from_numpy(
        np.ascontiguousarray(a)) for a in batch))
    embed = exp["models"]["embed"].module
    out.update(loss=float(m["total"]),
               grads={k: p.grad.clone() for k, p in embed.named_parameters()
                      if p.grad is not None},
               state=_states(exp["models"]))
    return out


def extract(params, weights, paths, image_size):
    """Eval extraction (validate_stage.build_eval, extract_vectors) of
    `paths` with the model's `weights`, for each of the `params` sections:
    a list of (D, N) descriptors."""
    from gandtr_tpu_torch.eval.retrieval import extract_vectors
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    vecs = []
    for p in params:
        setup = build_eval(copy.deepcopy(p), torch.device("cpu"))
        setup["model"].module.load_state_dict(weights, strict=True)
        vecs.append(extract_vectors(setup["extractor"], paths, image_size,
                                    setup["transform"]))
    return {"vecs": vecs}


def gather(n_items):
    """parallel/mesh.py's gathers on this rank's device: each rank's rows
    of an equal split (gather_rows) and of the strided split r, r + N, ...
    (gather_positions, unequal counts), where row i is (i, 2i, 3i)."""
    from gandtr_tpu_torch.parallel import mesh
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    world, r = mesh.world_size(), mesh.rank()
    scale = torch.tensor([1.0, 2.0, 3.0], device=dev)

    def rows(idx):
        return torch.tensor(idx, dtype=torch.float32, device=dev)[:, None] \
            * scale
    share = n_items // world
    equal = mesh.gather_rows(rows(list(range(r * share, (r + 1) * share))))
    positions = [mesh.strided_share(n_items, q) for q in range(world)]
    strided = mesh.gather_positions(rows(positions[r]), positions)
    return {"equal": equal.cpu(), "strided": strided.cpu(),
            "device": str(equal.device)}


class _ResNetMaxPool(torch.nn.Module):
    """ResNet's 3x3 stride-2 pad-1 max-pool as ResNetFeatures runs it:
    `spatial.max_pool_band` under a grid, F.max_pool2d otherwise."""

    def forward(self, x):
        from gandtr_tpu_torch.parallel import spatial
        if spatial.banded() is not None:
            return spatial.max_pool_band(x, 3, 2, 1)
        return torch.nn.functional.max_pool2d(
            x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def spatial_op(kind, spec):
    """The op of a spatial case, built the same way on the ranks and for
    the unsharded reference: `spec` holds a layer's constructor arguments
    and state, a pooling's name or a resize factor."""
    from gandtr_tpu_torch.models import hed, layers
    from gandtr_tpu_torch.ops import norm, pooling, resize

    def built(cls, args, state):
        m = cls(**args)
        m.load_state_dict(state)
        return m
    if kind == "conv":
        return built(layers.Conv, spec["args"], spec["state"]).eval()
    if kind == "pad_conv":
        return torch.nn.Sequential(
            layers.Pad(spec["pad"], spec["mode"]),
            built(layers.Conv, spec["args"], spec["state"])).eval()
    if kind == "convt":
        return built(layers.ConvTranspose, spec["args"], spec["state"]).eval()
    if kind == "instance_norm":
        return norm.instance_norm
    if kind in ("gem", "mac", "spoc"):
        return pooling.POOLINGS[kind]
    if kind == "resize":
        f = spec["factor"]
        return lambda x: resize.bilinear_resize(
            x, int(x.shape[1] * f), int(x.shape[2] * f))
    if kind == "scale_resize":
        return lambda x: resize.scale_resize(x, spec["factor"])
    if kind == "hed_resize":
        # HED's side output: a 2x2 max-pool, resized to its input's rows
        return lambda x: resize.bilinear_resize(hed.MaxPool()(x),
                                                x.shape[1], x.shape[2])
    if kind == "roundtrip":
        return lambda x: x
    if kind == "stem":
        return torch.nn.Sequential(
            built(layers.Conv, {"in_channels": 3, "features": 4,
                                "kernel_size": 7, "stride": 2, "padding": 3,
                                "use_bias": False}, spec["state"][0]),
            torch.nn.ReLU(), _ResNetMaxPool())
    if kind == "stack":
        return torch.nn.Sequential(
            layers.Pad(1, "reflect"),
            built(layers.Conv, {"in_channels": 3, "features": 4,
                                "kernel_size": 3}, spec["state"][0]),
            layers.InstanceNorm(), torch.nn.ReLU(),
            built(layers.Conv, {"in_channels": 4, "features": 4,
                                "kernel_size": 3, "stride": 2, "padding": 1,
                                "pad_mode": "replicate"}, spec["state"][1]),
            built(layers.BatchNorm, {"num_features": 4}, spec["state"][2]),
            torch.nn.ReLU(),
            built(layers.ConvTranspose, {"in_channels": 4, "features": 3},
                  spec["state"][3]))
    raise KeyError(kind)


def spatial_primitives(cases, n_data, n_sp):
    """Each case (name, kind, spec, x) run on the global input x over an
    n_data x n_sp grid, its bands planned for `spec["downsample"]` (1 by
    default): {name: the gathered output}. A "halo" case gives this
    rank's band extended by `halo_rows`; a "pool_grad" case a global
    pooling and the gradient of sum(y * r) with respect to its input
    (gathered); a "stack" or "stem" case the net's output, the gradient
    of sum(y * r) with respect to the input (gathered) and to its weights
    (summed over the ranks), and a "stack"'s BatchNorm's running
    statistics after it; a "roundtrip" case the gathered band and this
    band's rows."""
    from gandtr_tpu_torch.parallel import mesh, spatial
    sm = mesh.spatial_mesh(n_data, n_sp)
    out = {"rank": (sm.data_index, sm.sp_index)}
    for name, kind, spec, x in cases:
        x = torch.from_numpy(x)
        if kind == "halo":
            band = spatial.shard_spatial(x, sm)
            with spatial.sharded(sm):
                out[name] = spatial.halo_rows(band, spec["lo"], spec["hi"],
                                              spec["mode"])
            continue
        if kind == "pool_grad":
            from gandtr_tpu_torch.ops import pooling
            band = spatial.shard_spatial(x, sm).requires_grad_(True)
            with spatial.sharded(sm):
                y = pooling.POOLINGS[spec["pool"]](band)
                # every rank's loss is 1 / n_sp of the image's
                ((y * torch.from_numpy(spec["r"])).sum() / n_sp).backward()
            out[name] = {"y": spatial.gather_spatial(y, sm),
                         "dx": spatial.gather_spatial(band.grad, sm)}
            continue
        down = spec.get("downsample", 1)
        if kind == "roundtrip":
            band = spatial.shard_spatial(x, sm, down)
            out[name] = {"y": spatial.gather_spatial(band, sm),
                         "rows": band.shape[1]}
            continue
        op = spatial_op(kind, spec)
        if kind not in ("stack", "stem"):
            with torch.no_grad():
                out[name] = spatial.spatial_apply(op, x, sm, downsample=down)
            continue
        band = spatial.shard_spatial(x, sm, down).requires_grad_(True)
        with spatial.sharded(sm, down, x.shape[1]):
            y = op(band)
            r = mesh.global_batch_array(torch.from_numpy(spec["r"]),
                                        sm.data_index, sm.n_data)
            r = spatial.band_of(r, spatial.band_rows(y.shape[1], sm), sm)
            (y * r).sum().backward()
        params = list(op.parameters())
        mesh.all_reduce_grads(params)
        out[name] = {"y": spatial.gather_spatial(y, sm),
                     "dx": spatial.gather_spatial(band.grad, sm),
                     "dw": [p.grad.clone() for p in params]}
        if kind == "stack":
            out[name]["stats"] = {k: v.clone() for k, v in
                                  op[5].state_dict().items()}
    return out


def spatial_net(cfg, state, dtype, device="cpu"):
    """The callable a spatial net case runs, the same on the ranks and for
    the unsharded reference: a model config with its state dict, in eval
    mode (in bf16 for dtype "bfloat16"), or `{"hub": name, "lw": {P, m}}`,
    the hub's descriptor model with an Lw (single-scale, or with
    "multiscale": True the hub's scales), its module's weights `state`
    where given, on uint8 photos through its device preprocessing (LAB
    CLAHE, normalize) as a served batch runs it, or with "pre": False on
    float inputs as they are. "resnet_depth" sets the port's ResNet-101
    blocks a stage (backbones.RESNET_LAYERS) in this process. The
    callable's `downsample` is its net's total downsampling."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.data.transforms import split_device_transform
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.models import backbones, initialize_model
    from gandtr_tpu_torch.parallel import spatial
    set_float32_policy()      # float32 convs in float32 (no TF32), as hub's
    if "hub" in cfg:
        if cfg.get("resnet_depth"):
            backbones.RESNET_LAYERS["resnet101"] = tuple(cfg["resnet_depth"])
        kw = {} if "resnet" in cfg["hub"] else {
            "multiscale": cfg.get("multiscale", False)}
        model = getattr(hub, cfg["hub"])(pretrained=False, device=device,
                                         whitening=cfg["lw"], **kw)
        if state is not None:
            model.net.module.load_state_dict(state, strict=True)
        if dtype == "bfloat16":
            model.net.compute_dtype = torch.bfloat16
        _, pre = split_device_transform(model.net.data_params["transforms"],
                                        model.net.data_params["mean_std"])
        ctx = {"msp": model.meta.get("msp", 1.0)}   # as HubModel passes

        def fn(x):
            x = pre(x.float() / 255.0) if cfg.get("pre", True) else x
            return model.net.apply(x, ctx=ctx)
        fn.downsample = spatial.total_downsample(model.net.module)
        return fn
    net = initialize_model(dict(cfg))
    net.load_state_dict(state, strict=True)
    net = net.to(device).eval()
    if dtype == "bfloat16":
        net = net.to(torch.bfloat16)
        return lambda x: net(x.to(torch.bfloat16))
    return net


def spatial_nets(cases, device="cpu"):
    """Each case (name, config, state dict, x, (n_data, n_sp), dtype)
    through `spatial_apply` on its grid (`spatial_net`): {name: the
    gathered float32 output}, and under "k3_calls" the fused ResNet
    block's calls in each case (K3 declines under a grid). `device`
    "cuda" runs on this rank's card (NCCL)."""
    from gandtr_tpu_torch.ops import resblock
    from gandtr_tpu_torch.parallel import mesh, spatial
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    out, calls, meshes = {"k3_calls": {}}, [0], {}
    fused = resblock.fused_resblock

    def counted(*args, **kwargs):
        calls[0] += 1
        return fused(*args, **kwargs)
    resblock.fused_resblock = counted
    try:
        for name, cfg, state, x, grid, dtype in cases:
            sm = meshes.get(grid) or meshes.setdefault(
                grid, mesh.spatial_mesh(*grid))
            fn = spatial_net(cfg, state, dtype, device)
            calls[0] = 0
            with torch.inference_mode():
                out[name] = spatial.spatial_apply(
                    fn, torch.from_numpy(x).to(device), sm,
                    downsample=getattr(fn, "downsample", None)).float().cpu()
            out["k3_calls"][name] = calls[0]
    finally:
        resblock.fused_resblock = fused
    return out


JOBS = {"gather": gather, "gan_steps": gan_steps, "gan_resume": gan_resume,
        "gan_knobs": gan_knobs,
        "finetune_step": finetune_step, "extract": extract,
        "spatial_primitives": spatial_primitives,
        "spatial_nets": spatial_nets}
