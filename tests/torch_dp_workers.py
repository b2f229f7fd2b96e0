"""Ranks of a gloo process group on the CPU for the port's data-parallel
tests (tests/test_torch_data_parallel*.py). The workers import only the
port, never JAX: `spawn(job, world, **args)` runs `JOBS[job](**args)` in
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


JOBS = {"gather": gather, "gan_steps": gan_steps, "gan_resume": gan_resume,
        "gan_knobs": gan_knobs,
        "finetune_step": finetune_step, "extract": extract}
