"""The export stage (counterpart of gandtr_tpu/scenarios/export_stage.py):
a trained network as a serving artifact directory that
`serving.load_artifact` loads (serving/export.py), for the stage's device.

The network section is the infer stage's, eval.yml's wrapper form
(`runtime.wrappers.eval`, an Lw pickle by path) included, and a multiscale
wrapper aggregates with the infer stage's power (GeM's p), so an artifact
answers the descriptors that build_index puts in an index. (The JAX
package's stage exports a multiscale net with power 1; ROADMAP C.)

Config::

    export_serving:
      __function__: gandtr_tpu.stages.export
      network: {model: {...}, path: <checkpoint>}     # infer-stage loader
      export:
        directory: <artifact dir>
        image_hw: [256, 256]
        batch_buckets: [1, 4, 8]       # default
        from_uint8: true               # device preprocessing inside
        with_mask: false               # masked-GeM aspect-preserving input
        kind: null                     # override embedding/generator
"""
from gandtr_tpu_torch.utils.io import resolve_path


def export(params, data, device=None):
    """Returns ({"directory", "kind", "batch_buckets", "image_hw"},). Runs
    on cuda unless `device="cpu"`; the artifact runs on that device type."""
    from gandtr_tpu_torch.device import resolve_device
    from gandtr_tpu_torch.hub import HubModel
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    from gandtr_tpu_torch.serving.export import export_hub_model

    dev = resolve_device(device)
    params = dict(params)
    net_cfg = params.pop("network")
    cfg = dict(params.pop("export"))
    if params:
        raise ValueError("Unused export-stage params: %s" % sorted(params))

    directory = resolve_path(cfg.pop("directory"))
    image_hw = tuple(cfg.pop("image_hw"))
    # the network as the infer stage builds it (eval.yml's wrapper form
    # too), with its multiscale power
    setup = build_eval({"network": net_cfg}, dev)
    net = setup["model"]
    model = HubModel(net, transform=None, device=dev,
                     meta={**(net.meta or {}), "msp": setup["ctx"]["msp"]})
    meta = export_hub_model(
        model, directory, image_hw,
        batch_buckets=tuple(cfg.pop("batch_buckets", (1, 4, 8))),
        from_uint8=bool(cfg.pop("from_uint8", True)),
        with_mask=bool(cfg.pop("with_mask", False)),
        platforms=cfg.pop("platforms", None),
        kind=cfg.pop("kind", None))
    if cfg:
        raise ValueError("Unused export params: %s" % sorted(cfg))
    return ({"directory": directory, "kind": meta["kind"],
             "batch_buckets": meta["batch_buckets"],
             "image_hw": meta["image_hw"]},)
