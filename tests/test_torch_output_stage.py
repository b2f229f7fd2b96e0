"""The infer stage's image output (scenarios/infer_stage.py::infer and
::RgbImageSaver; the `output` target, parameters/output_gan.yml) against
the JAX package's, on the CPU.

- The saver alone writes the JAX RgbImageSaver's files byte for byte:
  flat and input names, the append skip, each `stretch_by` (with the
  float64 truncation ties of "meanstd"), and the LAB undo.
- `infer` with the image output runs seeded micro generators (ngf 4, one
  block; instance and batch norm) and a micro HED through `forward`;
  their files have the JAX `infer`'s names and are within one uint8 level
  of its images. Both load the same reference-format .pth.
- `data.device_postprocess: true` writes the JAX opt-in path's PNGs, but
  for one level at a truncation tie, and stays within one level of the
  host sink.
- The repaired nested `data.test` form gives the JAX `infer`'s
  descriptors, as does the flat form, with relative names under
  $GANDTR_ROOT.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.scenarios import infer_stage as jinfer
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.scenarios import infer_stage as tinfer

torch.set_num_threads(1)

GAN = [[0.5] * 3, [0.5] * 3]
IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
SHAPES = [(20, 28), (28, 20), (20, 28), (24, 24), (20, 28)]
POST_TIE = 1e-3   # device_postprocess: a level this near is a tie


def _files(directory):
    out = {}
    for dirpath, _, files in os.walk(directory):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, directory)] = fh.read()
    return out


def _ties(rs, n=16):
    """Normalized values whose "meanstd" uint8 under IMNET's first channel
    differs between float32 and the reference's float64 arithmetic (a
    truncation tie)."""
    x = rs.uniform(-2, 2, 4000000).astype(np.float32)
    m, s = IMNET[0][0], IMNET[1][0]
    f64 = np.clip((x.astype(np.float64) * s + m) * 255, 0,
                  255).astype(np.uint8)
    f32 = np.clip((x * np.float32(s) + np.float32(m)) * np.float32(255),
                  0, 255).astype(np.uint8)
    ties = x[f64 != f32]
    assert ties.size >= n
    return ties[:n]


def _save_all(module, directory, images, **kwargs):
    sink = module.RgbImageSaver(directory, kwargs.pop("mean_std", GAN),
                                **kwargs)
    names = sink.exclude_existing(list(images))
    for name in names:
        sink.add(name, images[name])
    sink.close()
    return names


@pytest.mark.parametrize("stretch_by", ["meanstd", "auto", "none", 2])
@pytest.mark.parametrize("structure", [None, "flat", "input"])
def test_saver_files_equal_jax(tmp_path, stretch_by, structure):
    rs = np.random.RandomState(0)
    images = {"a/b/im0.png": rs.uniform(-1, 1, (9, 11, 3)),
              ("x/y.jpg", "z/w.png"): rs.uniform(-1, 1, (8, 8, 3)),
              "gray.png": rs.uniform(-1, 1, (6, 7, 1)),
              "ties.png": _ties(rs).reshape(4, 4, 1)}
    images = {k: v.astype(np.float32) for k, v in images.items()}
    for tag, module in (("port", tinfer), ("jax", jinfer)):
        _save_all(module, str(tmp_path / tag), images, mean_std=IMNET,
                  structure=structure, stretch_by=stretch_by)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 4
    assert got == want


def test_meanstd_keeps_the_float64_ties(tmp_path):
    """Written through the float64 promotion, the ties come out as the
    reference's values, not float32's."""
    x = _ties(np.random.RandomState(1)).reshape(4, 4, 1)
    sink = tinfer.RgbImageSaver(str(tmp_path), IMNET)
    m, s = IMNET[0][0], IMNET[1][0]
    f64 = np.clip((x[..., 0].astype(np.float64) * s + m) * 255, 0,
                  255).astype(np.uint8)
    f32 = np.clip((x[..., 0] * np.float32(s) + np.float32(m))
                  * np.float32(255), 0, 255).astype(np.uint8)
    assert np.array_equal(sink.to_uint8(x), f64)
    assert (f64 != f32).all()
    sink.close()


def test_flat_names_and_append_skip_as_jax(tmp_path):
    name = ("d1/a.jpg", "d2/b.c.jpg", "e/f.png")
    assert tinfer.RgbImageSaver.flat_name(name) == \
        jinfer.RgbImageSaver.flat_name(name) == "d1%a::d2%b.c::e%f.png"
    images = {"p.png": np.zeros((4, 4, 3), np.float32),
              "q/r.png": np.ones((4, 4, 3), np.float32)}
    for tag, module in (("port", tinfer), ("jax", jinfer)):
        d = str(tmp_path / tag)
        assert _save_all(module, d, images, append=True) == list(images)
        assert _save_all(module, d, images, append=True) == []
        assert _save_all(module, d, images, append=False) == list(images)


def test_lab_undo_equals_jax(tmp_path):
    """A `tolab` pipeline's normalized LAB outputs: denormalized, clipped,
    converted to RGB and saturated, byte-equal to the JAX sink."""
    rs = np.random.RandomState(2)
    lab_ms = [[50.0, 0.0, 0.0], [50.0, 128.0, 128.0]]
    images = {"l%d.png" % i: rs.uniform(-1.3, 1.3, (10, 12, 3))
              .astype(np.float32) for i in range(3)}
    for tag, module in (("port", tinfer), ("jax", jinfer)):
        _save_all(module, str(tmp_path / tag), images, mean_std=lab_ms,
                  transforms="pil2np | tolab | totensor | normalize",
                  stretch_by="auto")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("transforms,match", [
    ("pil2np | toluv | totensor | normalize", "5.3"),
    ("pil2np | tolsh | totensor | normalize", "5.3"),
    ("pil2np | tospace:lab | totensor | normalize", "5.3"),
    ("pil2np | chan42 | totensor | normalize", "5.4"),
    ("pil2np | add_meanstd | totensor | normalize", "5.4"),
])
def test_saver_refuses_what_is_not_ported(tmp_path, transforms, match):
    """Once refused (ROADMAP A, items 5.3 and 5.4), each sink is ported:
    the luv and lsh undo and the live `tospace:X` undo (5.3), and the
    chan42 and add_meanstd sinks, which take the network's input (5.4),
    write the JAX sink's files byte for byte."""
    rs = np.random.RandomState(3)
    ms = [[0.4, 0.5, 0.45], [0.3, 0.35, 0.4]]
    images = {"u%d.png" % i: rs.uniform(-1.3, 1.3, (10, 12, 3))
              .astype(np.float32) for i in range(3)}
    inputs = {k: rs.uniform(-1, 1, (10, 12, 5)).astype(np.float32)
              for k in images}
    for tag, module in (("port", tinfer), ("jax", jinfer)):
        sink = module.RgbImageSaver(str(tmp_path / tag), ms,
                                    transforms=transforms)
        assert sink.needs_input == (match == "5.4")
        for k, v in images.items():
            if match == "5.4":
                sink.add(k, v, inputs[k])
            else:
                sink.add(k, v)
        sink.close()
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(images) and got == want


@pytest.mark.parametrize("transforms", [
    "pil2np | tospace:luv | totensor | normalize",
    "pil2np | tospace:hsv | totensor | normalize",
    "pil2np | tospace:lsh | totensor | normalize",
    "pil2np | tospace:yxz | totensor | normalize",
    "pil2np | toluv | chan1 | totensor | normalize",
    "pil2np | tolsh | chan1 | totensor | normalize",
])
def test_saver_colorspace_undo_equals_jax(tmp_path, transforms):
    """The other undo forms, chan1's one-channel outputs among them:
    byte-equal to the JAX sink."""
    rs = np.random.RandomState(4)
    chans = 1 if "chan1" in transforms else 3
    ms = [[0.5] * 3, [0.5] * 3]
    images = {"s%d.png" % i: rs.uniform(-1.2, 1.2, (9, 11, chans))
              .astype(np.float32) for i in range(3)}
    for tag, module in (("port", tinfer), ("jax", jinfer)):
        _save_all(module, str(tmp_path / tag), images, mean_std=ms,
                  transforms=transforms)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def _generator_pth(root, norm, seed):
    """A seeded micro generator as a reference .pth (kaiming_p2p weights,
    seeded running statistics for batch norm)."""
    model = {"architecture": "official_resnet_generator", "ngf": 4,
             "n_blocks": 1, "norm_layer": norm, "no_antialias": True,
             "no_antialias_up": True}
    net = initialize_model(model)
    initialize_weights(net, "kaiming_p2p", seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    path = os.path.join(root, "gen_%s.pth" % norm)
    torch.save({"model_state": net.state_dict(),
                "network_params": {"model": model}}, path)
    return path, model


def _hed_pth(root):
    model = {"architecture": "hed_interpolation", "width_mult": 0.0625}
    net = initialize_model(model)
    initialize_weights(net, "kaiming_p2p", 5)
    path = os.path.join(root, "hed.pth")
    torch.save({"model_state": net.state_dict(),
                "network_params": {"model": model}}, path)
    return path, model


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """Seeded PNG photos of three shapes (two same-shape batches and
    single ones), some in a subdirectory."""
    root = tmp_path_factory.mktemp("photos")
    rs = np.random.RandomState(7)
    names = []
    for i, (h, w) in enumerate(SHAPES):
        name = ("sub/p%d.png" if i % 2 else "p%d.png") % i
        os.makedirs(root / "ims" / os.path.dirname(name), exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(root / "ims" / name)
        names.append(name)
    return root, names


def _output_params(path, model, image_dir, directory, **out):
    return {"network": {"type": "SingleNetwork", "path": path,
                        "model": dict(model),
                        "runtime": {"wrappers": "", "data": {}}},
            "data": {"image_dir": image_dir + "/*",
                     "transforms": "pil2np | totensor | normalize",
                     "mean_std": GAN, "loader": {"batch_size": 2}},
            "output": {"type": "image", "directory": directory, **out}}


def _decoded(directory):
    return {k: np.asarray(Image.open(os.path.join(directory, k)))
            for k in _files(directory)}


@pytest.mark.parametrize("norm,structure", [("instance", None),
                                            ("batch", "flat")])
def test_infer_images_against_jax(photos, tmp_path, norm, structure):
    root, names = photos
    path, model = _generator_pth(str(tmp_path), norm, seed=3)
    out = {}
    for tag in ("port", "jax"):
        params = _output_params(path, model, str(root / "ims"),
                                str(tmp_path / tag), structure=structure,
                                append=True, stretch_by="meanstd")
        if tag == "port":
            (meta,) = tinfer.infer(params, (names,), device="cpu")
        else:
            (meta,) = jinfer.infer(params, (names,))
        assert meta == {"count": len(names)}
        out[tag] = _decoded(str(tmp_path / tag))
    assert sorted(out["port"]) == sorted(out["jax"]) and \
        len(out["port"]) == len(names)
    for k, want in out["jax"].items():
        got = out["port"][k]
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1, k
    # append: a second run writes nothing
    params = _output_params(path, model, str(root / "ims"),
                            str(tmp_path / "port"), structure=structure,
                            append=True)
    assert tinfer.infer(params, (names,), device="cpu") == ({"count": 0},)


def test_infer_forward_section_against_jax(photos, tmp_path):
    """`forward: {params: {no_sigmoid: true}}` on a HED: the pre-sigmoid
    edge maps, stretched min to max, one channel written as grayscale;
    `method: forward` names the module's own forward (the JAX package's
    method names are flax's, so that part is the port's alone)."""
    root, names = photos
    path, model = _hed_pth(str(tmp_path))
    out = {}
    for tag in ("port", "jax"):
        params = _output_params(path, model, str(root / "ims"),
                                str(tmp_path / tag), stretch_by="auto")
        params["forward"] = {"params": {"no_sigmoid": True}}
        if tag == "port":
            tinfer.infer(params, (names[:3],), device="cpu")
        else:
            jinfer.infer(params, (names[:3],))
        out[tag] = _decoded(str(tmp_path / tag))
    assert sorted(out["port"]) == sorted(out["jax"])
    for k, want in out["jax"].items():
        assert want.ndim == 2
        assert np.abs(out["port"][k].astype(int) - want).max() <= 1, k
    # a named method: the module's forward, with the same arguments
    params = _output_params(path, model, str(root / "ims"),
                            str(tmp_path / "method"), stretch_by="auto")
    params["forward"] = {"method": "forward",
                         "params": {"no_sigmoid": True}}
    tinfer.infer(params, (names[:3],), device="cpu")
    assert _files(str(tmp_path / "method")) == _files(str(tmp_path / "port"))


def test_infer_image_output_refusals(photos, tmp_path, monkeypatch):
    root, names = photos
    path, model = _generator_pth(str(tmp_path), "instance", seed=1)
    params = _output_params(path, model, str(root / "ims"), str(tmp_path))
    params["data"]["shape_bucket"] = 64
    with pytest.raises(ValueError, match="shape_bucket"):
        tinfer.infer(params, (names,), device="cpu")
    # device_postprocess, once refused, quantizes on the device in
    # float32, as the JAX package's opt-in path: its PNGs are JAX's, but
    # for a level at a tie (the float output, denormalized, within
    # POST_TIE of a level: the two packages' generator outputs differ by
    # ulps); and within one level of the host sink's float64
    floats, add = {}, tinfer.RgbImageSaver.add

    def recording(self, name, image_hwc, input_hwc=None):
        if np.asarray(image_hwc).dtype != np.uint8:
            floats[name] = np.array(image_hwc, np.float64)
        return add(self, name, image_hwc, input_hwc)
    monkeypatch.setattr(tinfer.RgbImageSaver, "add", recording)
    out = {}
    for tag, post in (("host", False), ("post", True), ("jax", True)):
        params = _output_params(path, model, str(root / "ims"),
                                str(tmp_path / tag))
        params["data"]["device_postprocess"] = post
        if tag == "jax":
            jinfer.infer(params, (names,))
        else:
            tinfer.infer(params, (names,), device="cpu")
        out[tag] = _decoded(str(tmp_path / tag))
    assert sorted(out["post"]) == sorted(out["host"]) == sorted(out["jax"])
    assert len(out["post"]) == 5 and len(floats) == 5
    on_level = []
    for k, want in out["jax"].items():
        got = out["post"][k].astype(int)
        assert got.shape == want.shape == out["host"][k].shape
        assert np.abs(got - out["host"][k]).max() <= 1, k
        v = np.clip(floats[k] * GAN[1][0] + GAN[0][0], 0, 1) * 255
        tie = np.abs(v - np.round(v)) <= POST_TIE
        d = got != want
        assert np.abs(got - want).max() <= 1 and not (d & ~tie).any(), k
        on_level.append(tie.mean())
    # the micro generator's outputs do not sit on levels, so "at a tie
    # only" has force: few values lie within POST_TIE of one
    assert max(on_level) < 0.01, on_level
    params = _output_params(path, model, str(root / "ims"), str(tmp_path))
    params["data"] = {"test": {"dataset": {"name": "ImagesFromList"}}}
    with pytest.raises(NotImplementedError, match="ImagesFromList"):
        tinfer.infer(params, (names,), device="cpu")


def _embed_pth(root):
    model = {"architecture": "cirnet", "cir_architecture": "vgg16",
             "pooling": "gem", "local_whitening": False, "whitening": False}
    net = initialize_model(model)
    initialize_weights(net, "kaiming_p2p", 2)
    path = os.path.join(root, "embed.pth")
    torch.save({"model_state": net.state_dict(),
                "network_params": {"model": model}}, path)
    return path, model


def test_nested_data_form_against_jax(photos, tmp_path, monkeypatch):
    """The reference's nested `data.test.{dataset: {name: CirImageList,
    image_dir, image_size}, loader}` and the flat form, with relative
    names under $GANDTR_ROOT: each gives the JAX `infer`'s descriptors in
    either form (1e-4), and the two forms give the same."""
    root, names = photos
    monkeypatch.setenv("GANDTR_ROOT", str(root))
    path, model = _embed_pth(str(tmp_path))
    net = {"type": "SingleNetwork", "path": path, "model": model,
           "runtime": {"wrappers": ""}}
    flat = {"image_dir": "ims/*", "image_size": 24,
            "transforms": "pil2np | totensor | normalize",
            "mean_std": IMNET, "loader": {"batch_size": 2}}
    nested = {"test": {"dataset": {"name": "CirImageList",
                                   "image_dir": "ims/*", "image_size": 24},
                       "transforms": "pil2np | totensor | normalize",
                       "mean_std": IMNET, "loader": {"batch_size": 2}}}
    vecs = {}
    for form, data in (("flat", flat), ("nested", nested)):
        params = {"network": net, "data": data,
                  "output": {"type": "embedding", "dimensions": 512}}
        (pm,) = tinfer.infer(dict(params), (names,), device="cpu")
        (jm,) = jinfer.infer(dict(params), (names,))
        assert pm["vecs"].shape == (512, len(names)) and \
            np.isfinite(pm["vecs"]).all()
        np.testing.assert_allclose(pm["vecs"], jm["vecs"], atol=1e-4,
                                   rtol=0, err_msg=form)
        vecs[form] = pm["vecs"]
    np.testing.assert_array_equal(vecs["flat"], vecs["nested"])
