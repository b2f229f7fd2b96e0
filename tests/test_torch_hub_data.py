"""The port's hub and model registry against the JAX package's, on the CPU:
a descriptor checkpoint's own data params (`network_params.runtime.data`)
drive the transform, `net.data_params` and a Servable built from the model
(ported from tests/test_hub_pretrained_fixture.py), and `cirnet` refuses
`regional: true`."""
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu import hub as jhub
from gandtr_tpu_torch import hub as thub
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.serving.export import Servable

torch.set_num_threads(1)

PLAIN = "pil2np | totensor | normalize"
UNIT = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]


def _checkpoint(tmp_path, data):
    """A reference-layout flat checkpoint of seeded port weights, whose
    runtime data params are `data`."""
    net = thub._embedding("vgg16", pretrained=False, multiscale=False,
                          device="cpu").net.module
    state = {
        "type": "SingleNetwork", "frozen": False,
        "network_params": {
            "model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                      "pooling": "gem", "regional": False,
                      "local_whitening": False, "whitening": False},
            "runtime": {"data": data, "wrappers": "cirfaketuplebatch"}},
        "model_state": {k: v.clone() for k, v in net.state_dict().items()},
    }
    path = tmp_path / "embed.pth"
    torch.save(state, str(path))
    return path, state


def test_transform_follows_checkpoint_data_params(tmp_path):
    """`augmentations` (the reference's older name) with mean 0 / std 1: the
    transform gives exactly the [0, 1] image, with no CLAHE; the model's
    data_params and a Servable built from it carry the same pipeline."""
    path, state = _checkpoint(tmp_path, {"augmentations": PLAIN,
                                         "mean_std": UNIT})
    model = thub.gem_vgg16_hedngan(pretrained=True, device="cpu",
                                   checkpoint=str(path))
    img = Image.fromarray(np.full((8, 8, 3), 128, np.uint8))
    out = np.asarray(model.transform(img))
    np.testing.assert_allclose(out, np.full((8, 8, 3), 128 / 255.0,
                                            np.float32), atol=1e-6)
    assert model.net.data_params == {"transforms": PLAIN, "mean_std": UNIT}
    for k, v in model.net.module.state_dict().items():
        assert torch.equal(v, state["model_state"][k]), k
    served = Servable(model, (32, 40))
    assert served.meta["transforms"] == PLAIN
    assert served.meta["mean_std"] == UNIT
    x = np.random.RandomState(0).randint(0, 256, (1, 32, 40, 3), np.uint8)
    direct = model(model.transform(Image.fromarray(x[0]))[None])
    np.testing.assert_allclose(served(x), direct.numpy(), atol=1e-5, rtol=0)


def test_pretrained_false_keeps_the_built_in_pipeline():
    model = thub.gem_vgg16_hedngan(pretrained=False, device="cpu")
    assert model.net.data_params == thub.EMBEDDING_DATA


@pytest.mark.parametrize("data", [
    {"transforms": PLAIN, "mean_std": UNIT},
    {"augmentations": PLAIN},
    {"transforms": PLAIN, "augmentations": "pil2np | totensor"},
    {"mean_std": UNIT},
    {},
    None,
], ids=["transforms", "augmentations", "both", "mean_std_only", "empty",
        "no_runtime"])
def test_data_params_helper_matches_jax(data):
    """The port's own copy of the helper returns what the JAX hub's returns
    on the same checkpoint dicts."""
    net_state = {"network_params": ({"runtime": {"data": data}}
                                    if data is not None else {}),
                 "model_state": {}}
    default = dict(thub.EMBEDDING_DATA)
    want = jhub._checkpoint_data_params(net_state, default)
    assert thub._checkpoint_data_params(net_state, default) == want
    assert default == thub.EMBEDDING_DATA


def test_cirnet_refuses_regional():
    """`regional: true` builds cirtorch's Rpool (`pool.rpool.p`,
    `pool.whiten`) and refuses a padded-bucket mask, as the JAX net
    does; the meta reports the flag."""
    cfg = {"architecture": "cirnet", "cir_architecture": "vgg16",
           "pooling": "gem", "local_whitening": False, "whitening": False}
    net = initialize_model({**cfg, "regional": True})
    assert net.meta["regional"] is True
    assert {"pool.rpool.p", "pool.whiten.weight", "pool.whiten.bias"} <= \
        set(net.state_dict())
    with pytest.raises(ValueError, match="regional"):
        net.pool(torch.ones(1, 4, 4, 512), mask=torch.ones(1, 4, 4))
    net = initialize_model({**cfg, "regional": False})
    assert net.meta["regional"] is False
