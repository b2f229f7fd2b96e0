"""The port's scenario CLI end to end on the CPU (scenarios/run.py::main),
the download checks (utils/download.py) and the quickstart example.

- tests/test_torch_all_target.py's chain, written to a YAML file and run
  through `main(["all", file, "--device", "cpu"])` with the image names
  on stdin, gives what `run_target` gives on the same tree: the same GAN
  events, the same output files byte for byte, the same Lw and mAPs.
- examples/quickstart_synthetic.py's scenario runs through the port's
  runner as tests/test_quickstart_example.py runs it through the JAX
  package's.
- The download steps check the layout that gandtr_tpu/utils/download.py
  describes, fetch nothing, link the validation photos and name every
  missing file with its address.
"""
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

from gandtr_tpu_torch.scenarios import run
from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
from gandtr_tpu_torch.utils import download
from test_all_target_chain import synth
from test_torch_all_target import NAMES, chain_scenario

torch.set_num_threads(1)

__all__ = ["synth"]
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _tree(directory):
    out = {}
    for dirpath, _, files in os.walk(directory):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f),
                                    directory)] = fh.read()
    return out


def _events(meta):
    with open(os.path.join(meta["directory"], "epochs", "events.json")) as f:
        return json.load(f)


def test_cli_runs_the_chain_as_run_target(synth, tmp_path, monkeypatch,
                                          capsys):
    want = run.run_target(chain_scenario(synth, str(tmp_path / "direct")),
                          "all", "allchain", stdin_data=list(NAMES),
                          device="cpu")
    yml = tmp_path / "allchain.yml"
    # in the tree's key order: each NetworkSet member's seed is its
    # position
    yml.write_text(yaml.safe_dump(chain_scenario(synth,
                                                 str(tmp_path / "cli")),
                                  sort_keys=False))
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(NAMES) + "\n"))
    results = {}
    orig = run.run_target

    def recording(*args, **kwargs):
        results.update(orig(*args, **kwargs))
        return results
    monkeypatch.setattr(run, "run_target", recording)
    assert run.main(["all", str(yml), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ">> 5_eval: gandtr_tpu.stages.validate" in out
    assert list(results) == list(want)
    assert _events(results["1_train_gan"]) == _events(want["1_train_gan"])
    assert _events(results["3_finetune"]) == _events(want["3_finetune"])
    got_imgs = _tree(tmp_path / "cli" / "night_out")
    assert sorted(got_imgs) == NAMES
    assert got_imgs == _tree(tmp_path / "direct" / "night_out")
    lw = []
    for res in (results, want):
        with open(res["4_whitening"]["whitening_path"], "rb") as f:
            lw.append(pickle.load(f))
    for k in ("m", "P"):
        np.testing.assert_array_equal(lw[0][k], lw[1][k])
    assert results["5_eval"] == want["5_eval"]


def test_quickstart_scenario_runs_on_the_port(tmp_path):
    sys.path.insert(0, EXAMPLES)
    try:
        import quickstart_synthetic as qs
    finally:
        sys.path.remove(EXAMPLES)
    root = str(tmp_path / "qs")
    os.makedirs(root)
    names = qs.make_synthetic_data(root, hw=32)
    yml = qs.write_scenario(root, hw=32)
    scenario = load_yaml_scenario([yml])
    assert sorted(scenario["all"])[:2] == ["1_train_gan", "2_output"]
    results = run.run_target(scenario, "all", "quickstart_test",
                             stdin_data=names, device="cpu")
    assert len(os.listdir(os.path.join(root, "night_out"))) == len(names)
    wpath = results["4_whitening"]["whitening_path"]
    assert wpath and os.path.exists(wpath)
    val = results["5_eval"]["metadata"]["validation"]
    medium = [v for k, v in val.items() if "map_medium" in k]
    assert medium and np.isfinite(medium[0])
    series = results["1_train_gan"]["metrics_series"]
    assert len(series["train/learning/total"]) == 2


def _touch(path, data=b""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def test_rsfm120k_checks_the_layout_and_links_the_val_photos(tmp_path):
    data = str(tmp_path / "data")
    with pytest.raises(FileNotFoundError) as err:
        download.rsfm120k(data)
    text = str(err.value)
    for name in ("retrieval-SfM-120k.pkl", "retrieval-SfM-120k-whiten.pkl",
                 "dataset/train_day.txt", "dataset/train_night.txt",
                 "ims/"):
        assert name in text
    assert download.CMP_URL + "train/dbs/retrieval-SfM-120k.pkl" in text
    assert download.ICCV23_URL + "train_night.txt" in text
    dbs = os.path.join(data, "train", "retrieval-SfM-120k")
    for name in ("retrieval-SfM-120k.pkl", "retrieval-SfM-120k-whiten.pkl",
                 "dataset/train_day.txt", "dataset/train_night.txt"):
        _touch(os.path.join(dbs, name))
    for i, cid in enumerate(download.VAL_IMS[:3]):
        _touch(os.path.join(dbs, "ims", cid), b"photo%d" % i)
    download.rsfm120k(data)
    val = os.path.join(data, "val", "day_night")
    assert sorted(os.listdir(val)) == ["1.jpg", "2.jpg", "3.jpg"]
    with open(os.path.join(val, "2.jpg"), "rb") as f:
        assert f.read() == b"photo1"
    download.rsfm120k(data)         # links that exist stay


def test_test_sets_check_every_gnd_and_jpg_dir(tmp_path):
    data = str(tmp_path / "data")
    for ds in ("roxford5k", "rparis6k"):
        _touch(os.path.join(data, "test", ds, "gnd_%s.pkl" % ds))
        _touch(os.path.join(data, "test", ds, "jpg", "a.jpg"))
    with pytest.raises(FileNotFoundError) as err:
        download.roxf5k_rpar6k_247tokyo1k(data)
    text = str(err.value)
    assert "247tokyo1k/gnd_247tokyo1k.pkl" in text
    assert "247tokyo1k/jpg/*.jpg" in text and "roxford5k" not in text
    _touch(os.path.join(data, "test", "247tokyo1k", "gnd_247tokyo1k.pkl"))
    _touch(os.path.join(data, "test", "247tokyo1k", "jpg", "q.jpg"))
    download.roxf5k_rpar6k_247tokyo1k(data)


def test_download_steps_read_gandtr_root(tmp_path, monkeypatch):
    """The scenario's download steps check $GANDTR_ROOT/data; the module
    opens no connection."""
    monkeypatch.setenv("GANDTR_ROOT", str(tmp_path))
    scenario = {"t": {"1_d": {"__function__":
                              "cirtorch.utils.download.download_test"}}}
    with pytest.raises(FileNotFoundError,
                       match=str(tmp_path / "data" / "test" / "roxford5k")):
        run.run_target(scenario, "t", "s", device="cpu")
    source = open(download.__file__).read()
    assert "urllib" not in source and "urlretrieve" not in source


def test_doctor_fails_without_the_card(capsys):
    assert run.main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "torch %s" % torch.__version__ in out
    assert "no CUDA device" in out


def test_chip_smoke_scenario_cuts():
    """The chip smoke's scenario phase cuts hedngan.yml's `all` and
    cyclegan.yml's `train` targets only by the CLI overrides PERF.md
    lists: the GAN as GAN_CUTS, the fine-tune as finetune_loop_config,
    every other value as shipped."""
    import chip_smoke as cs
    full = load_yaml_scenario([cs.HEDNGAN_YML])["all"]
    cut = load_yaml_scenario([cs.HEDNGAN_YML]
                             + cs.all_target_overrides("/r/e.pth"))["all"]
    assert run.derive_scenario_name(
        [cs.HEDNGAN_YML] + cs.all_target_overrides("/r/e.pth")) == "hedngan"
    gan, gan0 = cut["1_train_augment"], full["1_train_augment"]
    lt = gan["learning"]["training"]
    assert lt["epochs"] == cs.GAN_CUTS["epochs"]
    assert {s["n_epochs_decay"] for s in lt["scheduler"].values()} == {1}
    assert gan["data"]["train"]["dataset"]["size"] == cs.GAN_CUTS["size"]
    assert gan["data"]["train"]["loader"] == {"batch_size": 10}
    for k in ("detector", "detector_frozen"):
        assert gan["network"][k]["model"]["pretrained"] is None
        gan["network"][k]["model"]["pretrained"] = \
            gan0["network"][k]["model"]["pretrained"]
    assert gan["network"] == gan0["network"]
    ft = cut["2_finetune_embed"]
    assert ft["learning"]["training"]["epochs"] == cs.LOOP_EPOCHS
    ds = ft["data"]["train"]["dataset"]
    assert {k: ds[k] for k in cs.LOOP_CUTS} == cs.LOOP_CUTS
    assert ft["network"]["embed"]["runtime"]["dtype"] == "bfloat16"
    assert ft["network"]["embed"]["model"]["pretrained"] == "/r/e.pth"
    assert ft["network"]["augment"] == full["2_finetune_embed"]["network"][
        "augment"]
    assert cut["3_train_whitening"]["whitening"]["dataset_pkl"] == \
        cs.SFM + "/retrieval-SfM-120k-whiten.pkl"
    assert cut["5_evaluate"] == full["5_evaluate"]
    cg = load_yaml_scenario([cs.CYCLEGAN_YML] + cs.cyclegan_overrides())
    cg = cg["train"]["1_train_augment"]
    assert cg["network"]["generator_X"]["model"]["n_blocks"] == 9
    assert cg["data"]["train"]["loader"] == {"batch_size": 1}
    assert cg["data"]["train"]["dataset"]["size"] == 4
    assert cg["learning"]["training"]["epochs"] == 2
    assert cg["learning"]["training"]["epoch_iteration"]["pool_size"] == 50
