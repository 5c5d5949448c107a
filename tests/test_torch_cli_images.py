"""The image commands of ``lrcn-torch`` against ``lrcn``'s, on the CPU in
f32 with a width-scaled VGG-16 (width 0.05, fc 24, as tests/test_cli.py):
``caption`` and ``extract-features`` from a JAX joint checkpoint on PNG
files, ``train --joint`` and the 2f warm start writing checkpoints that
the JAX package loads, and an explicit ``--cnn`` .mat file."""

import functools
import json
import os

import numpy as np
import pytest
from PIL import Image

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.train.checkpoint import load_checkpoint as jax_load
from lrcn_tpu.train.checkpoint import save_checkpoint as jax_save
from lrcn_tpu_torch.models import vgg as torch_vgg
from test_cli import synthetic_vgg_mat
from test_torch_cli import WORDS, jax_main, port_main

NARROW_VGG = dict(width_multiplier=0.05, fc_dim=24)
DECODER = ["--hidden", "16", "12", "--embed", "8", "--compute-dtype",
           "float32"]
# fc7 of the same f32 encoder in both packages, relative to its largest
# entry: tests/test_torch_vgg.py's FC7_RTOL at f32
FC7_RTOL = 1e-5


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    """PNG files, a COCO json, and a joint checkpoint trained by each
    CLI from its own random narrow VGG."""
    import jax

    tmp = tmp_path_factory.mktemp("cli_images")
    rng = np.random.default_rng(6)
    img_dir = tmp / "imgs"
    img_dir.mkdir()
    ids = [41000 + i for i in range(8)]
    for iid in ids:
        Image.fromarray(rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
                        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.png"))
    anns = [{"image_id": iid, "caption": " ".join(rng.choice(WORDS, 5))}
            for iid in ids for _ in range(5)]
    train_json = str(tmp / "captions_train.json")
    with open(train_json, "w") as f:
        json.dump({"annotations": anns}, f)
    base = ["train", "--joint", "--images", str(img_dir), "--datafiles",
            train_json, "--epochs", "1", "--batchsize", "4", "--seed", "3",
            "--dropout", "0.0", *DECODER]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vgg, "init_vgg_params", jax.jit(functools.partial(
            jax_vgg.init_vgg_params, **NARROW_VGG)))
        mp.setattr(torch_vgg, "init_vgg_params", functools.partial(
            torch_vgg.init_vgg_params, **NARROW_VGG))
        for name, main in (("jax", jax_main), ("port", port_main)):
            assert main([*base, "--savefile", str(tmp / name)]) == 0
    return {"tmp": tmp, "images": str(img_dir), "ids": ids,
            "json": train_json, "base": base,
            "jax": str(tmp / "jax"), "port": str(tmp / "port")}


def _caption(main, ckpt, image, capsys, *extra):
    capsys.readouterr()
    assert main(["caption", image, "--loadfile", ckpt, "--generate", "6",
                 "--beam_width", "2", "--compute-dtype", "float32",
                 *extra]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("ckpt", ["jax", "port"])
def test_caption_matches_jax(joint, capsys, ckpt):
    """Either package's joint checkpoint captions the same in both."""
    for iid in joint["ids"][:3]:
        image = os.path.join(joint["images"],
                             f"COCO_train2014_{iid:012d}.png")
        port = _caption(port_main, joint[ckpt], image, capsys)
        assert port == _caption(jax_main, joint[ckpt], image, capsys)
        assert port.endswith(".\n") and port.count("\n") == 1


def test_extract_features_rows_match_jax(joint, capsys):
    stores, printed = {}, {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = str(joint["tmp"] / f"{name}_feats")
        capsys.readouterr()
        assert main(["extract-features", "--loadfile", joint["jax"],
                     "--images", joint["images"], "--out", out,
                     "--batch-size", "3", "--scan-depth", "2",
                     "--flush-every", "1", "--no-normalize",
                     "--compute-dtype", "float32"]) == 0
        printed[name] = capsys.readouterr().out.replace(out, "<out>")
        stores[name] = FeatureStore.load(out)
    port, jax = stores["port"], stores["jax"]
    assert printed["port"] == printed["jax"]
    assert port.ids() == jax.ids() == joint["ids"]
    assert port.dim == jax.dim == 24 and not port.normalized
    got, ref = port.gather(port.ids()), jax.gather(port.ids())
    assert np.abs(got - ref).max() / np.abs(ref).max() <= FC7_RTOL
    # a second run resumes and extracts nothing
    out = str(joint["tmp"] / "port_feats")
    assert port_main(["extract-features", "--loadfile", joint["jax"],
                      "--images", joint["images"], "--out", out,
                      "--no-normalize", "--compute-dtype", "float32"]) == 0
    assert "resuming: 8 features already extracted" in \
        capsys.readouterr().out


def test_port_joint_checkpoint_loads_in_jax(joint):
    ck = jax_load(joint["port"])
    assert set(ck["params"]) == {"cnn", "decoder"}
    assert ck["epoch"] == 1 and len(ck["opt_leaves"]) == 80
    assert np.asarray(ck["params"]["cnn"]["fc7"]["b"]).shape == (24,)
    assert os.path.exists(os.path.join(joint["port"], "average_image.npy"))


def test_port_resumes_a_jax_joint_checkpoint(joint):
    resumed = str(joint["tmp"] / "resumed")
    argv = [a if a != "1" else "2" for a in joint["base"]]   # --epochs 2
    assert port_main([*argv, "--loadfile", joint["jax"], "--savefile",
                      resumed, "--steps-per-dispatch", "2",
                      "--no-remat-cnn"]) == 0
    before, after = jax_load(joint["jax"]), jax_load(resumed)
    assert after["epoch"] == 2
    # both Adams' step counts continue from the JAX run's
    assert int(after["opt_leaves"][0]) == 2 * int(before["opt_leaves"][0])
    # a decoder-only resume of a joint checkpoint is refused
    with pytest.raises(SystemExit, match="joint"):
        port_main(["train", "--datafiles", joint["json"], "--features",
                   "unused", "--loadfile", joint["jax"]])


def test_2f_warm_start_and_explicit_cnn(joint, tmp_path, capsys):
    """``train --joint --loadfile <decoder-only> --cnn <mat>`` seeds the
    decoder from the checkpoint and the encoder from the .mat; an explicit
    --cnn captions alike in both packages."""
    import jax

    mat = str(tmp_path / "vgg_tiny.mat")
    synthetic_vgg_mat(mat, np.random.default_rng(12), width=0.05, fc_dim=24)
    vocab = Vocab(WORDS)
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=24,
                     vocab_size=len(vocab), compute_dtype="float32",
                     batch_size=4, dropout=0.0)
    dec = str(tmp_path / "dec_1f")
    jax_save(dec, jax_lrcn.init_params(jax.random.PRNGKey(1), cfg), vocab,
             cfg)
    out = str(tmp_path / "joint_2f")
    assert port_main(["train", "--joint", "--images", joint["images"],
                      "--datafiles", joint["json"], "--loadfile", dec,
                      "--cnn", mat, "--epochs", "1", "--compute-dtype",
                      "float32", "--savefile", out]) == 0
    ck = jax_load(out)
    assert set(ck["params"]) == {"cnn", "decoder"}
    avg = np.load(os.path.join(out, "average_image.npy"))
    assert avg.shape == (224, 224, 3) and np.allclose(avg, 120)

    image = os.path.join(joint["images"],
                         f"COCO_train2014_{joint['ids'][0]:012d}.png")
    port = _caption(port_main, dec, image, capsys, "--cnn", mat)
    assert port == _caption(jax_main, dec, image, capsys, "--cnn", mat)

    bad_cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=64,
                         vocab_size=len(vocab), compute_dtype="float32")
    bad = str(tmp_path / "dec_bad")
    jax_save(bad, jax_lrcn.init_params(jax.random.PRNGKey(2), bad_cfg),
             vocab, bad_cfg)
    with pytest.raises(SystemExit, match="dim"):
        port_main(["train", "--joint", "--images", joint["images"],
                   "--datafiles", joint["json"], "--loadfile", bad,
                   "--cnn", mat, "--epochs", "1"])
    with pytest.raises(SystemExit, match="joint"):
        port_main(["extract-features", "--loadfile", dec, "--images",
                   joint["images"], "--out", str(tmp_path / "x")])
