"""The data commands of ``lrcn-torch`` and their modules against the JAX
package's, on the CPU: ``import-karpathy`` (``data/karpathy.py``),
``import-jld``/``export-jld`` (``data/jld.py``) in both directions, and
``download`` (``data/download.py``) over ``file://`` URLs."""

import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.data import download as jax_download
from lrcn_tpu.data import jld as jax_jld
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.train.checkpoint import load_checkpoint as jax_load
from lrcn_tpu.train.checkpoint import save_checkpoint as jax_save
from lrcn_tpu_torch.data import download, jld
from lrcn_tpu_torch.models import lrcn as torch_lrcn
from lrcn_tpu_torch.models.vgg import init_vgg_params
from lrcn_tpu_torch.train.checkpoint import load_checkpoint
from lrcn_tpu_torch.train.checkpoint import save_checkpoint
from test_karpathy import make_karpathy_files
from test_torch_cli import jax_main, port_main

h5py = pytest.importorskip("h5py")


# --- import-karpathy ---


@pytest.mark.parametrize("flags", [[], ["--no-normalize"]])
def test_import_karpathy_matches_jax(tmp_path, capsys, flags):
    mat, dataset, feats = make_karpathy_files(tmp_path, n=7, dim=32)
    stores, printed = {}, {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = str(tmp_path / name)
        capsys.readouterr()
        assert main(["import-karpathy", "--vgg-feats", mat, "--dataset-json",
                     dataset, "--out", out, *flags]) == 0
        printed[name] = capsys.readouterr().out.replace(out, "<out>")
        stores[name] = FeatureStore.load(out)
    port, jax = stores["port"], stores["jax"]
    assert printed["port"] == printed["jax"] == \
        "imported 7 features to <out>\n"
    assert port.ids() == jax.ids() == [1000 + i for i in range(7)]
    assert port.normalized == jax.normalized == (not flags)
    np.testing.assert_array_equal(port.table(), jax.table())
    want = feats[:, 3] / (1 if flags else feats[:, 3].sum())
    np.testing.assert_allclose(port.get(1003), want, rtol=1e-6)


# --- import-jld / export-jld ---


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A decoder checkpoint written by the JAX package."""
    import jax

    from lrcn_tpu.models import lrcn as jax_lrcn

    tmp = tmp_path_factory.mktemp("cli_jld")
    vocab = Vocab([f"w{i}" for i in range(21)])
    cfg = LRCNConfig(hidden=(10, 9), embed=8, cnn_feature_dim=12,
                     vocab_size=len(vocab))
    params = jax.tree.map(np.asarray, jax_lrcn.init_params(
        jax.random.PRNGKey(7), cfg))
    ckpt = str(tmp / "jax_ckpt")
    jax_save(ckpt, params, vocab, cfg)
    return tmp, ckpt


def test_jld_crosses_packages_both_ways(small, capsys):
    tmp, ckpt = small
    printed = {}
    for writer, w_main, reader, r_main in (("jax", jax_main, "port",
                                            port_main),
                                           ("port", port_main, "jax",
                                            jax_main)):
        path = str(tmp / f"{writer}.jld")
        capsys.readouterr()
        assert w_main(["export-jld", ckpt, "--out", path]) == 0
        printed[f"export {writer}"] = capsys.readouterr().out.replace(
            path, "<jld>")
        out = str(tmp / f"{reader}_from_{writer}")
        assert r_main(["import-jld", path, "--savefile", out]) == 0
        printed[f"import {reader}"] = capsys.readouterr().out.replace(
            path, "<jld>").replace(out, "<out>")
        # either reader sees the same tree in the file
        assert _same_tree(jld.read_jld(path), jax_jld.read_jld(path))
        # the imported checkpoint holds the original parameters
        orig, got = jax_load(ckpt), jax_load(out)
        assert got["vocab"].words == orig["vocab"].words
        for key in ("w_cnn", "embedding", "w_out", "b_out"):
            np.testing.assert_array_equal(got["params"][key],
                                          orig["params"][key])
        np.testing.assert_array_equal(got["params"]["lstm1"]["w"],
                                      orig["params"]["lstm1"]["w"])
        port = load_checkpoint(out, "cpu", torch.float32)
        np.testing.assert_array_equal(port["decoder"].lstm2_w.numpy(),
                                      orig["params"]["lstm2"]["w"])
    # the two .jld files hold the same tree, and the commands print alike
    assert _same_tree(jld.read_jld(str(tmp / "jax.jld")),
                      jld.read_jld(str(tmp / "port.jld")))
    assert printed["export jax"] == printed["export port"]
    assert printed["import jax"] == printed["import port"]
    assert "hidden=(10, 9)" in printed["import port"]


def test_export_jld_of_a_joint_checkpoint_exports_the_decoder(tmp_path,
                                                              capsys):
    cfg_kw = dict(hidden=(10, 9), embed=8, cnn_feature_dim=16)
    vocab = Vocab([f"w{i}" for i in range(9)])
    from lrcn_tpu_torch.config import LRCNConfig as TorchConfig
    cfg = TorchConfig(**cfg_kw, vocab_size=len(vocab))
    gen = torch.Generator().manual_seed(0)
    joint = {"cnn": init_vgg_params(gen, width_multiplier=0.05, fc_dim=16),
             "decoder": torch_lrcn.init_params(cfg, gen)}
    ckpt = str(tmp_path / "joint")
    save_checkpoint(ckpt, joint, vocab, cfg)
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        path = str(tmp_path / f"{name}.jld")
        capsys.readouterr()
        assert main(["export-jld", ckpt, "--out", path]) == 0
        outs[name] = capsys.readouterr().out.replace(path, "<jld>")
    assert outs["port"] == outs["jax"]
    assert _same_tree(jld.read_jld(str(tmp_path / "port.jld")),
                      jax_jld.read_jld(str(tmp_path / "jax.jld")))
    model = jld.read_jld(str(tmp_path / "port.jld"))["model"]
    np.testing.assert_array_equal(
        model[6], joint["decoder"]["embedding"].detach().numpy())


def test_import_jld_errors_match_jax(tmp_path):
    path = str(tmp_path / "empty.jld")
    with h5py.File(path, "w"):
        pass
    errors = []
    for module in (jld, jax_jld):
        with pytest.raises(ValueError) as e:
            module.import_knet_checkpoint(path, str(tmp_path / "x"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "file structure" in errors[0]


# --- download ---


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_download_over_file_urls_leaves_the_same_files(tmp_path, capsys,
                                                       monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("alpha")
    zip_path = tmp_path / "train2014.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.write(src / "a.txt", "train2014/a.txt")
    tar_path = tmp_path / "flickr30k.tar.gz"
    with tarfile.open(tar_path, "w:gz") as t:
        t.add(src / "a.txt", "flickr30k/captions.token")
    for module in (download, jax_download):
        monkeypatch.setattr(module, "COCO_URLS", [zip_path.as_uri()])
        monkeypatch.setattr(module, "FLICKR_URLS", [tar_path.as_uri()])
    trees, printed = {}, {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        root = str(tmp_path / f"data_{name}")
        capsys.readouterr()
        for which in ("coco", "flickr", "coco"):   # the 2nd coco skips
            assert main(["download", which, "--root", root]) == 0
        printed[name] = capsys.readouterr().out
        trees[name] = _tree(root)
    assert trees["port"] == trees["jax"]
    assert trees["port"]["MsCoCo/train2014/a.txt"] == b"alpha"
    assert printed["port"] == printed["jax"]
    assert printed["port"].count("downloading") == 2


def test_failed_fetch_leaves_no_part_file(tmp_path):
    """A fetch that fails removes its ``.part`` file; a Flickr URL's
    failure points at the signup form, as in JAX."""
    gated = (tmp_path / "DenotationGraph" / "flickr30k.tar").as_uri()
    missing = (tmp_path / "nothing.zip").as_uri()
    for url, kind, says in ((gated, RuntimeError, "signup form"),
                            (missing, OSError, "No such file")):
        messages = []
        for module, dest in ((download, "port"), (jax_download, "jax")):
            with pytest.raises(kind) as e:
                module.fetch(url, str(tmp_path / dest))
            assert os.listdir(tmp_path / dest) == []
            messages.append(str(e.value).replace(dest, "<dest>"))
        assert messages[0] == messages[1] and says in messages[0]
