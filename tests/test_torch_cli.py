"""The port's command line (``lrcn_tpu_torch/cli.py``) against the JAX
package's (``lrcn_tpu/cli.py``), on the CPU: the parser surface, the
helpers and ``--device``.
``export`` runs in ``test_torch_export_cli.py``.

The other ``tests/test_torch_cli_*.py`` files and ``test_torch_http.py``
run the commands of both packages on the same files; they import the
helpers below."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lrcn_tpu import cli as jax_cli
from lrcn_tpu.data.feature_store import FeatureStore, l1_normalize
from lrcn_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = ["a", "man", "rides", "his", "bike", "dog", "runs", "on", "grass",
         "two", "children", "play", "in", "the", "park", "near", "water"]
# the small decoder of tests/test_decode.py, in f32
TINY = ["--hidden", "16", "12", "--embed", "8", "--compute-dtype", "float32"]


def jax_main(argv) -> int:
    return jax_cli.main(["--platform", "cpu", *argv])


def port_main(argv) -> int:
    return cli.main(["--device", "cpu", *argv])


def write_flickr(tmp, n_images: int = 2100, dim: int = 64, seed: int = 0):
    """tests/test_cli.py's synthetic Flickr set: a .token file (2,100
    images, enough for the fixed 1000/1000 val/test split) and an
    L1-normalized feature store of ``dim`` columns."""
    rng = np.random.default_rng(seed)
    lines = []
    for img in range(n_images):
        for j in range(5):
            n = rng.integers(4, 9)
            cap = " ".join(rng.choice(WORDS, n))
            lines.append(f"{10000 + img}.jpg#{j}\t{cap} .\n")
    token = str(tmp / "flickr.token")
    with open(token, "w") as f:
        f.writelines(lines)
    feats = rng.standard_normal((n_images, dim)).astype(np.float32)
    store = FeatureStore.from_dict(
        {10000 + i: l1_normalize(feats[i:i + 1])[0]
         for i in range(n_images)}, normalized=True)
    feats_dir = str(tmp / "feats")
    store.save(feats_dir)
    return token, feats_dir


def write_coco_pair(tmp, ids_train, ids_val, seed: int = 1):
    """captions_train.json + captions_val.json over the given image ids."""
    rng = np.random.default_rng(seed)
    paths = []
    for name, ids in (("captions_train.json", ids_train),
                      ("captions_val.json", ids_val)):
        anns = [{"image_id": int(i),
                 "caption": " ".join(rng.choice(WORDS, 5))}
                for i in ids for _ in range(5)]
        path = str(tmp / name)
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        paths.append(path)
    return paths


# --- (a) the parser surface ---


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser) -> dict:
    """option string (or positional dest) -> (dest, default, choices,
    nargs, required, type)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction,
                          argparse._SubParsersAction)):
            continue
        key = a.option_strings[0] if a.option_strings else a.dest
        out[key] = (a.dest, a.default, a.choices, a.nargs, a.required,
                    a.type, type(a).__name__)
    return out


def test_parser_has_every_subcommand_and_flag_of_jax():
    """Every subcommand and flag of the JAX CLI, with one difference:
    ``export --platforms`` defaults to the port's platforms."""
    jax_sub = _subparsers(jax_cli.build_parser())
    port_sub = _subparsers(cli.build_parser())
    assert list(port_sub) == list(jax_sub)
    for name in jax_sub:
        port, jax = _options(port_sub[name]), _options(jax_sub[name])
        if name == "export":
            p, j = port.pop("--platforms"), jax.pop("--platforms")
            assert (p[1], j[1]) == ("cpu,cuda", "cpu,tpu")
            assert p[:1] + p[2:] == j[:1] + j[2:]
        assert port == jax, name


def test_parser_differs_only_in_device():
    jax_top = _options(jax_cli.build_parser())
    port_top = _options(cli.build_parser())
    assert set(jax_top) == {"--platform"}
    assert set(port_top) == {"--device"}
    assert port_top["--device"][1] == "cuda"
    args = cli.build_parser().parse_args(["eval", "--candidates", "c",
                                          "--candidate-ids", "i",
                                          "--annotations", "a.token",
                                          "--refs-dir", "r"])
    assert args.device == "cuda"


@pytest.mark.parametrize("name", [
    "COCO_val2014_000000391895.jpg", "/x/1000092795.jpg", "12.png",
    "img_7.JPEG", "a_b_c_00042.bmp", "nodigits.jpg", "x_.jpg", "5"])
def test_image_id_from_filename_matches_jax(name):
    def run(fn):
        try:
            return fn(name)
        except ValueError as e:
            return type(e)
    assert run(cli.image_id_from_filename) == run(
        jax_cli.image_id_from_filename)


def test_decode_geometry_matches_jax_on_a_grid():
    for n in (1, 2, 10, 15, 16, 17, 100, 255, 256, 257, 1000, 4096, 5000):
        for batch in (None, 20, 64):
            for depth in (None, 1, 3):
                assert cli.decode_geometry(n, batch, depth) == \
                    jax_cli.decode_geometry(n, batch, depth), (n, batch,
                                                               depth)


def test_datafile_helpers_match_jax(tmp_path):
    def ns(**kw):
        base = dict(datafiles=[], flickr=False, coco=False,
                    data_root=str(tmp_path))
        base.update(kw)
        return argparse.Namespace(**base)

    nested = tmp_path / "MsCoCo" / "annotations"
    nested.mkdir(parents=True)
    (nested / "captions_train2014.json").write_text("{}")
    for kw in (dict(flickr=True), dict(coco=True), dict(),
               dict(datafiles=["x.token"]), dict(datafiles=["a.json"]),
               dict(flickr=True, datafiles=["y.json"])):
        a, b = ns(**kw), ns(**kw)
        cli._autofill_datafiles(a)
        jax_cli._autofill_datafiles(b)
        assert a == b and cli._dataset_kind(a) == jax_cli._dataset_kind(b)
    with pytest.raises(SystemExit):
        cli._autofill_datafiles(ns(flickr=True, coco=True))


def test_config_helpers_match_jax(capsys):
    from lrcn_tpu.config import LRCNConfig as JaxConfig
    from lrcn_tpu_torch.config import LRCNConfig

    for argv in (["train", "--datafiles", "d.token"],
                 ["train", "--datafiles", "d.token", "--lr", "5e-4",
                  "--batchsize", "8", "--gclip", "2", "--dropout", "0.1",
                  "--epochs", "3", "--seed", "9", *TINY]):
        a = cli.build_parser().parse_args(argv)
        b = jax_cli.build_parser().parse_args(argv)
        fresh = cli._fresh_config(a, vocab_size=20, cnn_feature_dim=64)
        want = jax_cli._fresh_config(b, vocab_size=20, cnn_feature_dim=64)
        assert vars(fresh) == vars(want)
        resumed = cli._resumed_config(LRCNConfig(), a)
        out = capsys.readouterr().out
        want = jax_cli._resumed_config(JaxConfig(), b)
        assert vars(resumed) == vars(want)
        assert out == capsys.readouterr().out


def test_help_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "lrcn_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd="/tmp",
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "extract-features" in out.stdout


def test_pyproject_names_the_console_script():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'lrcn-torch = "lrcn_tpu_torch.cli:main"' in text


# --- (h) --device ---


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
@pytest.mark.parametrize("command", ["generate", "caption", "serve"])
def test_cuda_device_without_a_card_raises(tmp_path, command):
    """The default device is the card; without one the command raises
    before it reads anything, and does not carry on on the CPU."""
    argv = {"generate": ["generate", "--loadfile", str(tmp_path / "none"),
                         "--features", str(tmp_path / "none")],
            "caption": ["caption", "x.png", "--loadfile",
                        str(tmp_path / "none")],
            "serve": ["serve", "--loadfile", str(tmp_path / "none")]}
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(argv[command])
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--device", "cuda:0", *argv[command]])
