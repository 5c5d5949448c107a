"""``lrcn-torch`` over a mesh, on the CPU: ``train --mesh 2 1`` (and
``train --joint --mesh 2 1``) as two processes joined by ``--coordinator
127.0.0.1:PORT --num-processes 2 --process-id I`` against the same command
in one process (equal checkpoints, one writer), ``serve --mesh 2`` over
HTTP against the JAX CLI's ``serve --mesh 2``, and the JAX CLI's messages
for the misuses of the mesh and multi-process flags."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lrcn_tpu.data.feature_store import FeatureStore, l1_normalize
from lrcn_tpu.train.checkpoint import load_checkpoint as jax_load
from lrcn_tpu_torch.models.lrcn import flat_tree
from lrcn_tpu_torch.train.checkpoint import load_checkpoint
from lrcn_tpu_torch.train.trainer import Trainer
from test_cli import synthetic_vgg_mat
from test_torch_cli import REPO, jax_main, port_main
from test_torch_http import (Servers, _serve_args, cli, files,  # noqa: F401
                             jax_cli)

WORDS = ["a", "man", "rides", "his", "bike", "dog", "runs", "on", "grass",
         "two", "children", "play", "in", "the", "park", "near", "water"]
DECODER = ["--hidden", "16", "12", "--embed", "8", "--compute-dtype",
           "float32"]
TOL = dict(rtol=1e-5, atol=1e-6)


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_ranks(argv_of, n: int = 2, timeout: float = 240.0) -> None:
    """``python -m lrcn_tpu_torch --device cpu`` with ``argv_of(rank)`` as
    ``n`` processes joined by the multi-process flags; every one must
    exit 0.  A rank left running at the timeout is ended."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lrcn_tpu_torch", "--device", "cpu",
         *argv_of(rank), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out[-2000:], err[-4000:])


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """tests/test_parallel.py's tiny COCO-style corpus: 48 images x 5
    captions over 12 caption classes, a val split over the first 12
    images, and L1-normalized 16-dim features."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(17)
    caps = [" ".join(rng.choice(WORDS, 7)) + " ." for _ in range(12)]
    for name, n, shift in (("train", 48, 0), ("val", 12, 3)):
        anns = [{"image_id": 5000 + i, "caption": caps[(i + shift) % 12]}
                for i in range(n) for _ in range(5)]
        with open(tmp / f"captions_{name}.json", "w") as f:
            json.dump({"annotations": anns}, f)
    feats = rng.standard_normal((48, 16)).astype(np.float32)
    FeatureStore.from_dict(
        {5000 + i: l1_normalize(feats[i:i + 1])[0] for i in range(48)},
        normalized=True).save(str(tmp / "feats"))
    return tmp


def train_argv(tmp, tag: str, *extra) -> list:
    return ["train", "--datafiles", str(tmp / "captions_train.json"),
            str(tmp / "captions_val.json"), "--features", str(tmp / "feats"),
            "--val-features", str(tmp / "feats"),
            "--savefile", str(tmp / f"ckpt_{tag}"),
            "--bestfile", str(tmp / f"best_{tag}"),
            "--metrics", str(tmp / f"metrics_{tag}.jsonl"),
            "--epochs", "2", "--batchsize", "8", "--seed", "3", *DECODER,
            *extra]


def assert_same_checkpoint(a: str, b: str) -> None:
    two, one = jax_load(a), jax_load(b)
    assert two["epoch"] == one["epoch"]
    fa, fb = flat_tree(two["params"]), flat_tree(one["params"])
    assert set(fa) == set(fb)
    for k in fb:
        np.testing.assert_allclose(fa[k], fb[k], err_msg=k, **TOL)
    assert len(two["opt_leaves"]) == len(one["opt_leaves"])
    for x, y in zip(two["opt_leaves"], one["opt_leaves"]):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_allclose(x, y, **TOL)


def test_two_rank_train_matches_one_process(coco):
    """Two ranks of ``train --mesh 2 1`` (dropout 0.4: each rank keeps
    its rows of the global masks) against one process without a mesh:
    the checkpoint and the best-val checkpoint equal, the 19 optax leaves
    at global shapes, and rank 0 alone writes metrics."""
    run_ranks(lambda r: train_argv(coco, "2rank", "--mesh", "2", "1",
                                   "--metrics",
                                   str(coco / f"metrics_{r}.jsonl")))
    assert port_main(train_argv(coco, "1proc")) == 0
    assert os.path.exists(coco / "metrics_0.jsonl")
    assert not os.path.exists(coco / "metrics_1.jsonl")
    epochs = [json.loads(line) for line in open(coco / "metrics_0.jsonl")]
    epochs1 = [json.loads(line)
               for line in open(coco / "metrics_1proc.jsonl")]
    pick = lambda recs: [(r["epoch"], r["val_loss"]) for r in recs
                         if r["event"] == "epoch"]
    assert [e for e, _ in pick(epochs)] == [1, 2]
    np.testing.assert_allclose([v for _, v in pick(epochs)],
                               [v for _, v in pick(epochs1)], atol=1e-4)
    assert_same_checkpoint(str(coco / "ckpt_2rank"), str(coco / "ckpt_1proc"))
    assert_same_checkpoint(str(coco / "best_2rank"), str(coco / "best_1proc"))
    assert len(jax_load(str(coco / "ckpt_2rank"))["opt_leaves"]) == 19
    # the 2-rank checkpoint resumes in the one-device port, moments too
    ck = load_checkpoint(str(coco / "ckpt_2rank"), "cpu")
    params, opt = Trainer(ck["cfg"], ck["vocab"], device="cpu").restore(
        ck["params"], ck["opt_leaves"])
    assert int(opt.state_leaves()[0]) == int(ck["opt_leaves"][0])


def test_two_rank_joint_train_matches_one_process(tmp_path):
    """``train --joint --mesh 2 1`` on two ranks (each decodes its five of
    the ten images of a batch) against one process: equal checkpoints
    (both parameter sets, the 80 optax leaves), rank 0 alone writes."""
    from PIL import Image

    rng = np.random.default_rng(6)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [41000 + i for i in range(8)]
    for iid in ids:
        Image.fromarray(rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
                        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.png"))
    anns = [{"image_id": iid, "caption": " ".join(rng.choice(WORDS, 5))}
            for iid in ids for _ in range(5)]
    with open(tmp_path / "captions_train.json", "w") as f:
        json.dump({"annotations": anns}, f)
    synthetic_vgg_mat(str(tmp_path / "vgg.mat"), rng, width=0.05, fc_dim=24)

    def argv(tag, *extra):
        return ["train", "--joint", "--images", str(img_dir),
                "--datafiles", str(tmp_path / "captions_train.json"),
                "--cnn", str(tmp_path / "vgg.mat"),
                "--savefile", str(tmp_path / f"joint_{tag}"),
                "--epochs", "1", "--batchsize", "4", "--seed", "3",
                *DECODER, *extra]

    run_ranks(lambda r: argv("2rank", "--mesh", "2", "1", "--metrics",
                             str(tmp_path / f"jmetrics_{r}.jsonl")))
    assert port_main(argv("1proc")) == 0
    assert os.path.exists(tmp_path / "jmetrics_0.jsonl")
    assert not os.path.exists(tmp_path / "jmetrics_1.jsonl")
    assert_same_checkpoint(str(tmp_path / "joint_2rank"),
                           str(tmp_path / "joint_1proc"))
    assert len(jax_load(str(tmp_path / "joint_2rank"))["opt_leaves"]) == 80
    assert os.path.exists(tmp_path / "joint_2rank" / "average_image.npy")


def test_serve_mesh_matches_jax_over_http(files):  # noqa: F811
    """``serve --mesh 2``: the port's service over the CPU listed twice
    and JAX's over 2 virtual devices answer ids, features and images
    alike over HTTP."""
    servers = Servers(files, "--mesh", "2")
    try:
        assert len(servers.services["port"].mesh.data_devices()) == 2
        for body in ({"ids": list(range(100, 109))},
                     {"features": [files["feats"][i].tolist()
                                   for i in range(100, 105)]},
                     {"images_b64": files["blobs"]}):
            out = servers.both("POST", "/v1/caption", body)
            assert out["port"][0] == 200
            assert out["port"][:2] == out["jax"][:2]
    finally:
        servers.close()


# --- misuse: JAX's messages (these replace the refusals of the flags
#     before they were ported) ---


MESH_TOO_LARGE = r"mesh shape \(16, 1\) needs 16 devices, have \d+"


@pytest.mark.parametrize("flags, message, jax_too", [
    (["--mesh", "16", "1"], MESH_TOO_LARGE, True),
    (["--pipeline"], "--pipeline requires --mesh DP 2", True),
    # the partial multi-process flags are refused before any connection
    (["--coordinator", "127.0.0.1:1"], "all of --coordinator", False),
    (["--num-processes", "2"], "all of --coordinator", False),
    (["--process-id", "0"], "all of --coordinator", False)])
def test_train_misuse_messages(coco, flags, message, jax_too):
    argv = ["train", "--datafiles", str(coco / "captions_train.json"),
            "--features", str(coco / "feats"), "--epochs", "1",
            *DECODER, *flags]
    with pytest.raises((SystemExit, ValueError), match=message):
        port_main(argv)
    if jax_too:
        with pytest.raises((SystemExit, ValueError), match=message):
            jax_main(argv)


@pytest.mark.parametrize("flags", [["--mesh", "3"]])
def test_serve_misuse_messages(files, flags):  # noqa: F811
    """A mesh that does not split the decode batch: JAX's message."""
    with pytest.raises(ValueError) as jerr:
        jax_cli.make_caption_service(_serve_args(
            jax_cli.build_parser(), ["--platform", "cpu"], files, *flags))
    with pytest.raises(ValueError) as perr:
        cli.make_caption_service(_serve_args(
            cli.build_parser(), ["--device", "cpu"], files, *flags))
    assert str(perr.value) == str(jerr.value)
    assert "divisible by the mesh's data axis (3)" in str(perr.value)


def test_misuse_exits_nonzero_from_the_shell(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    for argv, message in (
            (["train", "--datafiles", "x.token", "--pipeline"],
             "--pipeline requires --mesh DP 2"),
            (["train", "--datafiles", "x.token", "--num-processes", "2"],
             "all of --coordinator")):
        out = subprocess.run(
            [sys.executable, "-m", "lrcn_tpu_torch", "--device", "cpu",
             *argv], capture_output=True, text=True, cwd=str(tmp_path),
            env=env, timeout=120)
        assert out.returncode != 0 and message in out.stderr, argv
