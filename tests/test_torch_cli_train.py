"""``lrcn-torch train`` against ``lrcn train``, on the CPU in f32: both
build the same vocabulary from the same .token file, a port-written
checkpoint generates in the JAX CLI (and in the port, byte-equal), a
JAX-written one resumes in the port with its optimizer leaves, and the
resume overrides and the --epochs budget behave as in JAX."""

import json
import os

import numpy as np
import pytest

from lrcn_tpu.train.checkpoint import load_checkpoint as jax_load
from lrcn_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_cli import TINY, jax_main, port_main, write_flickr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_train")
    token, feats = write_flickr(tmp)
    base = ["train", "--datafiles", token, "--features", feats,
            "--epochs", "1", "--batchsize", "16", "--seed", "3",
            "--dropout", "0.0", *TINY]
    ckpts = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        ckpts[name] = str(tmp / f"{name}_ckpt")
        assert main([*base, "--savefile", ckpts[name], "--metrics",
                     str(tmp / f"{name}_metrics.jsonl")]) == 0
    return {"tmp": tmp, "token": token, "feats": feats, "base": base,
            **ckpts}


def test_both_build_the_same_vocab_and_config(runs):
    def read(name, file):
        with open(os.path.join(runs[name], file)) as f:
            return json.load(f)
    assert read("port", "vocab.json") == read("jax", "vocab.json")
    port_cfg, jax_cfg = read("port", "config.json"), read("jax",
                                                          "config.json")
    assert port_cfg.pop("savefile").endswith("port_ckpt")
    assert jax_cfg.pop("savefile").endswith("jax_ckpt")
    assert port_cfg == jax_cfg       # every field, step and epoch included
    assert port_cfg["epoch"] == 1 and port_cfg["hidden"] == [16, 12]
    with open(runs["tmp"] / "port_metrics.jsonl") as f:
        events = [json.loads(line)["event"] for line in f]
    assert events[-1] == "epoch" and "epoch_train_done" in events


def test_port_checkpoint_generates_in_jax(runs, capsys):
    files = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = str(runs["tmp"] / f"{name}_gen")
        assert main(["generate", "--loadfile", runs["port"], "--features",
                     runs["feats"], "--datafiles", runs["token"],
                     "--capnumber", "24", "--generate", "8", "--seed", "5",
                     "--compute-dtype", "float32", "--out", out,
                     "--ids-out", out + "_ids"]) == 0
        with open(out, "rb") as f, open(out + "_ids", "rb") as g:
            files[name] = (f.read(), g.read())
    assert files["port"] == files["jax"]
    # and JAX reads every leaf the port wrote
    ck = jax_load(runs["port"])
    assert ck["epoch"] == 1 and len(ck["opt_leaves"]) == 19
    # inference reads no optimizer leaves, and the same parameters
    light = load_checkpoint(runs["port"], "cpu", opt_state=False)
    full = load_checkpoint(runs["port"], "cpu")
    assert light["opt_leaves"] is None and len(full["opt_leaves"]) == 19
    assert light["params"].keys() == full["params"].keys()
    assert all(np.array_equal(light["params"][k], full["params"][k])
               for k in full["params"])


def test_jax_checkpoint_resumes_in_port_with_its_leaves(runs):
    resumed = str(runs["tmp"] / "resumed")
    argv = [a if a != "1" else "2" for a in runs["base"]]   # --epochs 2
    assert port_main([*argv, "--loadfile", runs["jax"],
                      "--savefile", resumed]) == 0
    before = jax_load(runs["jax"])
    after = load_checkpoint(resumed, "cpu")
    assert after["epoch"] == 2
    # Adam's step count continues from the JAX run's
    steps = int(before["opt_leaves"][0])
    assert steps > 0 and int(after["opt_leaves"][0]) == 2 * steps
    # and the resumed checkpoint loads back in JAX
    assert jax_load(resumed)["epoch"] == 2


def test_resume_overrides_and_budget_print_as_in_jax(runs, capsys):
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        capsys.readouterr()
        override = str(runs["tmp"] / f"{name}_override")
        argv = [a if a != "1" else "2" for a in runs["base"]]
        assert main([*argv, "--loadfile", runs[name], "--savefile",
                     override, "--lr", "5e-4", "--batchsize", "8"]) == 0
        printed = capsys.readouterr().out
        with open(os.path.join(override, "config.json")) as f:
            cfg = json.load(f)
        # the identical command again: the budget is spent, nothing runs
        noop = str(runs["tmp"] / f"{name}_noop")
        assert main([*runs["base"], "--loadfile", runs[name],
                     "--savefile", noop]) == 0
        outs[name] = (printed, cfg["lr"], cfg["batch_size"],
                      capsys.readouterr().out, os.path.exists(noop))
    assert outs["port"] == outs["jax"]
    printed, lr, batch, noop_out, wrote = outs["port"]
    assert "resume: --lr 0.0005 overrides checkpoint lr=" in printed
    assert "overrides checkpoint batch_size=" in printed
    assert (lr, batch) == (5e-4, 8)
    assert "nothing to do" in noop_out and not wrote


def test_train_options_run(runs):
    """--steps-per-dispatch, --ckpt-every, --bestfile with validation
    features, --equal-length-batches and --gclip run, and the checkpoints
    load in JAX."""
    save, best = str(runs["tmp"] / "k2"), str(runs["tmp"] / "k2_best")
    assert port_main([*runs["base"], "--savefile", save, "--bestfile", best,
                      "--val-features", runs["feats"],
                      "--steps-per-dispatch", "2", "--ckpt-every", "3",
                      "--gclip", "1.0", "--equal-length-batches"]) == 0
    for path in (save, best):
        ck = jax_load(path)
        assert ck["epoch"] == 1 and ck["cfg"].gclip == 1.0
        assert np.isfinite(np.asarray(ck["params"]["w_out"])).all()
