"""``lrcn-torch export`` against ``lrcn``'s live decode, on the CPU at f32:
a JAX-saved checkpoint exported by the port's command and reloaded from
disk gives JAX's tokens (beam, greedy; the image variant from a JAX joint
checkpoint), the port's live sampling under the same seed, and the
command's refusals."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.decode import beam as jax_beam
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.train.checkpoint import save_checkpoint as jax_save
from lrcn_tpu_torch.decode.sample import best_of_n_search
from lrcn_tpu_torch.export import load_exported
from lrcn_tpu_torch.models.lrcn import params_from_numpy
from test_torch_cli import REPO, port_main

F32 = ["--compute-dtype", "float32"]
# scores: the same sums, rounded as vals - lse against log_softmax
# (tests/test_torch_decode.py)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A decoder checkpoint and a joint checkpoint (VGG at width 0, fc 10,
    a mean image), both saved by the JAX package."""
    tmp = tmp_path_factory.mktemp("export_cli")
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25, compute_dtype="float32")
    params = jax_lrcn.init_params(jax.random.PRNGKey(4), cfg)
    vgg = jax_vgg.init_vgg_params(jax.random.PRNGKey(6),
                                  width_multiplier=0.0, fc_dim=10)
    vocab = Vocab([f"w{i}" for i in range(22)])
    decoder, joint = str(tmp / "decoder"), str(tmp / "joint")
    jax_save(decoder, params, vocab, cfg)
    jax_save(joint, {"cnn": vgg, "decoder": params}, vocab, cfg)
    avg = np.random.default_rng(8).uniform(100, 130, (224, 224, 3))
    np.save(os.path.join(joint, "average_image.npy"), avg.astype(np.float32))
    return {"tmp": tmp, "params": params, "vgg": vgg, "decoder": decoder,
            "joint": joint, "avg": avg.astype(np.float32)}


def _feats(b, seed):
    return np.random.default_rng(seed).normal(size=(b, 10)).astype(
        np.float32)


def test_export_decoder_variants_match_jax(ckpts, capsys):
    out = str(ckpts["tmp"] / "frozen")
    assert port_main(["export", "--loadfile", ckpts["decoder"], "--out", out,
                      "--variants", "beam,greedy,sample", "--beam_width",
                      "2", "--generate", "7", "--sample-n", "3",
                      "--temperature", "1.5", *F32]) == 0
    assert "exported ['beam', 'greedy', 'sample']" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["beam.pt2", "export.json",
                                       "greedy.pt2", "sample.pt2",
                                       "vocab.json"]
    model = load_exported(out, "cpu")
    assert model.manifest["beam_width"] == 2
    assert model.manifest["platforms"] == ["cpu", "cuda"]
    assert model.manifest["variants"]["sample"]["sample_n"] == 3
    params = ckpts["params"]
    decoder = params_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                                torch.float32)
    for b in (1, 6):
        feats = _feats(b, seed=b)
        tokens, scores = model.call("beam", feats)
        want_t, want_s = jax_beam.beam_search(
            params, jnp.asarray(feats), beam_width=2, max_words=7,
            compute_dtype=jnp.float32)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                                   **SCORE_TOL)
        tokens, _ = model.call("greedy", feats)
        want_t, _ = jax_beam.greedy_search(params, jnp.asarray(feats),
                                           max_words=7,
                                           compute_dtype=jnp.float32)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
        tokens, _ = model.call("sample", feats, 5)
        want_t, _ = best_of_n_search(
            decoder, torch.from_numpy(feats), n_samples=3, temperature=1.5,
            max_words=7, generator=torch.Generator().manual_seed(5))
        assert torch.equal(tokens, want_t)


def test_export_image_variant_from_a_jax_joint_checkpoint(ckpts):
    out = str(ckpts["tmp"] / "frozen_image")
    assert port_main(["export", "--loadfile", ckpts["joint"], "--out", out,
                      "--variants", "image", "--generate", "5",
                      "--batch", "2", *F32]) == 0
    model = load_exported(out, "cpu")
    assert model.manifest["batch"] == 2
    pixels = np.random.default_rng(9).integers(
        0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    tokens, scores = model.call("image", pixels)
    images = jnp.asarray(pixels, jnp.float32) - jnp.asarray(ckpts["avg"])
    feats = jax_vgg.l1_normalize(jax_vgg.vgg16_fc7(ckpts["vgg"], images,
                                                   jnp.float32))
    want_t, want_s = jax_beam.beam_search(
        ckpts["params"], feats, beam_width=3, max_words=5,
        compute_dtype=jnp.float32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               **SCORE_TOL)


@pytest.mark.parametrize("argv, message", [
    (["--variants", "image"], "image variant needs an encoder"),
    (["--variants", "beam,beams"], r"unknown variants \['beams'\]"),
    (["--platforms", "cpu,tpu"], "tpu is the JAX package's"),
    (["--platforms", "tpu"], "tpu is the JAX package's")])
def test_export_refuses(ckpts, argv, message):
    out = ckpts["tmp"] / "refused"
    with pytest.raises(SystemExit, match=message):
        port_main(["export", "--loadfile", ckpts["decoder"], "--out",
                   str(out), *argv])
    assert not out.exists()


def test_export_runs_from_the_shell(ckpts):
    """``python -m lrcn_tpu_torch --device cpu export`` exits 0 and writes
    the directory; a refusal exits nonzero with its message."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(ckpts["tmp"] / "shell")
    base = [sys.executable, "-m", "lrcn_tpu_torch", "--device", "cpu",
            "export", "--loadfile", ckpts["decoder"], "--out", out,
            "--generate", "3"]
    run = subprocess.run(base, capture_output=True, text=True, env=env,
                         cwd=str(ckpts["tmp"]), timeout=300)
    assert run.returncode == 0, run.stderr
    assert sorted(os.listdir(out)) == ["beam.pt2", "export.json",
                                       "vocab.json"]
    run = subprocess.run([*base, "--variants", "greedy,x"],
                         capture_output=True, text=True, env=env,
                         cwd=str(ckpts["tmp"]), timeout=300)
    assert run.returncode != 0 and "unknown variants" in run.stderr
