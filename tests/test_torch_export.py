"""The port's frozen export (``lrcn_tpu_torch/export.py``) against the JAX
package's live decode, on the CPU, at tests/test_export.py's geometry
(hidden (16, 12), embed 8, cnn 10, vocab 25; VGG at width 0 with fc 10),
in f32; and the three kernels as ``torch.library`` ops.

One directory is exported once (beam, greedy, sample, image) and reloaded
from disk; the reloaded programs run the ops' CPU implementations, the
kernels' plain versions.  ``tests/test_torch_export_cli.py`` holds
``lrcn-torch export``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab as JaxVocab
from lrcn_tpu.decode import beam as jax_beam
from lrcn_tpu.export import save_exported as jax_save_exported
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu_torch import export
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.decode.beam import beam_search
from lrcn_tpu_torch.decode.sample import best_of_n_search
from lrcn_tpu_torch.models.lrcn import params_from_numpy
from lrcn_tpu_torch.models.vgg import vgg_params_from_numpy
from lrcn_tpu_torch.ops.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BEAM, MAX_WORDS, SAMPLE_N, TEMPERATURE = 3, 6, 4, 1.5
MEAN = 117.0
# scores: the same sums, rounded as vals - lse against log_softmax
# (tests/test_torch_decode.py)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    params = jax_lrcn.init_params(jax.random.PRNGKey(3), cfg)
    vgg = jax.tree.map(np.asarray, jax_vgg.init_vgg_params(
        jax.random.PRNGKey(5), width_multiplier=0.0, fc_dim=10))
    words = [f"w{i}" for i in range(22)]
    return {"params": params, "vgg": vgg, "words": words,
            "avg": np.full((224, 224, 3), MEAN, np.float32),
            "decoder": params_from_numpy(jax.tree.map(np.asarray, params),
                                         CPU, torch.float32)}


@pytest.fixture(scope="module")
def exported(model, tmp_path_factory):
    """One directory with every variant, exported at f32 and reloaded."""
    out = str(tmp_path_factory.mktemp("export") / "frozen")
    encoder = vgg_params_from_numpy(model["vgg"], CPU, torch.float32)
    manifest = export.save_exported(
        out, model["decoder"], Vocab(model["words"]),
        variants=("beam", "greedy", "sample", "image"), beam_width=BEAM,
        max_words=MAX_WORDS, sample_n=SAMPLE_N, temperature=TEMPERATURE,
        vgg=encoder, average_image=model["avg"])
    return out, manifest, export.load_exported(out, "cpu")


def _feats(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 10)).astype(
        np.float32)


# --- the ops ---


def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    lstm = (r(24, 32), r(32), r(5, 8), r(5, 8), r(5, 16))
    logits = r(6, 25)
    conv = (r(2, 5, 6, 3), r(3, 3, 3, 4), r(4))
    return {
        "lstm_step f32": ("lstm_step", lstm),
        "lstm_step bf16": ("lstm_step", (lstm[0].bfloat16(), *lstm[1:])),
        "topk_lse k=1": ("topk_lse", (logits, 1)),
        "topk_lse k=3": ("topk_lse", (logits, 3)),
        "topk_lse k=V": ("topk_lse", (logits, 25)),
        "topk_lse warp": ("topk_lse", (logits, 3, "warp")),
        "conv3x3_relu f32": ("conv3x3_relu", conv),
        "conv3x3_relu bf16 no relu": ("conv3x3_relu",
                                      (conv[0], conv[1].bfloat16(), conv[2],
                                       False)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_ops_pass_opcheck(case):
    name, args = _op_cases()[case]
    op = getattr(torch.ops.lrcn, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", ["lstm_step", "topk_lse", "conv3x3_relu"])
def test_ops_have_cpu_cuda_and_fake_kernels(name):
    qualname = f"{build.NAMESPACE}::{name}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key)


@pytest.mark.parametrize("case", ["lstm_step bf16", "topk_lse k=3",
                                  "conv3x3_relu bf16 no relu"])
def test_fake_implementations_on_meta(case):
    """Shapes and dtypes of the CPU implementation, on ``meta``."""
    name, args = _op_cases()[case]
    op = getattr(torch.ops.lrcn, name).default
    want = op(*args)
    got = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a
               for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype, t.device.type) for t in got] == [
        (t.shape, t.dtype, "meta") for t in want]


# --- the artifacts against JAX's live decode ---


def test_programs_call_the_ops(exported):
    """Each step of a search is one op node per kernel launch: 2 LSTM and
    1 top-k a step, and 13 convs in the image program."""
    out, manifest, _ = exported
    steps = MAX_WORDS + 1
    want = {"beam": (2 * steps, steps, 0), "greedy": (2 * steps, steps, 0),
            "sample": (2 * steps, 0, 0), "image": (2 * steps, steps, 13)}
    for variant, entry in manifest["variants"].items():
        program = torch.export.load(os.path.join(out, entry["file"]))
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        got = tuple(targets.count(f"lrcn.{name}.default")
                    for name in ("lstm_step", "topk_lse", "conv3x3_relu"))
        assert got == want[variant], variant


@pytest.mark.parametrize("b", [1, 5, 7])
def test_beam_artifact_matches_jax(model, exported, b):
    """One symbolic-batch artifact at three batch sizes."""
    feats = _feats(b)
    tokens, scores = exported[2].call("beam", feats)
    want_t, want_s = jax_beam.beam_search(
        model["params"], jnp.asarray(feats), beam_width=BEAM,
        max_words=MAX_WORDS, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               **SCORE_TOL)


@pytest.mark.parametrize("b", [1, 5, 7])
def test_greedy_artifact_matches_jax(model, exported, b):
    feats = _feats(b, seed=1)
    tokens, scores = exported[2].call("greedy", feats)
    want_t, want_s = jax_beam.greedy_search(
        model["params"], jnp.asarray(feats), max_words=MAX_WORDS,
        compute_dtype=jnp.float32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               **SCORE_TOL)


def test_image_artifact_matches_jax(model, exported):
    """uint8 pixels -> tokens against JAX's live steps: mean image,
    ``vgg16_fc7``, ``l1_normalize``, ``beam_search``."""
    pixels = np.random.default_rng(2).integers(
        0, 256, size=(3, 224, 224, 3), dtype=np.uint8)
    tokens, scores = exported[2].call("image", pixels)
    images = jnp.asarray(pixels, jnp.float32) - jnp.asarray(model["avg"])
    fc7 = jax_vgg.vgg16_fc7(jax.tree.map(jnp.asarray, model["vgg"]), images,
                            jnp.float32)
    feats = jax_vgg.l1_normalize(fc7)
    want_t, want_s = jax_beam.beam_search(
        model["params"], feats, beam_width=BEAM, max_words=MAX_WORDS,
        compute_dtype=jnp.float32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               **SCORE_TOL)


@pytest.mark.parametrize("b,seed", [(1, 0), (5, 11)])
def test_sample_artifact_matches_the_live_port(model, exported, b, seed):
    """Under one seed, the live ``best_of_n_search`` with
    ``torch.Generator().manual_seed(seed)``; the same seed twice gives the
    same tokens, and the call leaves the default generator as it was."""
    feats = _feats(b, seed=2)
    state = torch.random.get_rng_state()
    tokens, scores = exported[2].call("sample", feats, seed)
    again, _ = exported[2].call("sample", feats, seed)
    assert torch.equal(torch.random.get_rng_state(), state)
    want_t, want_s = best_of_n_search(
        model["decoder"], torch.from_numpy(feats), n_samples=SAMPLE_N,
        temperature=TEMPERATURE, max_words=MAX_WORDS,
        generator=torch.Generator().manual_seed(seed))
    assert torch.equal(tokens, want_t) and torch.equal(again, tokens)
    np.testing.assert_array_equal(scores.numpy(), want_s.numpy())


def test_bf16_artifact_matches_the_live_port(model, tmp_path):
    """bf16: the program records each bf16 matmul as ``lrcn::mm_f32``
    (the CNN projection, then the factor and output projections a step)
    and gives the live bf16 path's tokens and scores."""
    decoder = params_from_numpy(jax.tree.map(np.asarray, model["params"]),
                                CPU, torch.bfloat16)
    out = str(tmp_path / "bf16")
    export.save_exported(out, decoder, Vocab(model["words"]), max_words=4)
    program = torch.export.load(os.path.join(out, "beam.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("lrcn.mm_f32.default") == 1 + 2 * 5
    feats = torch.from_numpy(_feats(5, seed=3))
    tokens, scores = export.load_exported(out, "cpu").call("beam", feats)
    want_t, want_s = beam_search(decoder, feats, beam_width=3, max_words=4)
    assert torch.equal(tokens, want_t) and torch.equal(scores, want_s)


def test_manifest_and_vocab_match_jax(model, exported, tmp_path):
    """``export.json`` has the keys of JAX's manifest (and the device of
    the files' weights); ``vocab.json`` is JAX's byte for byte."""
    out, manifest, _ = exported
    jax_out = str(tmp_path / "jax")
    jax_manifest = jax_save_exported(
        jax_out, model["params"], JaxVocab(model["words"]),
        variants=("beam", "sample"), beam_width=BEAM, max_words=2,
        sample_n=SAMPLE_N, temperature=TEMPERATURE, platforms=("cpu",))
    with open(os.path.join(out, "export.json")) as f:
        on_disk = json.load(f)
    assert on_disk == manifest
    assert set(on_disk) == set(jax_manifest) | {"file_device"}
    assert on_disk["format"] == "torch.export"
    assert on_disk["platforms"] == ["cpu", "cuda"]
    assert on_disk["compute_dtype"] == "float32" and on_disk["batch"] is None
    for variant in ("beam", "sample"):
        assert set(on_disk["variants"][variant]) == set(
            jax_manifest["variants"][variant])
    assert sorted(os.listdir(out)) == [
        "beam.pt2", "export.json", "greedy.pt2", "image.pt2", "sample.pt2",
        "vocab.json"]
    with open(os.path.join(out, "vocab.json"), "rb") as f, \
            open(os.path.join(jax_out, "vocab.json"), "rb") as g:
        assert f.read() == g.read()


def test_captions_detokenize_with_bundled_vocab(model, exported):
    from lrcn_tpu.decode.writer import detokenize_batch

    feats = _feats(3, seed=4)
    lines = exported[2].captions("beam", feats)
    want_t, _ = jax_beam.beam_search(
        model["params"], jnp.asarray(feats), beam_width=BEAM,
        max_words=MAX_WORDS, compute_dtype=jnp.float32)
    assert lines == detokenize_batch(np.asarray(want_t),
                                     JaxVocab(model["words"]))


def test_pinned_batch(model, tmp_path):
    """``batch`` pins the batch dimension: the artifact takes that batch
    only."""
    out = str(tmp_path / "pinned")
    manifest = export.save_exported(out, model["decoder"],
                                    Vocab(model["words"]), max_words=3,
                                    batch=4)
    assert manifest["batch"] == 4
    loaded = export.load_exported(out, "cpu")
    tokens, _ = loaded.call("beam", _feats(4))
    assert tokens.shape == (4, 5)
    with pytest.raises(Exception):
        loaded.call("beam", _feats(3))


def test_refusals(model, exported, tmp_path):
    out, _, loaded = exported
    with pytest.raises(ValueError, match="unknown export variant"):
        export.save_exported(str(tmp_path / "x"), model["decoder"],
                             Vocab(model["words"]), variants=("beams",))
    with pytest.raises(ValueError, match="tpu is the JAX package"):
        export.save_exported(str(tmp_path / "x"), model["decoder"],
                             Vocab(model["words"]),
                             platforms=("cpu", "tpu"))
    with pytest.raises(ValueError, match="image export needs an encoder"):
        export.save_exported(str(tmp_path / "x"), model["decoder"],
                             Vocab(model["words"]), variants=("image",))
    assert not os.path.exists(tmp_path / "x")
    with pytest.raises(KeyError, match="not in this export"):
        loaded.call("beams", _feats(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            export.load_exported(out)       # the default device: the card


def test_consumer_path_loads_without_model_code(exported):
    """A fresh interpreter loads the directory and captions with torch,
    ``core.vocab`` and the op registrations only."""
    out = exported[0]
    code = (
        "import sys, numpy as np\n"
        "from lrcn_tpu_torch.export import load_exported\n"
        f"m = load_exported({out!r}, 'cpu')\n"
        "feats = np.random.default_rng(0).normal(size=(2, 10))\n"
        "lines = m.captions('beam', feats.astype(np.float32))\n"
        "assert len(lines) == 2 and all(l.endswith(' .') for l in lines)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(\n"
        "    ('jax.', 'lrcn_tpu.', 'lrcn_tpu_torch.models',\n"
        "     'lrcn_tpu_torch.decode', 'lrcn_tpu_torch.serve',\n"
        "     'lrcn_tpu_torch.train')) or n == 'lrcn_tpu']\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(out), env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]"
