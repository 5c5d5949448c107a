"""The port's pipelined training step against ``lrcn_tpu.parallel.pipeline``,
on the CPU.

JAX runs its ``PipelinedTrainStep`` and ``pipeline_loss_fn`` on the pytest
process's virtual CPU devices; the port runs one gloo rank per mesh entry
(``parallel.dryrun.spawn``, ``tests/torch_parallel_ranks.py``), stage 0
and stage 1 of the recurrence on the two ranks of each ``model`` group,
from the same parameters and batches with JAX's dropout masks injected.
f32 tolerances: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig as JaxConfig
from lrcn_tpu.core.tokenizer import Caption as JaxCaption
from lrcn_tpu.core.vocab import Vocab as JaxVocab
from lrcn_tpu.data import FeatureStore as JaxStore
from lrcn_tpu.data import bucket_batches as jax_bucket_batches
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.parallel import make_mesh as jax_make_mesh
from lrcn_tpu.parallel import pipeline as jax_pp
from lrcn_tpu.train import Trainer as JaxTrainer
from lrcn_tpu.train import load_checkpoint as jax_load_checkpoint
from lrcn_tpu.train.metrics import MetricsLogger as JaxMetrics
from lrcn_tpu.train.trainer import make_optimizer as jax_make_optimizer
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, flat_tree
from lrcn_tpu_torch.parallel import make_mesh
from lrcn_tpu_torch.parallel import pipeline as pp
from lrcn_tpu_torch.parallel.dryrun import spawn
from lrcn_tpu_torch.train.checkpoint import load_checkpoint

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(hidden=(16, 16), embed=16, cnn_feature_dim=10, vocab_size=24,
             batch_size=8, lr=1e-2, compute_dtype="float32", seed=7)
PDROP, GCLIP = 0.4, 0.05
RANKS = "torch_parallel_ranks"
# JAX's masks with the clip engaged (a wrong clip or mask would part the
# parameters from JAX's)
RUNS = {"no dropout": (0.0, 0.0), "jax masks, clipped": (PDROP, GCLIP)}


def make_batch(rng, batch=8, length=7, vocab=24, dim=10):
    tokens = rng.integers(3, vocab, (batch, length)).astype(np.int32)
    lengths = rng.integers(1, length + 1, (batch,)).astype(np.int32)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0
    return tokens, lengths, rng.standard_normal((batch, dim)).astype(
        np.float32)


def jax_masks(key, t_dim, b_dim, e_dim, f2):
    """The masks ``pipeline_loss_total_count`` draws from ``key`` (the
    construction of ``lrcn.loss_total_count``)."""
    k1, k2 = jax.random.split(key)
    keep = 1.0 - PDROP
    m1 = jax.random.bernoulli(k1, keep, (t_dim, b_dim, e_dim)) / keep
    m2 = jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
    return np.asarray(m1, np.float32), np.asarray(m2, np.float32)


def scenario(pdrop, gclip):
    kw = dict(SMALL, dropout=pdrop, gclip=gclip)
    jcfg = JaxConfig(**kw)
    params = jax_lrcn.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    batches = [make_batch(rng) for _ in range(2)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    masks = [jax_masks(k, 8, 8, jcfg.embed, 2 * jcfg.factor_dim)
             if pdrop else None for k in keys]
    return kw, jcfg, params, batches, keys, masks


def jax_run(shape, pdrop, gclip):
    kw, jcfg, params, batches, keys, masks = scenario(pdrop, gclip)
    mesh = jax_make_mesh(shape)
    step = jax_pp.PipelinedTrainStep(jcfg, jax_make_optimizer(jcfg), mesh)
    p = step.shard_params(params)
    # jitted: the eager grad of the shard_map compiles op by op (~10x)
    grads = jax.jit(jax.grad(jax_pp.pipeline_loss_fn), static_argnums=4,
                    static_argnames=("pdrop", "compute_dtype"))(
        p, *batches[0], mesh, pdrop=pdrop, rng=keys[0],
        compute_dtype=jnp.float32)
    o = step.init_opt(p)
    losses = []
    for batch, key in zip(batches, keys):
        p, o, loss = step(p, o, *step.shard_batch(*batch), key)
        losses.append(float(loss))
    return {"grads": flat_tree(jax.tree.map(np.asarray, grads)),
            "losses": losses,
            "params": flat_tree(jax.tree.map(np.asarray,
                                             step.unshard_params(p))),
            "opt_leaves": [np.asarray(x) for x in jax.tree.leaves(o)]}


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=lambda s: f"mesh{s[0]}x{s[1]}")
def runs(request):
    shape = request.param
    args = []
    for pdrop, gclip in RUNS.values():
        kw, _, params, batches, _, masks = scenario(pdrop, gclip)
        args.append(dict(cfg_kwargs=kw,
                         tree=flat_tree(jax.tree.map(np.asarray, params)),
                         batches=batches, masks=masks, mesh_shape=shape,
                         pipeline=True))
    port = spawn(f"{RANKS}:train_runs", shape[0] * shape[1], args,
                 timeout=150)
    return port, {name: jax_run(shape, *a) for name, a in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_pipelined_step_matches_jax(runs, name):
    """The loss, every gradient of the first step (pipeline layout: the
    stacked cells) and the parameters after two steps (the decoder's
    layout), on every rank, against JAX's pipeline: without dropout, with
    JAX's masks (stage 1's shifted a tick), and with the clip engaged."""
    port, jax_side = runs
    i = list(RUNS).index(name)
    want = jax_side[name]
    for rank_out in port:
        got = rank_out[i]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        assert set(got["grads"]) == set(want["grads"])
        for k in want["grads"]:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                       err_msg=k, **TOL)
        for k in PARAM_KEYS:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       err_msg=k, **TOL)
        assert len(got["opt_leaves"]) == len(want["opt_leaves"]) == 15
        for a, b in zip(got["opt_leaves"], want["opt_leaves"]):
            assert np.shape(a) == np.shape(b)
            np.testing.assert_allclose(a, b, **TOL)


def test_stage_shards(runs):
    """Each rank holds one stage's cell and half the vocabulary."""
    port, _ = runs
    for rank_out in port:
        shapes = rank_out[0]["local_shapes"]
        assert shapes["lstm_pp/w"] == (1, 32, 64)
        assert shapes["lstm_pp/b"] == (1, 64)
        assert shapes["embedding"] == (12, 16)
        assert shapes["w_out"] == (16, 12) and shapes["b_out"] == (12,)
        assert shapes["w_factor"] == (16, 8)


def test_parameter_round_trip_matches_jax():
    jcfg = JaxConfig(**SMALL)
    params = jax_lrcn.init_params(jax.random.PRNGKey(4), jcfg)
    host = jax.tree.map(np.asarray, params)
    got = pp.to_pipeline_params(host)
    want = flat_tree(jax.tree.map(np.asarray,
                                  jax_pp.to_pipeline_params(params)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the JAX pipeline layout (numpy, nested) comes back to the decoder's
    back = pp.from_pipeline_params(jax.tree.map(
        np.asarray, jax_pp.to_pipeline_params(params)))
    jback = flat_tree(jax.tree.map(np.asarray,
                                   jax_pp.from_pipeline_params(got_nested(
                                       got))))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(back[k], flat_tree(host)[k])
        np.testing.assert_array_equal(jback[k], flat_tree(host)[k])


def got_nested(flat):
    out = {}
    for k, v in flat.items():
        head, _, leaf = k.rpartition("/")
        (out.setdefault(head, {}) if head else out)[leaf or k] = v
    return out


@pytest.mark.parametrize("change, shape", [
    (dict(hidden=(16, 32), embed=16), (1, 2)),
    (dict(embed=12), (1, 2)),
    (dict(hidden=(15, 15), embed=15), (1, 2)),
    (dict(vocab_size=31), (1, 2)),
    ({}, (2, 4))])
def test_validation_messages_match_jax(change, shape):
    kw = dict(SMALL, **change)
    with pytest.raises(ValueError) as port_err:
        pp.validate_pipeline_config(
            LRCNConfig(**kw),
            make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1])))
    with pytest.raises(ValueError) as jax_err:
        jax_pp.validate_pipeline_config(JaxConfig(**kw),
                                        jax_make_mesh(shape))
    assert str(port_err.value) == str(jax_err.value)


def fit_dataset():
    words = [f"w{i}" for i in range(21)]
    rng = np.random.default_rng(0)
    captions = [(100 + i % 10, tuple(rng.choice(words, 5)))
                for i in range(40)]
    feats = {100 + i: rng.standard_normal(10).astype(np.float32)
             for i in range(10)}
    return words, captions, feats


def test_pipeline_trainer_fit_matches_jax_and_its_checkpoint_loads(
        tmp_path):
    """``Trainer(pipeline=True).fit`` on 2 ranks, one epoch from JAX's
    initial parameters, against JAX's ``Trainer(pipeline=True).fit`` on a
    (1, 2) mesh: the checkpoint (written by rank 0 alone) is in the
    decoder's layout, loads in JAX and in the port on one device, and its
    parameters match JAX's; the optimizer state keeps the pipeline
    layout's 15 optax leaves, as JAX's does.  ``steps_per_dispatch`` 8 is
    ignored with a warning, as in JAX."""
    words, captions, feats = fit_dataset()
    kw = dict(SMALL, dropout=0.0, epochs=1, vocab_size=len(words) + 3)
    jcfg = JaxConfig(**kw)
    params = jax_lrcn.init_params(jax.random.PRNGKey(0), jcfg)
    tree = flat_tree(jax.tree.map(np.asarray, params))
    out = spawn(f"{RANKS}:fit", 2, kw, words, captions, feats, tree, (1, 2),
                str(tmp_path / "port"), True, 8, timeout=150)
    assert [o["steps_per_dispatch"] for o in out] == [1, 1]
    assert all("not supported with pipeline" in " ".join(o["warned"])
               for o in out)
    assert [o["primary"] for o in out] == [True, False]

    jvocab = JaxVocab(words)
    jcaps = [JaxCaption(i, w) for i, w in captions]
    jstore = JaxStore.from_dict(feats)
    batches = jax_bucket_batches(jcaps, jvocab, 8,
                                 apply_small_dataset_rule=False)
    trainer = JaxTrainer(jcfg, jvocab, JaxMetrics(echo=False),
                         mesh=jax_make_mesh((1, 2)), pipeline=True)
    p = trainer._sharded.shard_params(params)
    trainer.fit(p, trainer._sharded.init_opt(p), batches, None, jstore, None,
                jax.random.PRNGKey(1), savefile=str(tmp_path / "jax"),
                eval_train_loss=False)
    want = jax_load_checkpoint(str(tmp_path / "jax"))
    got = jax_load_checkpoint(str(tmp_path / "port"))
    assert "lstm1" in got["params"] and "lstm_pp" not in got["params"]
    assert len(got["opt_leaves"]) == len(want["opt_leaves"]) == 15
    for a, b in zip(got["opt_leaves"], want["opt_leaves"]):
        assert np.shape(a) == np.shape(b)
    got_flat = flat_tree(got["params"])
    for k, v in flat_tree(want["params"]).items():
        np.testing.assert_allclose(got_flat[k], v, rtol=0, atol=2e-5,
                                   err_msg=k)
    one = load_checkpoint(str(tmp_path / "port"), torch.device("cpu"))
    np.testing.assert_array_equal(one["decoder"].w_out.numpy(),
                                  got_flat["w_out"])
