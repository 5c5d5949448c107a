"""The port's one-program dispatch for sampling, training, the joint step
and reloaded export programs (``lrcn_tpu_torch/utils/graphs.py``), on
the CPU.

On a card ``sample_search``, ``best_of_n_search``, the ``Trainer``'s
dispatches and evaluations, ``JointTrainStep``'s steps and evaluation
and each loaded export program run eagerly at their first call of a
signature, capture a CUDA graph at the second and replay it from then
on.  Here the graph API is stubbed as in ``tests/test_torch_graphs.py``
(``_stub_graph_api``): a "capture" records the body's ops and undoes
them, so the capturing call takes its step only through the replay that
follows, and a "replay" runs the recorded ops again, drawing from the
registered generators as they stand.  With the stub on, the optimizers
are the fused Adam the card runs in both its eager and its captured
calls.  The graphed paths are held against their eager bodies (bit for
bit) and against the JAX package.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.decode import sample as jax_sample
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu_torch import export
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.decode import sample
from lrcn_tpu_torch.models import joint, lrcn
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, params_from_numpy
from lrcn_tpu_torch.models.vgg import init_vgg_params
from lrcn_tpu_torch.ops.kernels import fused_lstm_step
from lrcn_tpu_torch.train import checkpoint as torch_ckpt
from lrcn_tpu_torch.train.trainer import Trainer, fold_in
from lrcn_tpu_torch.utils import graphs

from test_torch_graphs import _stub_graph_api, counting  # noqa: F401
from test_torch_sample import jax_gumbel
from test_torch_sample import small as sample_small  # noqa: F401
from test_torch_train import (Recorder, crash_after_saves, Crash, jax_fits,
                              tiny, to_flat)  # noqa: F401

CPU = torch.device("cpu")
MAX_WORDS = 12          # test_torch_sample's (its jax_gumbel draws so many)


@pytest.fixture
def fake_cuda(monkeypatch):
    return _stub_graph_api(monkeypatch)


def _leaves_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _eager_bodies(mp) -> None:
    """Every graphed entry point runs its body eagerly, as on CPU
    tensors, while optimizers built under the stub, before or after,
    stay the fused Adam: the eager twin of a graphed run."""
    mp.setattr(graphs, "run",
               lambda owner, key, fn, inputs, reads=(), **kw: fn(*inputs))
    mp.setattr(graphs, "step",
               lambda owner, key, fn, inputs, reads=(), seeds=(): fn(
                   graphs._seeded(inputs[0].device, seeds), *inputs))


# --- sampling ---


def test_best_of_n_replays_match_jax(sample_small, fake_cuda):
    """Three calls of one shape with JAX's Gumbel noise injected (eager,
    capture, replay; the noise one more static input): each call's
    tokens exactly JAX's ``best_of_n_search``, scores within 1e-5 (f32
    sums in another order)."""
    cfg, params, decoder, feats = sample_small
    n = 3
    for seed in range(3):
        rows = feats * (1.0 + seed)
        rng = jax.random.PRNGKey(seed)
        want_t, want_s = jax_sample.best_of_n_search(
            params, jnp.asarray(rows), rng, n_samples=n, temperature=2.0,
            max_words=MAX_WORDS, compute_dtype=jnp.float32)
        noise = torch.from_numpy(jax_gumbel(rng, rows.shape[0] * n,
                                            cfg.vocab_size))
        got_t, got_s = sample.best_of_n_search(
            decoder, torch.from_numpy(rows), n_samples=n, temperature=2.0,
            max_words=MAX_WORDS, gumbel=noise)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)
    assert graphs.stats == {"captures": 1, "replays": 2}


@pytest.mark.parametrize("entry", ["sample_search", "best_of_n_search"])
def test_generator_sequence_replays_the_eager_one(sample_small, fake_cuda,
                                                  counting, entry):
    """Four successive calls on one generator (eager, capture, replay,
    replay) give the tokens and scores of four eager calls on a generator
    seeded alike, bit for bit, and leave it in the same state: a replay
    draws from the generator as it stands and advances it as an eager
    call does.  Another generator object is another signature.  Each
    replay counts the search's LSTM launches once."""
    decoder, feats = copy.deepcopy(sample_small[2]), sample_small[3]
    steps = MAX_WORDS + 1
    n = 2 if entry == "best_of_n_search" else 1
    graphed = getattr(sample, entry)
    eager = getattr(sample, f"{entry}_fn")
    kwargs = dict(temperature=1.5, max_words=MAX_WORDS)
    if n > 1:
        kwargs["n_samples"] = n
    gen, ref = (torch.Generator().manual_seed(5) for _ in range(2))
    for call in range(4):
        rows = torch.from_numpy(feats * (1.0 + call % 2))
        before = fused_lstm_step.launches
        got = graphed(decoder, rows, generator=gen, **kwargs)
        assert fused_lstm_step.launches - before == 2 * steps
        with torch.inference_mode():
            want = eager(decoder, rows, generator=ref, **kwargs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert torch.equal(gen.get_state(), ref.get_state())
    assert graphs.stats == {"captures": 1, "replays": 3}
    (entry_graph,) = graphs.graphs(decoder)
    assert entry_graph.graph.generators == [gen]
    other = torch.Generator().manual_seed(5)
    graphed(decoder, rows, generator=other, **kwargs)
    graphed(decoder, rows, generator=other, **kwargs)
    assert graphs.stats["captures"] == 2


# --- the decoder trainer ---


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_graphed_fit_matches_jax(tiny, jax_fits, fake_cuda,
                                 steps_per_dispatch):
    """``Trainer.fit`` with every dispatch and evaluation graphed: the
    epochs' losses within 1e-4 of JAX's ``Trainer.fit`` and the
    parameters within 2e-5 absolute (``test_torch_train.py``'s
    tolerances: f32 sums in another order, Adam's scalars in double)."""
    want_params, want_records = jax_fits[steps_per_dispatch]
    cfg = dataclasses.replace(tiny["cfg"], compute_dtype="float32")
    rec = Recorder()
    trainer = Trainer(cfg, tiny["vocab"], metrics=rec, device="cpu",
                      steps_per_dispatch=steps_per_dispatch)
    init = to_flat(jax_lrcn.init_params(jax.random.PRNGKey(0),
                                        tiny["jcfg"]))
    params, opt = trainer.restore(init)
    params, opt = trainer.fit(params, opt, tiny["batches"], tiny["batches"],
                              tiny["store"], tiny["store"], 1, epochs=2)
    records = [r for r in rec.records if r["event"] == "epoch"]
    for got, want in zip(records, want_records):
        for key in ("train_loss", "val_loss"):
            assert abs(got[key] - want[key]) <= 1e-4 + 1e-12, (got, want)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   want_params[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert int(opt.state_leaves()[0]) == 2 * len(tiny["batches"])
    assert graphs.graphs(opt) and graphs.graphs(params)
    assert graphs.stats["replays"] > graphs.stats["captures"]
    assert all(p.grad is None for p in params.values())


def _chunks(tiny, trainer, n: int):
    """n stacked K-batch chunks on the device, each of one shape, the
    second and later of other words than the first."""
    _, (tokens, lengths, rows) = trainer._stacked(
        [tiny["batches"][0]] * trainer.steps_per_dispatch, tiny["store"])
    return [(torch.where(tokens > 0, (tokens - 3 + i) % 12 + 3, tokens),
             lengths, rows) for i in range(n)]


def _dispatches(tiny, trainer, params, opt, chunks):
    table = trainer._device_table(tiny["store"])
    return [trainer._dispatch(params, opt, *c, table, 7, 3 * i)
            for i, c in enumerate(chunks)]


def test_graphed_dispatches_equal_eager_ones(tiny, fake_cuda, monkeypatch):
    """Four K=2 dispatches with dropout 0.4 (eager, capture, replay,
    replay; the second and later on other batches): the losses, the
    parameters and the 19 optax leaves bit-equal to four eager
    dispatches of the same fused Adam, and the step keys drive the
    graph's generators, re-seeded before each replay."""
    cfg = dataclasses.replace(tiny["cfg"], dropout=0.4)
    trainer = Trainer(cfg, tiny["vocab"], metrics=Recorder(), device="cpu",
                      steps_per_dispatch=2)
    chunks = _chunks(tiny, trainer, 4)
    p_g, o_g = trainer.init(0)
    p_e, o_e = trainer.init(0)
    assert o_e.adam.defaults["fused"]
    got = _dispatches(tiny, trainer, p_g, o_g, chunks)
    assert graphs.stats == {"captures": 1, "replays": 3}
    (entry,) = graphs.graphs(o_g)
    assert len(entry.generators) == 2
    _eager_bodies(monkeypatch)
    want = _dispatches(tiny, trainer, p_e, o_e, chunks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[2], got[3])
    for k in PARAM_KEYS:
        assert torch.equal(p_g[k], p_e[k]), k
    leaves = o_g.state_leaves()
    assert len(leaves) == 19 and int(leaves[0]) == 8
    assert _leaves_equal(leaves, o_e.state_leaves())


def test_capturing_call_takes_its_step(tiny, fake_cuda, monkeypatch):
    """The capture executes nothing; the replay right after it takes the
    step: after two dispatches the parameters and Adam's count are those
    of two eager dispatches, and the graph has replayed once."""
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu", steps_per_dispatch=2)
    chunks = _chunks(tiny, trainer, 2)
    p_g, o_g = trainer.init(0)
    p_e, o_e = trainer.init(0)
    _dispatches(tiny, trainer, p_g, o_g, chunks)
    (entry,) = graphs.graphs(o_g)
    assert entry.replays == 1 and int(o_g.state_leaves()[0]) == 4
    _eager_bodies(monkeypatch)
    _dispatches(tiny, trainer, p_e, o_e, chunks)
    for k in PARAM_KEYS:
        assert torch.equal(p_g[k], p_e[k]), k


def _restore_sequence(tiny, trainer, chunks):
    """Dispatches around a ``load_leaves``, a parameter moved to new
    storage and a ``restore``; the captures after each and the restored
    parameters at the end."""
    stats = graphs.stats
    params, opt = trainer.init(0)
    captures = []
    _dispatches(tiny, trainer, params, opt, chunks)
    captures.append(stats["captures"])
    opt.load_leaves([np.array(x) for x in opt.state_leaves()])
    captures.append(len(graphs.graphs(opt)))
    for _ in range(2):
        _dispatches(tiny, trainer, params, opt, chunks[:1])
        captures.append(stats["captures"])
    params["w_out"].data = params["w_out"].data.clone()
    _dispatches(tiny, trainer, params, opt, chunks)
    captures.append(stats["captures"])
    p2, o2 = trainer.restore(
        {k: v.copy() for k, v in lrcn.flat_tree(params).items()},
        [np.array(x) for x in opt.state_leaves()])
    _dispatches(tiny, trainer, p2, o2, chunks)
    captures.append(stats["captures"])
    captures.append(len(graphs.graphs(o2)))
    return p2, o2, captures


def test_restored_state_and_new_parameters_capture_anew(tiny, fake_cuda,
                                                        monkeypatch):
    """``load_leaves`` drops the optimizer's graphs (its next dispatch
    runs eagerly, then captures again), a parameter moved to new storage
    is a new signature, and ``restore`` makes a new optimizer with graphs
    of its own; the parameters and leaves at the end equal the eager
    twin's, bit for bit."""
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu", steps_per_dispatch=2)
    chunks = _chunks(tiny, trainer, 1) * 2
    p_g, o_g, captures = _restore_sequence(tiny, trainer, chunks)
    # captured, dropped, eager, captured, new storage, restored (1 graph)
    assert captures == [1, 0, 1, 2, 3, 4, 1]
    _eager_bodies(monkeypatch)
    monkeypatch.setattr(graphs, "stats", {"captures": 0, "replays": 0})
    p_e, o_e, _ = _restore_sequence(tiny, trainer, chunks)
    for k in PARAM_KEYS:
        assert torch.equal(p_g[k], p_e[k]), k
    assert _leaves_equal(o_g.state_leaves(), o_e.state_leaves())


def test_graphed_mid_epoch_resume_is_exact(tmp_path, monkeypatch, tiny,
                                           fake_cuda):
    """Graphed, dropout 0.4, K=2: killed after the second mid-epoch
    save, the resumed run (a new optimizer: its graphs captured anew)
    ends bit-equal to the uninterrupted one."""
    cfg = dataclasses.replace(tiny["cfg"], dropout=0.4)

    def trainer():
        return Trainer(cfg, tiny["vocab"], metrics=Recorder(), device="cpu",
                       steps_per_dispatch=2)

    t = trainer()
    full, _ = t.fit(*t.init(0), tiny["batches"], None, tiny["store"], None,
                    1, epochs=2, eval_train_loss=False)
    ckpt_dir = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        crash_after_saves(m, 2)
        t = trainer()
        with pytest.raises(Crash):
            t.fit(*t.init(0), tiny["batches"], None, tiny["store"], None, 1,
                  epochs=2, eval_train_loss=False, savefile=ckpt_dir,
                  ckpt_every=1)
    ck = torch_ckpt.load_checkpoint(ckpt_dir, CPU)
    t = trainer()
    resumed, _ = t.fit(*t.restore(ck["params"], ck["opt_leaves"]),
                       tiny["batches"], None, tiny["store"], None, 1,
                       epochs=2, eval_train_loss=False,
                       resume_position=ck["position"])
    for k in PARAM_KEYS:
        assert torch.equal(full[k], resumed[k]), k


def test_step_capture_error_raises_and_runs_no_eager_loop(tiny, fake_cuda):
    """A capture that fails raises out of the dispatch; the failed call
    leaves the parameters and Adam's state as they were (nothing ran in
    its place), and no graph is kept."""
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu", steps_per_dispatch=2)
    chunks = _chunks(tiny, trainer, 1)
    params, opt = trainer.init(0)
    _dispatches(tiny, trainer, params, opt, chunks)
    before = {k: params[k].detach().clone() for k in PARAM_KEYS}
    leaves = opt.state_leaves()
    fake_cuda.fail = True
    with pytest.raises(RuntimeError, match="capture failed"):
        _dispatches(tiny, trainer, params, opt, chunks)
    for k in PARAM_KEYS:
        assert torch.equal(params[k], before[k]), k
    assert _leaves_equal(opt.state_leaves(), leaves)
    assert graphs.graphs(opt) == [] and graphs.stats["replays"] == 0


# --- the joint step ---

JOINT_TINY = dict(hidden=(16, 16), embed=12, cnn_feature_dim=24,
                  vocab_size=30, dropout=0.4, compute_dtype="float32")


def test_joint_steps_graphed_equal_eager(fake_cuda, monkeypatch):
    """``JointTrainStep`` at ``test_torch_joint.py``'s tiny geometry (VGG at
    width 0.05), dropout 0.4, uint8 images: three K=2 ``multi_step``
    dispatches, three single steps and three ``eval_batch`` calls (eager,
    capture, replay each; the later ones on other images): losses, both
    parameter sets and the 80 optax leaves bit-equal to the eager
    twin's."""
    from lrcn_tpu_torch.config import LRCNConfig

    cfg = LRCNConfig(**JOINT_TINY)
    rng = np.random.default_rng(0)
    b, length = 2, 5
    images = rng.integers(0, 256, (3, 2, b, 224, 224, 3), np.uint8)
    tokens = rng.integers(3, 30, (2, b, length)).astype(np.int32)
    lengths = np.full((2, b), length, np.int32)
    vgg = lrcn.flat_tree(init_vgg_params(torch.Generator().manual_seed(1),
                                         width_multiplier=0.05, fc_dim=24))
    opt = joint.make_joint_optimizer(cfg)

    def run(step):
        params, state = step.init(3, vgg_params=vgg)
        out = []
        for d in range(3):
            chunk = step.shard_chunk(images[d], tokens, lengths)
            out.append(step.multi_step(params, state, *chunk, 11, 2 * d)[2])
        for d in range(3):
            batch = step.shard_batch(images[d, 0], tokens[0], lengths[0])
            out.append(step(params, state, *batch, fold_in(5, d))[2][None])
            out.append(torch.stack(step.eval_batch(params, *batch)))
        return out, params, state

    got, p_g, s_g = run(joint.JointTrainStep(cfg, opt, device="cpu"))
    assert graphs.stats == {"captures": 3, "replays": 6}
    _eager_bodies(monkeypatch)
    want, p_e, s_e = run(joint.JointTrainStep(cfg, opt, device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, b_ in zip(lrcn.flat_tree(p_g).values(),
                     lrcn.flat_tree(p_e).values()):
        np.testing.assert_array_equal(a, b_)
    assert len(s_g.state_leaves()) == 80
    assert _leaves_equal(s_g.state_leaves(), s_e.state_leaves())


# --- reloaded export programs ---


def test_exported_sample_program_graphed_equals_eager(sample_small,
                                                      fake_cuda, tmp_path):
    """A reloaded sample program (best-of-3, 4 words), called with seeds
    3, 5, 3, 5 in turn (eager, capture, replay, replay): each call's
    tokens and scores equal an eager call of the program's ``forward``
    under the same seed, and the call leaves the default generator as it
    was."""
    cfg, _, decoder, feats = sample_small
    words = [f"w{i}" for i in range(cfg.vocab_size - 3)]
    out = str(tmp_path / "frozen")
    export.save_exported(out, decoder, Vocab(words), variants=("sample",),
                         beam_width=3, max_words=4, sample_n=3,
                         temperature=1.5)
    model = export.load_exported(out, "cpu")
    program = model._fns["sample"]
    rows = torch.from_numpy(feats)
    for seed in (3, 5, 3, 5):
        state = torch.random.get_rng_state()
        tokens, scores = model.call("sample", feats, seed)
        assert torch.equal(torch.random.get_rng_state(), state)
        with torch.random.fork_rng(devices=[]), torch.inference_mode():
            torch.manual_seed(seed)
            want_t, want_s = program.module.forward(rows)
        assert torch.equal(tokens, want_t) and torch.equal(scores, want_s)
    assert graphs.stats == {"captures": 1, "replays": 3}
    (entry,) = graphs.graphs(program.module)
    assert entry.graph.generators == [torch.default_generator]
