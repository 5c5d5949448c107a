"""The port's one-program dispatch over a mesh (``utils/graphs.py`` under
``parallel/train.py``, ``train/trainer.py`` and ``models/joint.py``), on
the CPU, in a one-rank gloo group joined in this process.

On a card whose groups are NCCL, each sharded step, each ``Trainer``
dispatch and evaluation over a mesh and each joint step and evaluation
over a mesh runs eagerly at its first call of a signature, captures a
CUDA graph with its ``all_reduce``s at its second and replays it from
then on; under gloo they run their eager bodies.  Here:

- ``graphs.capturable`` is False for gloo groups and for CPU tensors,
  and the mesh paths under gloo capture nothing, even where
  ``graphs.enabled`` says yes (the stub of ``tests/test_torch_graphs.py``);
- the mesh bodies (dropout from generators seeded from the step keys)
  give the one-device ``Trainer``'s and ``JointTrainStep``'s losses,
  parameters and optax leaves, and JAX's ``ShardedTrainStep`` and
  ``JointTrainStep`` on a one-device mesh (f32; ``test_torch_parallel.py``'s
  tolerance for the decoder, ``test_torch_joint.py``'s for the joint
  step);
- with capture allowed (``graphs.capturable`` forced under the stub: a
  "capture" records the body's ops, the gloo ``all_reduce``s among them,
  and a "replay" runs them again), the graphed mesh paths equal their
  eager bodies bit for bit.

Sizes: the decoder of the JAX tests' small config (hidden (16, 12), embed
8), the joint step at ``tests/test_joint.py``'s widths with the CNN at
f32.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.utils._pytree import tree_leaves

from lrcn_tpu.models import joint as jax_joint
from lrcn_tpu.parallel import make_mesh as jax_make_mesh
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.data.batcher import bucket_batches
from lrcn_tpu_torch.models import joint, lrcn
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS
from lrcn_tpu_torch.parallel import distributed as pdist
from lrcn_tpu_torch.parallel import make_mesh
from lrcn_tpu_torch.parallel.pipeline import PipelinedTrainStep
from lrcn_tpu_torch.parallel.train import ShardedTrainStep
from lrcn_tpu_torch.train.trainer import Trainer, fold_in
from lrcn_tpu_torch.utils import graphs

from test_torch_graphs import FakeGraph, _stub_graph_api
from test_torch_joint import (assert_adam_close, jax_params, port_params,
                              tiny)  # noqa: F401
from test_torch_parallel import (GCLIP, PDROP, RUNS, SMALL, TOL, jax_run,
                                 make_batch, scenario)
from test_torch_train import Recorder, make_dataset

_Work = torch._C._distributed_c10d.Work


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A one-rank gloo group for the module's tests."""
    path = tmp_path_factory.mktemp("group") / "rendezvous"
    pdist.initialize(f"file://{path}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        pdist.shutdown()


def _waiting(func):
    """``func``, waiting for the collective work it returns
    (``dist.all_reduce`` waits outside the op a capture records)."""
    def call(*args, **kwargs):
        out = func(*args, **kwargs)
        for leaf in tree_leaves(out):
            if isinstance(leaf, _Work):
                leaf.wait()
        return out
    return call


class _WaitingGraph(FakeGraph):
    """The stub's graph, whose replay waits for each collective it runs."""

    def replay(self):
        recorded = self.ops
        self.ops = [(_waiting(func), *rest) for func, *rest in recorded]
        try:
            super().replay()
        finally:
            self.ops = recorded


def _allow_capture(monkeypatch):
    """The stubbed graph API, with capture allowed over gloo groups."""
    state = _stub_graph_api(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _WaitingGraph)
    monkeypatch.setattr(graphs, "capturable", lambda x, groups=(): True)
    return state


@pytest.fixture
def graphed(monkeypatch):
    return _allow_capture(monkeypatch)


def _eager(monkeypatch) -> None:
    """Every graphed entry point runs its eager body, the optimizers
    built before stay as they are: the eager twin of a graphed run."""
    monkeypatch.setattr(graphs, "capturable", lambda x, groups=(): False)


def _collectives(entry) -> list[str]:
    return [str(func) for func, *_ in entry.graph.ops
            if "allreduce" in str(func)]


def _leaves_equal(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


# --- when a mesh step is captured ---


def test_capturable_is_false_under_gloo_and_on_the_cpu(monkeypatch):
    """The predicate reads the device and the groups' backend: False for
    CPU tensors and for gloo groups, even where ``graphs.enabled`` says
    yes; a mesh step, its evaluation, a ``Trainer`` dispatch and a joint
    step under gloo then capture nothing.  The pipeline is never
    captured."""
    mesh = make_mesh((1, 1))
    groups = mesh.groups()
    assert len(groups) == 2 and mesh.distributed
    x = torch.zeros(2)
    assert not graphs.capturable(x) and not graphs.capturable(x, groups)
    _stub_graph_api(monkeypatch)
    assert graphs.capturable(x) and not graphs.capturable(x, groups)
    assert PipelinedTrainStep.capturable is False

    cfg = LRCNConfig(**dict(SMALL, dropout=PDROP, gclip=GCLIP))
    tree = lrcn.init_params(cfg, torch.Generator().manual_seed(5))
    batches = [make_batch(np.random.default_rng(3))]
    step = ShardedTrainStep(cfg, mesh)
    params = step.shard_params(tree)
    opt = step.init_opt(params)
    batch = step.shard_batch(*batches[0])
    for key in range(2):
        step(params, opt, *batch, key)
        step.eval_batch(params, *batch)
    trainer = Trainer(cfg, None, metrics=Recorder(), device="cpu",
                      steps_per_dispatch=2, mesh=mesh)
    table = torch.randn(4, cfg.cnn_feature_dim)
    tokens, lengths = (torch.from_numpy(np.stack([a, a])) for a in
                       batches[0][:2])
    rows = torch.zeros((2, 8), dtype=torch.int64)
    for d in range(2):
        trainer._dispatch(params, opt, tokens, lengths, rows, table, 1, d)
        trainer._eval(params, tokens, lengths, rows, table)
    assert graphs.stats == {"captures": 0, "replays": 0}
    assert graphs.graphs(opt) == [] and graphs.graphs(params) == []
    assert all(p.grad is None for p in params.values())


# --- the decoder trainer over a mesh ---


def _trainer_setup():
    vocab, caps, store = make_dataset(False, dim=SMALL["cnn_feature_dim"])
    cfg = LRCNConfig(**dict(SMALL, vocab_size=len(vocab), batch_size=4,
                            dropout=PDROP, gclip=GCLIP))
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    tree = lrcn.flat_tree(lrcn.init_params(cfg,
                                           torch.Generator().manual_seed(5)))
    return cfg, vocab, store, batches, tree


def _fit(mesh, steps_per_dispatch: int):
    """Two epochs of ``Trainer.fit`` from one tree (dropout 0.4, the clip
    engaged), on one device or over ``mesh``: the epoch records, the
    parameters and the 19 optax leaves."""
    cfg, vocab, store, batches, tree = _trainer_setup()
    rec = Recorder()
    trainer = Trainer(cfg, vocab, metrics=rec, device="cpu",
                      steps_per_dispatch=steps_per_dispatch, mesh=mesh)
    params, opt = trainer.restore(tree)
    params, opt = trainer.fit(params, opt, batches, batches, store, store, 3,
                              epochs=2)
    records = [(r["train_loss"], r["val_loss"]) for r in rec.records
               if r["event"] == "epoch"]
    return (records, {k: params[k].detach().numpy().copy()
                      for k in PARAM_KEYS}, opt.state_leaves(), opt, params,
            len(batches))


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_mesh_trainer_matches_one_device(steps_per_dispatch):
    """``Trainer.fit`` over a one-rank mesh (the sharded step's body, its
    dropout from generators seeded from the step keys, the K-batch mesh
    evaluation) against the one-device ``Trainer`` from the same tree:
    the epochs' losses, the parameters and the 19 optax leaves within
    ``test_torch_parallel.py``'s tolerance (the clip's norm sums the
    sharded and the replicated leaves apart)."""
    want_rec, want_p, want_l, *_ = _fit(None, steps_per_dispatch)
    got_rec, got_p, got_l, opt, params, n = _fit(make_mesh((1, 1)),
                                                 steps_per_dispatch)
    np.testing.assert_allclose(got_rec, want_rec, **TOL)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got_p[k], want_p[k], err_msg=k, **TOL)
    assert len(got_l) == 19 and int(got_l[0]) == 2 * n
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, **TOL)
    assert all(p.grad is None for p in params.values())


def test_graphed_mesh_trainer_equals_eager(graphed, monkeypatch):
    """With capture allowed, ``Trainer.fit`` over the mesh (K=2: its
    dispatches, the tail's single steps and the K-batch evaluations each
    eager, captured, then replayed) equals the eager mesh run bit for bit:
    the epochs' losses, the parameters and the 19 leaves; the graphs hold
    the gloo ``all_reduce``s, and ``shutdown`` drops them."""
    got_rec, got_p, got_l, opt, params, _ = _fit(make_mesh((1, 1)), 2)
    assert graphs.stats["captures"] >= 3
    assert graphs.stats["replays"] > graphs.stats["captures"]
    dispatches = graphs.graphs(opt)
    assert dispatches and all(_collectives(e) for e in dispatches)
    assert all(_collectives(e) for e in graphs.graphs(params))
    assert opt in graphs._collective_owners
    _eager(monkeypatch)
    want_rec, want_p, want_l, *_ = _fit(make_mesh((1, 1)), 2)
    assert got_rec == want_rec
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    assert _leaves_equal(got_l, want_l)
    graphs.forget_collectives()
    assert graphs.graphs(opt) == [] and graphs.graphs(params) == []


def test_mesh_load_leaves_drops_the_graphs(graphed):
    """Restored leaves are new state: ``load_leaves`` drops the sharded
    optimizer's graphs, and its next step runs eagerly."""
    kw, _, _, tree, batches, _, _ = scenario(PDROP, GCLIP)
    step = ShardedTrainStep(LRCNConfig(**kw), make_mesh((1, 1)))
    params = step.shard_params(tree)
    opt = step.init_opt(params)
    batch = step.shard_batch(*batches[0])
    for key in range(3):
        step(params, opt, *batch, key)
    assert len(graphs.graphs(opt)) == 1
    opt.load_leaves(opt.state_leaves())
    assert graphs.graphs(opt) == []
    step(params, opt, *batch, 3)
    assert graphs.graphs(opt) == [] and graphs.stats["captures"] == 1


# --- the sharded step against JAX ---


@functools.lru_cache(maxsize=None)
def _jax_one_device(pdrop, gclip):
    return jax_run((1, 1), pdrop, gclip)


@pytest.mark.parametrize("dispatch", ["eager", "graphed"])
@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_matches_jax_on_one_device(name, dispatch, monkeypatch):
    """Three steps of ``ShardedTrainStep.step`` on the one-rank mesh, with
    JAX's masks injected (graph inputs where captured: eager, capture,
    replay), against JAX's ``ShardedTrainStep`` on a one-device mesh:
    the losses of its first two steps, and after them the parameters and
    the 19 optax leaves; the third step replays."""
    pdrop, gclip = RUNS[name]
    want = _jax_one_device(pdrop, gclip)
    if dispatch == "graphed":
        _allow_capture(monkeypatch)
    kw, _, _, tree, batches, _, masks = scenario(pdrop, gclip)
    step = ShardedTrainStep(LRCNConfig(**kw), make_mesh((1, 1)))
    params = step.shard_params(tree)
    opt = step.init_opt(params)
    losses = []
    for i, batch in enumerate(batches):
        m = None if masks[i] is None else tuple(map(torch.from_numpy,
                                                    masks[i]))
        params, opt, loss = step(params, opt, *step.shard_batch(*batch), i,
                                 drop_masks=m)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want["losses"], **TOL)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   want["params"][k], err_msg=k, **TOL)
    leaves = opt.state_leaves()
    assert len(leaves) == len(want["opt_leaves"]) == 19
    for a, b in zip(leaves, want["opt_leaves"]):
        np.testing.assert_allclose(a, b, **TOL)
    if dispatch == "graphed":
        (entry,) = graphs.graphs(opt)
        assert entry.replays == 1 and _collectives(entry)
        m = None if masks[0] is None else tuple(map(torch.from_numpy,
                                                    masks[0]))
        step(params, opt, *step.shard_batch(*batches[0]), 2, drop_masks=m)
        assert entry.replays == 2 and graphs.stats["captures"] == 1


# --- the joint step over a mesh ---


JOINT_ROWS = slice(4, 8)     # four of the tiny batch's rows, its filler


def _joint_run(tiny, mesh, calls: int):
    """``calls`` K=2 ``multi_step`` dispatches, single steps and
    ``eval_batch`` calls each from ``tiny``'s parameters, dropout 0.4,
    each call on other images: the losses and evaluations, the
    parameters and the 80 optax leaves."""
    cfg = dataclasses.replace(tiny["cfg"], dropout=0.4)
    step = joint.JointTrainStep(cfg, joint.make_joint_optimizer(cfg),
                                device="cpu", mesh=mesh)
    params = port_params(tiny)
    state = step.opt.init(params)
    tokens, lengths = (a[JOINT_ROWS] for a in tiny["batch"][1:])
    rng = np.random.default_rng(4)
    pixels = rng.integers(0, 256, (calls, 2, len(tokens), 224, 224, 3),
                          np.uint8)
    out = []
    for d in range(calls):
        chunk = step.shard_chunk(pixels[d], np.stack([tokens] * 2),
                                 np.stack([lengths] * 2))
        out.append(step.multi_step(params, state, *chunk, 11, 2 * d)[2])
    for d in range(calls):
        batch = step.shard_batch(pixels[d, 0], tokens, lengths)
        out.append(step(params, state, *batch, fold_in(5, d))[2][None])
        out.append(torch.stack(step.eval_batch(params, *batch)))
    return out, lrcn.flat_tree(params), state


def test_mesh_joint_step_matches_one_device(tiny):
    """``JointTrainStep`` over the one-rank mesh (global masks drawn from
    generators seeded from the step keys, the gradients summed over
    ``data``) against the one-device step from the same parameters,
    dropout 0.4: losses, evaluations, both parameter sets and the 80
    optax leaves within ``test_torch_parallel.py``'s tolerance."""
    got, got_p, got_s = _joint_run(tiny, make_mesh((1, 1)), 1)
    want, want_p, want_s = _joint_run(tiny, None, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], err_msg=k, **TOL)
    assert len(got_s.state_leaves()) == 80
    for a, b in zip(got_s.state_leaves(), want_s.state_leaves()):
        np.testing.assert_allclose(a, b, **TOL)


def test_graphed_mesh_joint_step_equals_eager(tiny, graphed, monkeypatch):
    """With capture allowed, the joint step over the mesh (its K=2
    dispatch, single step and evaluation each called eagerly, then
    captured and replayed) equals the eager mesh run bit for bit, and its
    step graphs hold the ``all_reduce``s."""
    got, got_p, got_s = _joint_run(tiny, make_mesh((1, 1)), 2)
    assert graphs.stats["captures"] == 3
    entries = graphs.graphs(got_s)
    assert len(entries) == 2 and all(_collectives(e) for e in entries)
    _eager(monkeypatch)
    want, want_p, want_s = _joint_run(tiny, make_mesh((1, 1)), 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    assert _leaves_equal(got_s.state_leaves(), want_s.state_leaves())


def test_mesh_joint_step_matches_jax(tiny):
    """Two steps of ``JointTrainStep`` over the one-rank mesh against JAX's
    ``JointTrainStep`` on a one-device mesh, no dropout, f32: the losses
    within 1e-5 and the parameters as ``test_torch_joint.py`` holds the
    one-device step (``assert_adam_close``)."""
    jcfg = tiny["jcfg"]
    jopt = jax_joint.make_joint_optimizer(jcfg)
    jmesh = jax_make_mesh((1, 1))
    jstep = jax_joint.JointTrainStep(jcfg, jopt, mesh=jmesh)
    jp = jax.device_put(jax_params(tiny), NamedSharding(jmesh, P()))
    jstate = jopt.init(jp)
    cfg = tiny["cfg"]
    step = joint.JointTrainStep(cfg, joint.make_joint_optimizer(cfg),
                                device="cpu", mesh=make_mesh((1, 1)))
    params = port_params(tiny)
    state = step.opt.init(params)
    images, tokens, lengths = tiny["batch"]
    for i in range(2):
        jp, jstate, jloss = jstep(jp, jstate,
                                  *jstep.shard_batch(images, tokens, lengths),
                                  jax.random.PRNGKey(i))
        params, state, loss = step(params, state,
                                   *step.shard_batch(images, tokens, lengths),
                                   i)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    want = lrcn.flat_tree(jax.tree.map(np.asarray, jp))
    assert_adam_close(lrcn.flat_tree(params), want)
