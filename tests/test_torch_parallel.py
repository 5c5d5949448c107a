"""The port's mesh and sharded training step against the JAX package, on
the CPU.

The JAX side runs on the pytest process's 8 virtual CPU devices with the
JAX package's own ``ShardedTrainStep``; the port side runs one gloo rank
per mesh entry, each a fresh interpreter (``parallel.dryrun.spawn``,
``tests/torch_parallel_ranks.py``), from the same parameters and the same
global batches, with JAX's dropout masks injected.  f32 tolerances: rtol
1e-5, atol 1e-6 (the same operations, f32 sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig as JaxConfig
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.parallel import ShardedTrainStep as JaxShardedTrainStep
from lrcn_tpu.parallel import make_mesh as jax_make_mesh
from lrcn_tpu.train.trainer import make_optimizer as jax_make_optimizer
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, flat_tree
from lrcn_tpu_torch.parallel import distributed as pdist
from lrcn_tpu_torch.parallel import make_mesh
from lrcn_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from lrcn_tpu_torch.parallel.train import ShardedTrainStep

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(hidden=(16, 12), embed=8, cnn_feature_dim=10, vocab_size=24,
             batch_size=8, lr=1e-2, compute_dtype="float32", seed=7)
PDROP = 0.4
GCLIP = 0.05          # engages: the first step's norm reads ~0.4
RANKS = "torch_parallel_ranks"


def make_batch(rng, batch=8, length=7, vocab=24, dim=10):
    tokens = rng.integers(3, vocab, (batch, length)).astype(np.int32)
    lengths = rng.integers(1, length + 1, (batch,)).astype(np.int32)
    lengths[0] = -1           # a filler row: no tokens on its rank
    for i, n in enumerate(lengths):
        tokens[i, max(n, 0):] = 0
    feats = rng.standard_normal((batch, dim)).astype(np.float32)
    return tokens, lengths, feats


def jax_masks(key, t_dim, b_dim, e_dim, f2):
    """The dropout multipliers ``lrcn_tpu`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    keep = 1.0 - PDROP
    m1 = jax.random.bernoulli(k1, keep, (t_dim, b_dim, e_dim)) / keep
    m2 = jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
    return np.asarray(m1, np.float32), np.asarray(m2, np.float32)


def scenario(pdrop: float, gclip: float = 0.0):
    """Both packages' configs, the initial tree, two global batches and
    the step keys with their masks."""
    kw = dict(SMALL, dropout=pdrop, gclip=gclip)
    jcfg = JaxConfig(**kw)
    params = jax_lrcn.init_params(jax.random.PRNGKey(0), jcfg)
    tree = flat_tree(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    batches = [make_batch(rng) for _ in range(2)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    masks = [jax_masks(k, 8, 8, jcfg.embed, 2 * jcfg.factor_dim)
             if pdrop else None for k in keys]
    return kw, jcfg, params, tree, batches, keys, masks


@functools.lru_cache(maxsize=None)
def jax_grads(pdrop, gclip):
    """JAX's gradients of the first step on one device (the global
    loss)."""
    _, _, params, _, batches, keys, _ = scenario(pdrop, gclip)
    grads = jax.jit(jax.grad(jax_lrcn.loss_fn),
                    static_argnames=("pdrop", "compute_dtype"))(
        params, *batches[0], pdrop=pdrop, rng=keys[0],
        compute_dtype=jnp.float32)
    return flat_tree(jax.tree.map(np.asarray, grads))


def jax_run(mesh_shape, pdrop, gclip=0.0):
    """JAX's gradients of the first step, its sharded losses and
    parameters after two steps, and its optimizer state's leaves (global
    and the first device's shard)."""
    kw, jcfg, params, tree, batches, keys, masks = scenario(pdrop, gclip)
    step = JaxShardedTrainStep(jcfg, jax_make_optimizer(jcfg),
                               jax_make_mesh(mesh_shape))
    p = step.shard_params(params)
    o = step.init_opt(p)
    losses = []
    for batch, key in zip(batches, keys):
        p, o, loss = step(p, o, *step.shard_batch(*batch), key)
        losses.append(float(loss))
    leaves = jax.tree.leaves(o)
    return {"grads": jax_grads(pdrop, gclip),
            "losses": losses,
            "params": flat_tree(jax.tree.map(np.asarray, p)),
            "opt_leaves": [np.asarray(x) for x in leaves],
            "shard_shapes": [x.addressable_shards[0].data.shape
                             for x in leaves],
            "param_shard_shapes": {
                k: v.addressable_shards[0].data.shape for k, v in
                flat_tree_arrays(p).items()}}


def flat_tree_arrays(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree_arrays(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# JAX's masks with the clip engaged (a wrong clip or mask would part the
# parameters from JAX's)
RUNS = {"no dropout": (0.0, 0.0), "jax masks, clipped": (PDROP, GCLIP)}


@pytest.fixture(scope="module", params=[(2, 1), (1, 2), (2, 2)],
                ids=lambda s: f"mesh{s[0]}x{s[1]}")
def runs(request):
    """Each scenario of ``RUNS`` on the port (one group of ranks) and on
    JAX, at one mesh shape."""
    shape = request.param
    port_args = []
    for pdrop, gclip in RUNS.values():
        kw, _, _, tree, batches, _, masks = scenario(pdrop, gclip)
        port_args.append(dict(cfg_kwargs=kw, tree=tree, batches=batches,
                              masks=masks, mesh_shape=shape))
    port = spawn(f"{RANKS}:train_runs", shape[0] * shape[1], port_args,
                 timeout=150)
    jax_side = {name: jax_run(shape, *args) for name, args in RUNS.items()}
    return shape, port, jax_side


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_matches_jax(runs, name):
    """Loss, every gradient of the first step and the parameters after two
    steps, on every rank, against JAX's ``ShardedTrainStep`` on the same
    mesh shape (with the clip engaged in the masked case)."""
    shape, port, jax_side = runs
    i = list(RUNS).index(name)
    want = jax_side[name]
    for rank_out in port:
        got = rank_out[i]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        for k in PARAM_KEYS:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                       err_msg=k, **TOL)
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       err_msg=k, **TOL)
        assert len(got["opt_leaves"]) == len(want["opt_leaves"]) == 19
        for a, b in zip(got["opt_leaves"], want["opt_leaves"]):
            assert np.shape(a) == np.shape(b)
            np.testing.assert_allclose(a, b, **TOL)


def test_rank_shapes_match_jax_shards(runs):
    """Each rank's parameters and optimizer leaves have the shapes of
    JAX's addressable shards on the same mesh."""
    shape, port, jax_side = runs
    want = jax_side["no dropout"]
    for rank_out in port:
        got = rank_out[0]
        assert got["local_shapes"] == {
            k: tuple(v) for k, v in want["param_shard_shapes"].items()}
        assert [tuple(s) for s in got["local_leaf_shapes"]] == [
            tuple(s) for s in want["shard_shapes"]]
    coords = sorted(r[0]["coords"] for r in port)
    assert coords == [(d, m) for d in range(shape[0])
                      for m in range(shape[1])]


def test_clip_engages(runs):
    """gclip = 0.05 sits below the first step's global gradient norm, so
    the clipped case's update is the rescaled one (and matches JAX's
    above); the norm the port's ranks see is JAX's."""
    _, port, jax_side = runs
    for name in RUNS:
        grads = jax_side[name]["grads"]
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads.values()))
        got = port[0][list(RUNS).index(name)]["grads"]
        got_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in got.values()))
        np.testing.assert_allclose(got_norm, norm, rtol=1e-5)
        assert norm > 2 * GCLIP


def test_eval_batch_is_the_global_sum(runs):
    """``eval_batch`` returns the global NLL sum and token count on every
    rank."""
    _, port, _ = runs
    counts = {r[0]["eval"][1] for r in port}
    totals = [r[0]["eval"][0] for r in port]
    _, _, _, _, batches, _, _ = scenario(0.0)
    assert counts == {float(np.maximum(batches[0][1] + 1, 0).sum())}
    np.testing.assert_allclose(totals, totals[0], rtol=1e-6)


# --- the mesh ---


def test_make_mesh_shapes_and_errors_match_jax():
    cpu = [torch.device("cpu")] * 8
    mesh = make_mesh((-1, 2), devices=cpu)
    jmesh = jax_make_mesh((-1, 2))
    assert tuple(mesh.shape.values()) == jmesh.devices.shape == (4, 2)
    assert mesh.axis_names == jmesh.axis_names == ("data", "model")
    assert mesh.shape["data"] == jmesh.shape["data"] == 4
    for shape in [(16, 1), (-1, 3), (-1, -1)]:
        with pytest.raises(ValueError) as port_err:
            make_mesh(shape, devices=cpu)
        with pytest.raises(ValueError) as jax_err:
            jax_make_mesh(shape)
        assert str(port_err.value) == str(jax_err.value)
    # one device listed twice: two shards of their own
    twice = make_mesh((2, 1), devices=["cpu", "cpu"])
    assert twice.data_devices() == [torch.device("cpu")] * 2
    assert not twice.distributed


def test_vocab_divisibility_error():
    cfg = LRCNConfig(**dict(SMALL, vocab_size=25))
    with pytest.raises(ValueError, match="must be divisible by the 'model'"):
        ShardedTrainStep(cfg, make_mesh((1, 2), devices=["cpu"] * 2))


def test_training_mesh_needs_a_rank_per_entry():
    cfg = LRCNConfig(**SMALL)
    with pytest.raises(ValueError, match="needs 2 processes"):
        ShardedTrainStep(cfg, make_mesh((2, 1), devices=["cpu"] * 2))


# --- the multi-process helpers ---


def test_distributed_helpers_in_a_two_rank_group():
    """``host_local_batch`` (each rank's rows reach the global sum: 3*4*1
    + 3*4*2 = 36), ``gather_to_host`` (a column shard gathered), one
    ``shared_seed`` on both ranks and explicit seeds passed through,
    ``is_primary`` on rank 0 alone, and the barrier."""
    out = spawn(f"{RANKS}:helpers", 2, ["a", "b"], timeout=90)
    assert [o["total"] for o in out] == [36.0, 36.0]
    for o in out:
        np.testing.assert_array_equal(
            o["gathered"], [[0, 1, 2, 3, 10, 11, 12, 13]])
    assert out[0]["seed"] == out[1]["seed"] is not None
    assert 0 <= out[0]["seed"] < 2 ** 31
    assert [o["explicit"] for o in out] == [41, 41]
    assert [o["primary"] for o in out] == [True, False]
    assert [o["values"] for o in out] == ["a", "b"]


def test_single_process_helpers():
    assert pdist.process_count() == 1 and pdist.is_primary()
    assert pdist.shared_seed(None) is None and pdist.shared_seed(5) == 5
    pdist.barrier("noop")
    mesh = make_mesh((1, 1), devices=["cpu"])
    got = pdist.gather_to_host({"a": torch.ones(2)}, mesh)
    np.testing.assert_array_equal(got["a"], [1, 1])


def test_initialize_single_worker_markers_stay_single_process(monkeypatch):
    """Single-worker markers (torchrun's WORLD_SIZE=1,
    SLURM_JOB_NUM_NODES=1) do not start a group; counts above 1 do."""
    from lrcn_tpu_torch.parallel.distributed import _cluster_environment

    for var in ("WORLD_SIZE", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    assert not _cluster_environment()
    pdist.initialize()              # a no-op: still one process
    assert pdist.process_count() == 1
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert _cluster_environment()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert _cluster_environment()
    with pytest.raises(ValueError, match="all of --coordinator"):
        pdist.initialize("127.0.0.1:1", None, None, backend="gloo")


def test_dryrun_multichip_runs_four_ranks():
    """The counterpart of ``__graft_entry__.py:dryrun_multichip(4)``: one
    (2, 2) sharded step and one pipelined step, finite and equal losses
    on every rank."""
    out = dryrun_multichip(4, timeout=120)
    assert out["mesh"] == (2, 2)
    assert np.isfinite(out["loss"]) and np.isfinite(out["pipeline_loss"])
