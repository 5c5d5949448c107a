"""The port's decoder training against the JAX package, on the CPU: the
loss and its gradients, the optimizer against optax, ``Trainer.fit``,
checkpoints that either package writes and the other resumes, and the
port's own resume, best-file and crash-safety checks.

Both packages get the same parameters (``lrcn_tpu.models.lrcn.init_params``
converted with ``LRCNParams.from_numpy``), batches and features; dropout
masks are drawn by JAX and injected into the port.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lrcn_tpu.config import LRCNConfig as JaxConfig
from lrcn_tpu.core.tokenizer import Caption as JaxCaption
from lrcn_tpu.core.vocab import Vocab as JaxVocab
from lrcn_tpu.data import FeatureStore as JaxStore
from lrcn_tpu.data import bucket_batches as jax_bucket_batches
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.ops import lstm as jax_lstm
from lrcn_tpu.train import Trainer as JaxTrainer
from lrcn_tpu.train import checkpoint as jax_ckpt
from lrcn_tpu.train.metrics import MetricsLogger as JaxMetrics
from lrcn_tpu.train.trainer import make_optimizer as jax_make_optimizer
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.tokenizer import Caption
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data import FeatureStore, bucket_batches
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams
from lrcn_tpu_torch.ops import lstm
from lrcn_tpu_torch.train import checkpoint as torch_ckpt
from lrcn_tpu_torch.train import trainer as trainer_mod
from lrcn_tpu_torch.train.metrics import MetricsLogger
from lrcn_tpu_torch.train.trainer import Optimizer, Trainer, fold_in

CPU = torch.device("cpu")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


class Recorder(MetricsLogger):
    """A metrics logger that keeps its records."""

    def __init__(self):
        super().__init__(echo=False)
        self.records = []

    def log(self, **values):
        self.records.append(super().log(**values))
        return self.records[-1]


class JaxRecorder(JaxMetrics):
    def __init__(self):
        super().__init__(echo=False)
        self.records = []

    def log(self, **values):
        self.records.append(super().log(**values))
        return self.records[-1]


def make_dataset(jax_side: bool, n_images=12, vocab_words=15, dim=24,
                 seed=0):
    """``tests/test_train.py``'s synthetic set (the caption is a function
    of the feature), built with either package's classes."""
    vocab_cls, cap_cls, store_cls = ((JaxVocab, JaxCaption, JaxStore)
                                     if jax_side
                                     else (Vocab, Caption, FeatureStore))
    rng = np.random.default_rng(seed)
    vocab = vocab_cls([f"w{i}" for i in range(vocab_words)])
    caps, store = [], store_cls(dim=dim)
    for i in range(n_images):
        kind = i % 3
        text = {0: ("w0", "w1", "w2"), 1: ("w3", "w4", "w5", "w6"),
                2: ("w7", "w8")}[kind]
        caps.append(cap_cls(i, text))
        feat = np.zeros(dim, np.float32)
        feat[kind * 8:(kind + 1) * 8] = 1.0
        feat += rng.normal(scale=0.01, size=dim).astype(np.float32)
        store.add(i, feat)
    return vocab, caps, store


TINY = dict(hidden=(32, 32), embed=16, cnn_feature_dim=24, epochs=40,
            batch_size=4, dropout=0.0, lr=1e-2, seed=11)


@pytest.fixture(scope="module")
def tiny():
    """Both packages' copies of ``tests/test_train.py``'s tiny setup."""
    vocab, caps, store = make_dataset(False)
    jvocab, jcaps, jstore = make_dataset(True)
    cfg = LRCNConfig(vocab_size=len(vocab), **TINY)
    jcfg = JaxConfig(vocab_size=len(jvocab), **TINY)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    jbatches = jax_bucket_batches(jcaps, jvocab, cfg.batch_size,
                                  apply_small_dataset_rule=False)
    return dict(cfg=cfg, vocab=vocab, store=store, batches=batches,
                jcfg=jcfg, jvocab=jvocab, jstore=jstore, jbatches=jbatches)


def jax_params(cfg, seed=0):
    params = jax_lrcn.init_params(jax.random.PRNGKey(seed), cfg)
    return params, {k: np.asarray(v) for k, v in
                    lrcn.flat_tree(jax.tree.map(np.asarray, params)).items()}


def to_flat(tree) -> dict[str, np.ndarray]:
    return lrcn.flat_tree(jax.tree.map(np.asarray, tree))


def rel_err(got, want) -> float:
    """max |got - want| relative to max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- ops and model ---


@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(rtol=1e-5, atol=1e-6)),
    # the same bf16-rounded operands, f32 sums in another order
    ("bfloat16", dict(rtol=0, atol=1e-4))])
def test_lstm_recurrent_gates_matches_jax(dtype, tol):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x_dim, h_dim, b_dim = 6, 5, 3
    w, b, h, x = (rng.standard_normal(s).astype(np.float32) for s in
                  ((x_dim + h_dim, 4 * h_dim), (4 * h_dim,),
                   (b_dim, h_dim), (b_dim, x_dim)))
    x_proj = x @ w[:x_dim]
    want = jax_lstm.lstm_recurrent_gates(w, b, h, x_proj, x_dim,
                                         compute_dtype=jdt)
    got = lstm.lstm_recurrent_gates(
        *map(torch.from_numpy, (w[x_dim:], b, h, x_proj)), compute_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_matmul_is_differentiable_on_the_cpu_routes():
    """Both CPU routes carry gradients back to float32 operands, bf16 as
    a bf16-rounded product (the cast's transpose)."""
    rng = np.random.default_rng(1)
    a_np, w_np = (rng.standard_normal(s).astype(np.float32)
                  for s in ((4, 6), (6, 3)))
    g = rng.standard_normal((4, 3)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.tensor(a_np, requires_grad=True)
        w = torch.tensor(w_np, requires_grad=True)
        out = lstm.matmul(a, w, dtype)
        assert out.dtype == torch.float32
        out.backward(torch.from_numpy(g))
        want_a = (g @ w_np.astype(np.float32).T if dtype == torch.float32
                  else torch.tensor(g @ torch.tensor(w_np).bfloat16().float()
                                    .numpy().T).bfloat16().float().numpy())
        np.testing.assert_allclose(a.grad.numpy(), want_a, rtol=1e-6,
                                   atol=1e-6)
        assert a.grad.dtype == w.grad.dtype == torch.float32


def test_bf16_cuda_matmul_backward_shapes():
    """The bf16 CUDA route's autograd Function, traced on ``meta`` tensors
    (its forward is ``torch.mm(..., out_dtype=float32)``, which has no CPU
    kernel here and no derivative): f32 out; bf16 gradients of the
    operands' shapes; none for an operand that needs none."""
    a = torch.empty((5, 7), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.empty((7, 3), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    out = lstm._MatmulF32Out.apply(a, w)
    assert out.dtype == torch.float32 and out.shape == (5, 3)
    out.backward(torch.empty((5, 3), device="meta"))
    assert a.grad.shape == a.shape and w.grad.shape == w.shape
    assert a.grad.dtype == w.grad.dtype == torch.bfloat16
    frozen = w.detach()
    a.grad = None
    lstm._MatmulF32Out.apply(a, frozen).backward(
        torch.empty((5, 3), device="meta"))
    assert a.grad.shape == a.shape and frozen.grad is None


def test_init_params_layout_matches_jax():
    """Same shapes as the JAX package's parameters, forget-gate biases 1,
    xavier bounds; drawn from the generator (same seed, same values)."""
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    _, jflat = jax_params(jcfg)
    params = lrcn.init_params(cfg, torch.Generator().manual_seed(3))
    again = lrcn.init_params(cfg, torch.Generator().manual_seed(3))
    assert set(params.keys()) == set(jflat) == set(PARAM_KEYS)
    for k in PARAM_KEYS:
        assert tuple(params[k].shape) == jflat[k].shape, k
        assert params[k].dtype == torch.float32 and params[k].requires_grad
        torch.testing.assert_close(params[k], again[k], rtol=0, atol=0)
    for n, h in (("lstm1", 16), ("lstm2", 12)):
        b = params[f"{n}/b"].detach().numpy()
        assert (b[:h] == 1).all() and (b[h:] == 0).all()
    w = params["w_out"].detach().numpy()
    assert np.abs(w).max() <= np.sqrt(6 / sum(w.shape))
    assert lrcn.param_count(params) == jax_lrcn.param_count(
        jax_lrcn.init_params(jax.random.PRNGKey(0), jcfg))


def loss_inputs(seed=0):
    """A (6, 5) batch with one filler row (length -1) and one full row."""
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 25, (6, 5)).astype(np.int32)
    lengths = np.array([5, 3, 1, -1, 4, 2], np.int32)
    for i, n in enumerate(lengths):
        tokens[i, max(n, 0):] = 0
    feats = rng.standard_normal((6, 10)).astype(np.float32)
    return jcfg, tokens, lengths, feats


def jax_masks(rng_key, pdrop, t_dim, b_dim, e_dim, f2):
    """The dropout multipliers ``lrcn_tpu`` draws from ``rng_key``
    (models/lrcn.py:209-217)."""
    k1, k2 = jax.random.split(rng_key)
    keep = 1.0 - pdrop
    m1 = jax.random.bernoulli(k1, keep, (t_dim, b_dim, e_dim)) / keep
    m2 = (jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
          ).astype(jnp.float32)
    return np.asarray(m1, np.float32), np.asarray(m2)


@pytest.mark.parametrize("pdrop", [0.0, 0.4])
def test_loss_total_count_matches_jax(pdrop):
    """f32, filler row included; rtol 1e-5 (the same operations, f32 sums
    in another order)."""
    jcfg, tokens, lengths, feats = loss_inputs()
    params, flat = jax_params(jcfg)
    key = jax.random.PRNGKey(5)
    want_t, want_c = jax_lrcn.loss_total_count(
        params, tokens, lengths, feats, pdrop=pdrop, rng=key,
        compute_dtype=jnp.float32)
    masks = None
    if pdrop:
        masks = tuple(map(torch.from_numpy, jax_masks(
            key, pdrop, 6, 6, 8, 2 * jcfg.factor_dim)))
    got_t, got_c = lrcn.loss_total_count(
        LRCNParams.from_numpy(flat, CPU), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.from_numpy(feats), pdrop=pdrop,
        drop_masks=masks, compute_dtype=torch.float32)
    assert float(got_c) == float(want_c) == float(np.maximum(
        lengths + 1, 0).sum())
    np.testing.assert_allclose(got_t.item(), float(want_t), rtol=1e-5)


def test_filler_rows_drop_out_of_the_loss():
    """A filler row (length -1) changes neither the total nor the count."""
    jcfg, tokens, lengths, feats = loss_inputs()
    params = LRCNParams.from_numpy(jax_params(jcfg)[1], CPU)
    keep = lengths >= 0
    args = dict(compute_dtype=torch.float32)
    full = lrcn.loss_total_count(params, *map(torch.from_numpy, (
        tokens, lengths, feats)), **args)
    real = lrcn.loss_total_count(params, *map(torch.from_numpy, (
        tokens[keep], lengths[keep], feats[keep])), **args)
    torch.testing.assert_close(full[0], real[0], rtol=1e-6, atol=0)
    assert float(full[1]) == float(real[1])


@pytest.mark.parametrize("dtype,pdrop,tol", [
    # f32: the same operations, sums in another order
    ("float32", 0.0, 1e-4), ("float32", 0.4, 1e-4),
    # bf16: both round operands and each step's weight gradient to bf16 at
    # the same casts and sum the steps in f32; these inputs read 2e-7 and
    # 1e-7.  Over 8 seeds the worst reading was 6.2e-4 (an f32 sum in
    # another order rounding one operand to the neighbouring bf16 value)
    ("bfloat16", 0.0, 1e-3), ("bfloat16", 0.4, 1e-3)])
def test_grads_match_jax(dtype, pdrop, tol):
    """Every parameter's gradient of ``loss_fn`` against ``jax.grad``,
    max |difference| relative to max |JAX gradient| of that parameter;
    the loss within 1e-5 (f32) or 1e-4 (bf16, a flipped bf16 rounding)."""
    tdt, jdt = DTYPES[dtype]
    jcfg, tokens, lengths, feats = loss_inputs(1)
    params, flat = jax_params(jcfg, seed=2)
    key = jax.random.PRNGKey(9)
    want_loss, want = jax.value_and_grad(jax_lrcn.loss_fn)(
        params, tokens, lengths, feats, pdrop=pdrop, rng=key,
        compute_dtype=jdt)
    want = to_flat(want)
    masks = None
    if pdrop:
        masks = tuple(map(torch.from_numpy, jax_masks(
            key, pdrop, 6, 6, 8, 2 * jcfg.factor_dim)))
    p = LRCNParams.from_numpy(flat, CPU)
    loss = lrcn.loss_fn(p, torch.from_numpy(tokens),
                        torch.from_numpy(lengths), torch.from_numpy(feats),
                        pdrop=pdrop, drop_masks=masks, compute_dtype=tdt)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=1e-5 if dtype == "float32" else 1e-4)
    for k in PARAM_KEYS:
        assert rel_err(p[k].grad.numpy(), want[k]) <= tol, (
            k, rel_err(p[k].grad.numpy(), want[k]))


def test_dropout_draws_from_the_generator():
    """Without injected masks the multipliers come from the generator: the
    same seed gives the same loss, another seed another; each multiplier
    is 0 or 1/keep."""
    jcfg, tokens, lengths, feats = loss_inputs()
    p = LRCNParams.from_numpy(jax_params(jcfg)[1], CPU)
    args = [torch.from_numpy(a) for a in (tokens, lengths, feats)]
    run = lambda seed: float(lrcn.loss_fn(
        p, *args, pdrop=0.4, generator=torch.Generator().manual_seed(seed),
        compute_dtype=torch.float32))
    assert run(1) == run(1) != run(2)
    m1, m2 = lrcn.dropout_masks((7, 6, 8), (7, 6, 12), 0.4,
                                torch.Generator().manual_seed(0))
    for m in (m1, m2):
        assert set(np.unique(m.numpy())) <= {0.0, np.float32(1 / 0.6)}
    with pytest.raises(ValueError, match="generator"):
        lrcn.loss_fn(p, *args, pdrop=0.4)


def test_decoder_from_params_equals_params_from_numpy():
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    _, flat = jax_params(jcfg)
    p = LRCNParams.from_numpy(flat, CPU)
    for dtype in (torch.float32, torch.bfloat16):
        got = p.decoder(dtype)
        want = lrcn.params_from_numpy(flat, CPU, dtype)
        for k in PARAM_KEYS:
            assert torch.equal(got[k], want[k]), k
        # a copy: training the parameters leaves the decoder as it was
        before = got["w_out"].clone()
        with torch.no_grad():
            p["w_out"].add_(1.0)
        assert torch.equal(got["w_out"], before)
        with torch.no_grad():
            p["w_out"].sub_(1.0)


# --- optimizer ---


def _optimizer_runs(gclip, grads_np, params_np, steps):
    """The port's Optimizer and optax's chain over the same grads."""
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25, lr=1e-2, gclip=gclip)
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25, lr=1e-2, gclip=gclip)
    tx = jax_make_optimizer(jcfg)
    jp = jax_ckpt._unflatten_params(params_np)
    state = tx.init(jp)
    p = LRCNParams.from_numpy(params_np, CPU)
    opt = Optimizer(p, cfg)
    for s in range(steps):
        jg = jax_ckpt._unflatten_params(grads_np[s])
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k in PARAM_KEYS:
            p[k].grad = torch.from_numpy(grads_np[s][k].copy())
        opt.step()
    return to_flat(jp), {k: p[k].detach().numpy() for k in PARAM_KEYS}, \
        state, opt


@pytest.mark.parametrize("gclip", [0.0, 0.5])
def test_optimizer_matches_optax(gclip):
    """Five steps on the same gradients (their norm crosses gclip both
    ways), parameters within 1e-6 of optax's (Adam's scalars are computed
    in double in torch and in f32 in optax); the state's 19 leaves are
    optax's, in optax's order (each moment within 1e-6 of its largest
    entry)."""
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    _, params_np = jax_params(jcfg)
    rng = np.random.default_rng(4)
    scales = [0.01, 3.0, 0.001, 10.0, 0.1]
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params_np.items()} for s in scales]
    want, got, state, opt = _optimizer_runs(gclip, grads, params_np, 5)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    leaves = opt.state_leaves()
    jleaves = jax.tree.leaves(state)
    assert len(leaves) == len(jleaves) == 19
    assert leaves[0].dtype == np.int32 and int(leaves[0]) == 5 == int(
        jleaves[0])
    for a, b in zip(leaves[1:], jleaves[1:]):
        assert rel_err(a, b) <= 1e-6


def test_gclip_is_an_exact_rescale():
    """``tests/test_train.py::test_gclip_applies`` for the port: below the
    threshold the clipped optimizer equals the unclipped one; above it, the
    clipped one on huge grads equals the unclipped one on the grads
    rescaled to norm gclip, and differs from the unclipped one on the raw
    grads."""
    jcfg = JaxConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    _, params_np = jax_params(jcfg)
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25, lr=1e-2, gclip=0.5)
    plain_cfg = dataclasses.replace(cfg, gclip=0.0)
    g1 = {k: v * 0.001 for k, v in params_np.items()}    # norm < gclip
    g2 = {k: v * 1e4 for k, v in params_np.items()}      # norm >> gclip
    norm2 = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in g2.values()))
    assert np.sqrt(sum(float(np.sum(g ** 2)) for g in g1.values())) < 0.5
    g2_scaled = {k: (g * (cfg.gclip / norm2)).astype(np.float32)
                 for k, g in g2.items()}

    def run(config, grad_seq):
        p = LRCNParams.from_numpy(params_np, CPU)
        opt = Optimizer(p, config)
        for g in grad_seq:
            opt.zero_grad()
            for k in PARAM_KEYS:
                p[k].grad = torch.from_numpy(g[k].copy())
            opt.step()
        return {k: p[k].detach().numpy() for k in PARAM_KEYS}

    below_c, below_p = run(cfg, [g1]), run(plain_cfg, [g1])
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(below_c[k], below_p[k])
    clipped = run(cfg, [g1, g2])
    rescaled = run(plain_cfg, [g1, g2_scaled])
    raw = run(plain_cfg, [g1, g2])
    for k in PARAM_KEYS:
        np.testing.assert_allclose(clipped[k], rescaled[k], rtol=1e-5,
                                   atol=1e-7)
    diff = max(float(np.abs(clipped[k] - raw[k]).max()) for k in PARAM_KEYS)
    assert diff > 1e-4, "clipped update is indistinguishable from unclipped"


# --- Trainer.fit against JAX ---


@pytest.fixture(scope="module")
def jax_fits(tiny):
    """JAX's ``Trainer.fit``, f32, pdrop 0, 2 epochs from seed-0 params,
    with 1 and 2 steps a dispatch: (final params, epoch records)."""
    jcfg = dataclasses.replace(tiny["jcfg"], compute_dtype="float32")
    out = {}
    for k in (1, 2):
        rec = JaxRecorder()
        trainer = JaxTrainer(jcfg, tiny["jvocab"], metrics=rec,
                             steps_per_dispatch=k)
        params, opt_state = trainer.init(jax.random.PRNGKey(0))
        params, _ = trainer.fit(params, opt_state, tiny["jbatches"],
                                tiny["jbatches"], tiny["jstore"],
                                tiny["jstore"], jax.random.PRNGKey(1),
                                epochs=2)
        out[k] = (to_flat(params),
                  [r for r in rec.records if r["event"] == "epoch"])
    return out


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_fit_matches_jax(tiny, jax_fits, steps_per_dispatch):
    """Same init, batches, order and loss: the epochs' train and val
    losses within 1e-4 (the logs round to 4 places), the parameters
    within 2e-5 absolute after 6 Adam steps at lr 1e-2 (f32 sums in
    another order, Adam's scalars in double)."""
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
    assert [r["epoch"] for r in records] == [1, 2]
    for got, want in zip(records, want_records):
        for key in ("train_loss", "val_loss"):
            assert abs(got[key] - want[key]) <= 1e-4 + 1e-12, (got, want)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   want_params[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert int(opt.state_leaves()[0]) == 2 * len(tiny["batches"])
    train_logs = [r for r in rec.records
                  if r["event"] == "epoch_train_done"]
    assert len(train_logs) == 2 and train_logs[0]["words_per_sec"] > 0


@pytest.mark.parametrize("steps_per_dispatch", [1, 3])
def test_overfit_tiny_dataset(tiny, steps_per_dispatch):
    """40 epochs take the loss below a fifth of its start (the JAX test's
    bar); 3 steps a dispatch exercises the per-shape tail."""
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu", steps_per_dispatch=steps_per_dispatch)
    params, opt = trainer.init(0)
    loss0 = trainer.average_loss(params, tiny["batches"], tiny["store"])
    params, opt = trainer.fit(params, opt, tiny["batches"], None,
                              tiny["store"], None, 1, epochs=40,
                              eval_train_loss=False)
    loss1 = trainer.average_loss(params, tiny["batches"], tiny["store"])
    assert loss1 < loss0 * 0.2, (loss0, loss1)
    assert loss1 < 0.5


def test_multi_eval_matches_single_eval(tiny):
    t1 = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                 device="cpu")
    tk = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                 device="cpu", steps_per_dispatch=2)
    params, _ = t1.init(0)
    a = t1.average_loss(params, tiny["batches"], tiny["store"])
    b = tk.average_loss(params, tiny["batches"], tiny["store"])
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_bestfile_tracks_best_val_loss(tmp_path, tiny):
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu")
    params, opt = trainer.init(0)
    trainer.fit(params, opt, tiny["batches"], tiny["batches"],
                tiny["store"], tiny["store"], 1, epochs=3,
                eval_train_loss=False, savefile=str(tmp_path / "last"),
                bestfile=str(tmp_path / "best"))
    best = torch_ckpt.load_checkpoint(str(tmp_path / "best"), CPU)
    last = torch_ckpt.load_checkpoint(str(tmp_path / "last"), CPU)
    assert last["epoch"] == 3 and best["epoch"] == 3
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(best["params"][k], last["params"][k])


class Crash(Exception):
    pass


def crash_after_saves(monkeypatch, n: int) -> None:
    """Make the trainer's n-th mid-epoch save raise once it has landed."""
    real = trainer_mod.save_checkpoint
    calls = []

    def crashing(*a, **kw):
        real(*a, **kw)
        if kw.get("position") is not None:
            calls.append(1)
            if len(calls) == n:
                raise Crash()

    monkeypatch.setattr(trainer_mod, "save_checkpoint", crashing)


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_mid_epoch_resume_is_exact(tmp_path, monkeypatch, tiny,
                                   steps_per_dispatch):
    """Kill training after the second mid-epoch save; resuming from it
    replays the uninterrupted run bit for bit (dropout 0.4: the step
    generators are seeded from the saved epoch key and the step index)."""
    cfg = dataclasses.replace(tiny["cfg"], dropout=0.4)
    ckpt_dir = str(tmp_path / "ck")

    def trainer():
        return Trainer(cfg, tiny["vocab"], metrics=Recorder(), device="cpu",
                       steps_per_dispatch=steps_per_dispatch)

    t = trainer()
    full, _ = t.fit(*t.init(0), tiny["batches"], None, tiny["store"], None,
                    1, epochs=2, eval_train_loss=False)

    with monkeypatch.context() as m:
        crash_after_saves(m, 2)
        t = trainer()
        with pytest.raises(Crash):
            t.fit(*t.init(0), tiny["batches"], None, tiny["store"], None, 1,
                  epochs=2, eval_train_loss=False, savefile=ckpt_dir,
                  ckpt_every=1)
    ck = torch_ckpt.load_checkpoint(ckpt_dir, CPU)
    assert ck["position"] is not None and ck["opt_leaves"] is not None
    t = trainer()
    resumed, _ = t.fit(*t.restore(ck["params"], ck["opt_leaves"]),
                       tiny["batches"], None, tiny["store"], None, 1,
                       epochs=2, eval_train_loss=False,
                       resume_position=ck["position"])
    for k in PARAM_KEYS:
        assert torch.equal(full[k], resumed[k]), k


def test_resume_refuses_different_dispatch_geometry(tmp_path, monkeypatch,
                                                    tiny):
    ckpt_dir = str(tmp_path / "geo")
    with monkeypatch.context() as m:
        crash_after_saves(m, 1)
        t = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                    device="cpu", steps_per_dispatch=2)
        with pytest.raises(Crash):
            t.fit(*t.init(0), tiny["batches"], None, tiny["store"], None, 1,
                  epochs=1, eval_train_loss=False, savefile=ckpt_dir,
                  ckpt_every=1)
    ck = torch_ckpt.load_checkpoint(ckpt_dir, CPU)
    wrong = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                    device="cpu", steps_per_dispatch=1)
    with pytest.raises(ValueError, match="geometry"):
        wrong.fit(*wrong.init(0), tiny["batches"], None, tiny["store"],
                  None, 1, epochs=1, eval_train_loss=False,
                  resume_position=ck["position"])


def test_completed_run_leaves_no_position(tmp_path, tiny):
    trainer = Trainer(tiny["cfg"], tiny["vocab"], metrics=Recorder(),
                      device="cpu")
    ckpt_dir = str(tmp_path / "clean")
    trainer.fit(*trainer.init(0), tiny["batches"], None, tiny["store"],
                None, 1, epochs=1, eval_train_loss=False, savefile=ckpt_dir,
                ckpt_every=1)
    ck = torch_ckpt.load_checkpoint(ckpt_dir, CPU)
    assert ck["position"] is None and ck["epoch"] == 1


def test_position_and_keys_roundtrip():
    for key in (0, 1, 2 ** 63 + 5, 2 ** 64 - 1, fold_in(7, 3)):
        words = torch_ckpt.key_words(key)
        assert words.dtype == np.uint32 and words.shape == (2,)
        assert torch_ckpt.key_from_words(words.tolist()) == key
    assert len({fold_in(1, j) for j in range(100)}) == 100
    rng = np.random.default_rng(3)
    state = rng.bit_generator.state
    geometry = {"steps_per_dispatch": 2, "n_batches": 3}
    pos = torch_ckpt.make_position(2, 5, state, fold_in(1, 2), geometry)
    rng.permutation(10)
    fresh = np.random.default_rng(0)
    assert torch_ckpt.resume_start(pos, fresh, 99, geometry) == (
        2, 5, fold_in(1, 2))
    assert fresh.bit_generator.state == state


# --- checkpoints ---


def test_checkpoint_save_is_atomic(tmp_path, tiny):
    """The JAX package's atomic-save test for the port: a partial .tmp next
    to an intact checkpoint, and a kill mid-swap, both load."""
    params, _ = Trainer(tiny["cfg"], tiny["vocab"], device="cpu").init(0)
    path = str(tmp_path / "atomic")
    torch_ckpt.save_checkpoint(path, params, tiny["vocab"], tiny["cfg"],
                               epoch=1)
    tmp = path + ".tmp"
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"), junk=np.zeros(1))
    assert torch_ckpt.recover_checkpoint(path) == path
    assert torch_ckpt.load_checkpoint(path, CPU)["epoch"] == 1
    assert not os.path.exists(tmp)

    torch_ckpt.save_checkpoint(path, params, tiny["vocab"], tiny["cfg"],
                               epoch=2)
    shutil.move(path, path + ".old")
    shutil.copytree(path + ".old", path + ".tmp")
    assert torch_ckpt.recover_checkpoint(path) == path
    assert torch_ckpt.load_checkpoint(path, CPU)["epoch"] == 2
    np.save(os.path.join(path, "average_image.npy"), np.ones(3, np.float32))
    torch_ckpt.save_checkpoint(path, params, tiny["vocab"], tiny["cfg"],
                               epoch=3)
    assert os.path.exists(os.path.join(path, "average_image.npy"))
    assert sorted(os.listdir(tmp_path)) == ["atomic"]


@pytest.mark.parametrize("crash", ["first save", "later save",
                                   "mid-swap"])
def test_crashed_save_loads_in_both_packages(tmp_path, monkeypatch, tiny,
                                             crash):
    """A save killed between its write and its swap (a complete
    ``ck.tmp``; no ``ck``, or an older ``ck``, or only ``ck.old``) loads
    the new snapshot in the port as in the JAX package."""
    params, opt = Trainer(tiny["cfg"], tiny["vocab"], device="cpu").init(0)
    path = str(tmp_path / "ck")
    if crash != "first save":
        old = {k: v * 0 for k, v in lrcn.flat_tree(params).items()}
        torch_ckpt.save_checkpoint(path, old, tiny["vocab"], tiny["cfg"],
                                   epoch=1)
    real_rename, renames = os.rename, []

    def killed(src, dst):
        renames.append(src)
        if len(renames) == (2 if crash == "mid-swap" else 1):
            raise Crash()
        real_rename(src, dst)

    with monkeypatch.context() as m:
        m.setattr(os, "rename", killed)
        with pytest.raises(Crash):
            torch_ckpt.save_checkpoint(path, params, tiny["vocab"],
                                       tiny["cfg"], opt_state=opt, epoch=2)
    assert os.path.exists(os.path.join(path + ".tmp", "config.json"))
    assert os.path.isdir(path) == (crash == "later save")
    for suffix in ("", ".tmp", ".old"):
        if os.path.isdir(path + suffix):
            shutil.copytree(path + suffix, str(tmp_path / "jax") + suffix)
    port = torch_ckpt.load_checkpoint(path, CPU)
    ref = jax_ckpt.load_checkpoint(str(tmp_path / "jax"))
    assert port["epoch"] == ref["epoch"] == 2
    ref_flat = to_flat(ref["params"])
    for k, v in lrcn.flat_tree(params).items():
        np.testing.assert_array_equal(port["params"][k], v)
        np.testing.assert_array_equal(ref_flat[k], v)
    assert sorted(os.listdir(tmp_path)) == ["ck", "jax"]


def _continue_jax(ck_path, tiny, epochs):
    """Resume a checkpoint in the JAX package for one more epoch."""
    ck = jax_ckpt.load_checkpoint(ck_path)
    jcfg = dataclasses.replace(tiny["jcfg"], compute_dtype="float32")
    trainer = JaxTrainer(jcfg, tiny["jvocab"], metrics=JaxRecorder())
    params = jax.tree.map(jnp.asarray, ck["params"])
    opt_state = jax_ckpt.restore_opt_state(trainer.opt.init(params),
                                           ck["opt_leaves"])
    params, opt_state = trainer.fit(
        params, opt_state, tiny["jbatches"], None, tiny["jstore"], None,
        jax.random.PRNGKey(3), epochs=epochs, eval_train_loss=False,
        completed_epochs=ck["epoch"])
    return to_flat(params), jax.tree.leaves(opt_state)


def _continue_port(ck_path, tiny, epochs):
    ck = torch_ckpt.load_checkpoint(ck_path, CPU)
    cfg = dataclasses.replace(tiny["cfg"], compute_dtype="float32")
    trainer = Trainer(cfg, tiny["vocab"], metrics=Recorder(), device="cpu")
    params, opt = trainer.restore(ck["params"], ck["opt_leaves"])
    params, opt = trainer.fit(params, opt, tiny["batches"], None,
                              tiny["store"], None, 3, epochs=epochs,
                              eval_train_loss=False,
                              completed_epochs=ck["epoch"])
    return lrcn.flat_tree(params), opt.state_leaves()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_resume_in_the_other_package(tmp_path, tiny, writer):
    """An epoch-complete checkpoint with its Adam state, written after one
    epoch by either package, restores in both (the 19 leaves exactly) and
    both continue to the same parameters one epoch later (f32, pdrop 0;
    2e-5 absolute as ``test_fit_matches_jax``)."""
    path = str(tmp_path / "ck")
    init = to_flat(jax_lrcn.init_params(jax.random.PRNGKey(0),
                                        tiny["jcfg"]))
    if writer == "port":
        cfg = dataclasses.replace(tiny["cfg"], compute_dtype="float32")
        trainer = Trainer(cfg, tiny["vocab"], metrics=Recorder(),
                          device="cpu")
        params, opt = trainer.restore(init)
        trainer.fit(params, opt, tiny["batches"], None, tiny["store"], None,
                    1, epochs=1, eval_train_loss=False, savefile=path)
    else:
        jcfg = dataclasses.replace(tiny["jcfg"], compute_dtype="float32")
        trainer = JaxTrainer(jcfg, tiny["jvocab"], metrics=JaxRecorder())
        params, opt_state = trainer.init(jax.random.PRNGKey(0))
        trainer.fit(params, opt_state, tiny["jbatches"], None,
                    tiny["jstore"], None, jax.random.PRNGKey(1), epochs=1,
                    eval_train_loss=False, savefile=path)
    port_ck = torch_ckpt.load_checkpoint(path, CPU)
    jax_ck = jax_ckpt.load_checkpoint(path)
    assert port_ck["epoch"] == jax_ck["epoch"] == 1
    assert len(port_ck["opt_leaves"]) == len(jax_ck["opt_leaves"]) == 19
    for a, b in zip(port_ck["opt_leaves"], jax_ck["opt_leaves"]):
        np.testing.assert_array_equal(a, b)
    # the port's optimizer holds exactly what was saved
    _, opt = Trainer(tiny["cfg"], tiny["vocab"], device="cpu").restore(
        port_ck["params"], port_ck["opt_leaves"])
    for a, b in zip(opt.state_leaves(), jax_ck["opt_leaves"]):
        np.testing.assert_array_equal(a, b)
    assert int(jax_ck["opt_leaves"][0]) == len(tiny["batches"])
    copy_path = str(tmp_path / "copy")
    shutil.copytree(path, copy_path)
    want, want_leaves = _continue_jax(path, tiny, epochs=2)
    got, got_leaves = _continue_port(copy_path, tiny, epochs=2)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert int(got_leaves[0]) == int(want_leaves[0]) == 2 * len(
        tiny["batches"])
