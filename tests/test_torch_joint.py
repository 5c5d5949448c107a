"""The port's joint CNN+decoder fine-tuning against the JAX package, on the
CPU: the VGG training forward, ``joint_loss`` and every gradient of both
parameter sets against ``jax.value_and_grad``, the joint optimizer against
optax (six cases, its 80 / 19 leaves), and the train step's feeds
(``JointTrainer`` itself: ``tests/test_torch_joint_fit.py``).

Sizes are ``tests/test_joint.py``'s: hidden (16, 16), embed 12, fc7 24,
vocabulary 30, VGG at width multiplier 0.05 (8-25 channels) and fc width
24, B=8, 224x224 images.  Both packages get the same parameters (JAX's
initialization carried across with ``VGGParams.from_numpy`` and
``LRCNParams.from_numpy``); dropout masks are drawn by JAX and injected.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lrcn_tpu.config import LRCNConfig as JaxConfig
from lrcn_tpu.models import joint as jax_joint
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.train import checkpoint as jax_ckpt
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.models import joint, lrcn, vgg
from lrcn_tpu_torch.models.joint import JointParams
from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams
from lrcn_tpu_torch.models.vgg import PARAM_KEYS as VGG_KEYS, VGGParams
from lrcn_tpu_torch.train.trainer import fold_in

CPU = torch.device("cpu")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TINY = dict(hidden=(16, 16), embed=12, cnn_feature_dim=24, vocab_size=30,
            dropout=0.0, lr=1e-2, compute_dtype="float32", seed=1)
WIDTH = dict(width_multiplier=0.05, fc_dim=24)
B, L = 8, 6


def to_flat(tree) -> dict[str, np.ndarray]:
    return lrcn.flat_tree(jax.tree.map(np.asarray, tree))


def rel_err(got, want) -> float:
    """max |got - want| relative to max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_adam_close(got: dict, want: dict) -> None:
    """Parameters after Adam steps in two packages: every entry within
    2e-4 and all but 0.1% of them within 1e-5.

    Adam divides each gradient by its own running RMS, so an entry whose
    gradient is near the f32 rounding of the other package's summation
    order takes that rounding into its update at the size of a step
    (lr 1e-2 here): one entry of 5,208 reads 8.5e-5, the rest agree to
    f32 noise."""
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(np.asarray(got[k], np.float64)
                                   - np.asarray(want[k], np.float64)).ravel()
                            for k in sorted(got)])
    assert diffs.max() <= 2e-4, diffs.max()
    assert np.mean(diffs > 1e-5) <= 1e-3, np.mean(diffs > 1e-5)


def jax_masks(rng_key, pdrop, t_dim, b_dim, e_dim, f2):
    """The dropout multipliers ``lrcn_tpu`` draws from ``rng_key``
    (models/lrcn.py:209-217)."""
    k1, k2 = jax.random.split(rng_key)
    keep = 1.0 - pdrop
    m1 = jax.random.bernoulli(k1, keep, (t_dim, b_dim, e_dim)) / keep
    m2 = (jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
          ).astype(jnp.float32)
    return np.asarray(m1, np.float32), np.asarray(m2)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny joint parameters (flat numpy) and one batch."""
    jcfg = JaxConfig(**TINY)
    cnn = jax.jit(functools.partial(jax_vgg.init_vgg_params, **WIDTH))(
        jax.random.PRNGKey(0))
    decoder = jax_lrcn.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((B, 224, 224, 3)) * 40.0).astype(
        np.float32)
    tokens = rng.integers(3, jcfg.vocab_size, (B, L)).astype(np.int32)
    lengths = rng.integers(2, L + 1, (B,)).astype(np.int32)
    lengths[-1] = -1                        # a filler row, as batches pad
    return dict(jcfg=jcfg, cfg=LRCNConfig(**TINY), cnn=to_flat(cnn),
                decoder=to_flat(decoder), batch=(images, tokens, lengths))


def port_params(tiny) -> JointParams:
    return JointParams(VGGParams.from_numpy(tiny["cnn"], CPU),
                       LRCNParams.from_numpy(tiny["decoder"], CPU))


def jax_params(tiny) -> jax_joint.JointParams:
    unflat = jax_ckpt._unflatten_params
    return jax_joint.JointParams(
        cnn=jax.tree.map(jnp.asarray, unflat(tiny["cnn"])),
        decoder=jax.tree.map(jnp.asarray, unflat(tiny["decoder"])))


# --- the VGG training half ---


def test_init_vgg_params_layout_matches_jax():
    """JAX's shapes at two widths, He-normal scales, zero biases, the
    same draws from the same seed; ``vgg_param_count`` as JAX's."""
    for kw in (WIDTH, dict(width_multiplier=0.25, fc_dim=64)):
        want = to_flat(jax.jit(functools.partial(
            jax_vgg.init_vgg_params, **kw))(jax.random.PRNGKey(0)))
        got = vgg.init_vgg_params(torch.Generator().manual_seed(3), **kw)
        again = vgg.init_vgg_params(torch.Generator().manual_seed(3), **kw)
        assert set(got.keys()) == set(want) == set(VGG_KEYS)
        for k in VGG_KEYS:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == torch.float32 and got[k].requires_grad
            assert torch.equal(got[k], again[k])
            if k.endswith("/b"):
                assert not got[k].any()
        w = got["conv3_1/w"].detach().numpy()
        assert abs(w.std() / np.sqrt(2 / (9 * w.shape[2])) - 1) < 0.1
        assert vgg.vgg_param_count(got) == jax_vgg.vgg_param_count(want)


@pytest.mark.parametrize("dtype,tol", [
    # the same operations, f32 sums in another order
    ("float32", 1e-5),
    # both round each conv's output, then its bias sum, to bf16; a sum in
    # another order lands on the other side of a rounding boundary and the
    # ulp travels through 13 layers (reads 8.3e-3)
    ("bfloat16", 3e-2)])
def test_vgg16_fc7_train_matches_xla_path(tiny, dtype, tol):
    """fc7 against ``vgg16_fc7_fn(..., use_pallas=False)``, max |diff|
    relative to max |fc7|; and ``VGGParams.encoder`` (the serving copy,
    through the kernel's plain version here) agrees at f32."""
    tdt, jdt = DTYPES[dtype]
    images = tiny["batch"][0]
    want = jax.jit(functools.partial(jax_vgg.vgg16_fc7_fn,
                                     compute_dtype=jdt))(
        jax_params(tiny).cnn, images)
    params = VGGParams.from_numpy(tiny["cnn"], CPU)
    with torch.no_grad():
        got = vgg.vgg16_fc7_train(params, torch.from_numpy(images), tdt)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= tol, rel_err(got.numpy(), want)
    if dtype == "float32":
        enc = params.encoder(torch.float32)
        served = vgg.vgg16_fc7(enc, torch.from_numpy(images))
        assert rel_err(served.numpy(), want) <= 1e-5
        with torch.no_grad():       # a copy: training leaves it as it was
            params["fc7/b"].add_(1.0)
        assert torch.equal(enc.fc7_b, torch.tensor(tiny["cnn"]["fc7/b"]))


# --- the loss and its gradients ---


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(pdrop, jdt, remat):
    return jax.jit(lambda p, im, tk, ln, rng: jax.value_and_grad(
        jax_joint.joint_loss)(p, im, tk, ln, pdrop=pdrop, rng=rng,
                              compute_dtype=jdt, remat_cnn=remat))


def port_loss_and_grads(tiny, dtype, pdrop, masks, remat=True):
    params = port_params(tiny)
    images, tokens, lengths = map(torch.from_numpy, tiny["batch"])
    loss = joint.joint_loss(params, images, tokens, lengths, pdrop=pdrop,
                            drop_masks=masks, compute_dtype=dtype,
                            remat_cnn=remat)
    loss.backward()
    grads = {f"cnn/{k}": params.cnn[k].grad.numpy() for k in VGG_KEYS}
    grads.update({f"decoder/{k}": params.decoder[k].grad.numpy()
                  for k in PARAM_KEYS})
    return loss.item(), grads


@pytest.mark.parametrize("dtype,pdrop,loss_tol,grad_tol", [
    # f32: the same operations, sums in another order (read 7e-8 on the
    # loss, 3.9e-6 on the worst gradient)
    ("float32", 0.0, 1e-5, 1e-4), ("float32", 0.4, 1e-5, 1e-4),
    # bf16: the loss reads 5.8e-6 and the decoder's gradients 5.1e-3.  The
    # CNN's gradients sum bf16 cotangents that both packages round at each
    # conv output and bias sum: on these inputs JAX's bf16 gradients are
    # up to 0.52 (Frobenius, relative) from JAX's own f32 ones, the port's
    # up to 0.57, and the two bf16 ones 0.32 apart; held to 0.5 of JAX's
    ("bfloat16", 0.4, 1e-4, 1e-2)])
def test_joint_loss_and_grads_match_jax(tiny, dtype, pdrop, loss_tol,
                                        grad_tol):
    """The loss, and every gradient of both parameter sets, against
    ``jax.value_and_grad(joint_loss)``: max |difference| relative to max
    |JAX gradient| of that parameter (at bf16, the CNN's by the Frobenius
    norm of the difference relative to JAX's).  JAX's dropout masks
    injected."""
    tdt, jdt = DTYPES[dtype]
    key = jax.random.PRNGKey(9)
    images, tokens, lengths = tiny["batch"]
    want_loss, want = _jax_value_and_grad(pdrop, jdt, True)(
        jax_params(tiny), images, tokens, lengths, key)
    want = to_flat(want)
    masks = None
    if pdrop:
        f2 = 2 * tiny["jcfg"].factor_dim
        masks = tuple(map(torch.from_numpy, jax_masks(
            key, pdrop, L + 1, B, tiny["jcfg"].embed, f2)))
    loss, grads = port_loss_and_grads(tiny, tdt, pdrop, masks)
    assert abs(loss - float(want_loss)) <= loss_tol * abs(float(want_loss))
    assert set(grads) == set(want) and len(grads) == 30 + 9
    exact = {k for k in grads if dtype == "float32"
             or k.startswith("decoder/")}
    errs = {k: rel_err(grads[k], want[k]) for k in exact}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_tol, (worst, errs[worst])
    fro = {k: np.linalg.norm(grads[k] - want[k].astype(np.float32))
           / np.linalg.norm(want[k]) for k in set(grads) - exact}
    assert all(v <= 0.5 for v in fro.values()), fro
    assert np.abs(grads["cnn/conv1_1/w"]).max() > 0   # reaches conv1_1


def test_remat_on_and_off_agree(tiny):
    """``torch.utils.checkpoint`` recomputes the same VGG forward: the same
    loss and gradients, bit for bit on the CPU."""
    masks = tuple(map(torch.from_numpy, jax_masks(
        jax.random.PRNGKey(2), 0.4, L + 1, B, 12, 16)))
    on = port_loss_and_grads(tiny, torch.float32, 0.4, masks, remat=True)
    off = port_loss_and_grads(tiny, torch.float32, 0.4, masks, remat=False)
    assert on[0] == off[0]
    for k in on[1]:
        np.testing.assert_array_equal(on[1][k], off[1][k], err_msg=k)


# --- the optimizer ---


OPT_CASES = {"default": dict(), "cnn_lr": dict(cnn_lr=3e-3),
             "freeze": dict(freeze_cnn=True)}


@pytest.mark.parametrize("gclip", [0.0, 1.0])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_joint_optimizer_matches_optax(tiny, case, gclip):
    """Three steps on the same gradients against
    ``make_joint_optimizer``'s optax chain: parameters within 1e-6 and
    ``state_leaves()`` equal to ``jax.tree.leaves(opt_state)`` (80 leaves,
    19 with the CNN frozen; each moment within 1e-5 of its largest entry).

    The gradients' global norm is ~2.7 and the decoder's alone ~0.7, so
    gclip 1.0 clips only because the CNN's gradients count: with the CNN
    frozen, its gradients must still scale the decoder's update."""
    kw = OPT_CASES[case]
    jcfg = dataclasses.replace(tiny["jcfg"], gclip=gclip)
    cfg = dataclasses.replace(tiny["cfg"], gclip=gclip)
    rng = np.random.default_rng(4)
    flat = {**{f"cnn/{k}": v for k, v in tiny["cnn"].items()},
            **{f"decoder/{k}": v for k, v in tiny["decoder"].items()}}
    grads = [{k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
              for k, v in flat.items()} for _ in range(3)]
    dec_norm = np.sqrt(sum(float(np.sum(g[k].astype(np.float64) ** 2))
                           for g in grads[:1] for k in g
                           if k.startswith("decoder/")))
    assert dec_norm < 1.0 < np.sqrt(sum(float(np.sum(
        v.astype(np.float64) ** 2)) for v in grads[0].values()))

    tx = jax_joint.make_joint_optimizer(jcfg, **kw)
    jp = jax_params(tiny)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    params = port_params(tiny)
    opt = joint.make_joint_optimizer(cfg, **kw).init(params)
    for g in grads:
        tree = jax_ckpt._unflatten_params(g)
        jg = jax_joint.JointParams(cnn=tree["cnn"], decoder=tree["decoder"])
        updates, state = update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p_set, prefix in ((params.cnn, "cnn/"),
                              (params.decoder, "decoder/")):
            for k in p_set.keys():
                p_set[k].grad = torch.from_numpy(g[prefix + k].copy())
        wanted = {id(p) for p in opt.grad_params()}
        for p_set in params:     # a step only sees what it asks for
            for p in p_set.values():
                if id(p) not in wanted:
                    p.grad = None
        opt.step()
    want = to_flat(jp)
    got = {**{f"cnn/{k}": params.cnn[k].detach().numpy() for k in VGG_KEYS},
           **{f"decoder/{k}": params.decoder[k].detach().numpy()
              for k in PARAM_KEYS}}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    if kw.get("freeze_cnn"):
        for k in VGG_KEYS:
            np.testing.assert_array_equal(got[f"cnn/{k}"],
                                          tiny["cnn"][k])
    leaves, jleaves = opt.state_leaves(), jax.tree.leaves(state)
    n = 19 if kw.get("freeze_cnn") else 80
    assert len(leaves) == len(jleaves) == n
    for a, b in zip(leaves, jleaves):
        assert a.shape == np.shape(b)
        # the clip's global norm sums in another order: its scale differs
        # in the last bits, which the second moment squares (reads 1.3e-6)
        assert rel_err(a, b) <= 1e-5
    counts = [0] if n == 19 else [0, 61]
    for i in counts:
        assert leaves[i].dtype == np.int32 and int(leaves[i]) == 3
    # and back: a fresh state loaded from optax's leaves holds them exactly
    again = joint.make_joint_optimizer(cfg, **kw).init(port_params(tiny))
    again.load_leaves([np.asarray(x) for x in jleaves])
    for a, b in zip(again.state_leaves(), jleaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="leaves"):
        again.load_leaves(jleaves[:-1])


# --- the train step ---


def make_step(tiny, **kw):
    cfg = dataclasses.replace(tiny["cfg"], **kw.pop("cfg", {}))
    opt = joint.make_joint_optimizer(cfg, **kw.pop("opt", {}))
    return joint.JointTrainStep(cfg, opt, device="cpu", **kw)


def test_freeze_with_clip_step_matches_jax(tiny):
    """The trap of a frozen CNN under a clip, through whole steps: JAX
    clips before ``multi_transform``, so the CNN's gradient enters the
    global norm.  Two steps of ``JointTrainStep`` (gclip 0.05, CNN frozen)
    against JAX's: the CNN bit-equal to its start, the decoder as
    ``assert_adam_close``; and a clip that ignored the CNN takes another
    step."""
    jcfg = dataclasses.replace(tiny["jcfg"], gclip=0.05)
    jopt = jax_joint.make_joint_optimizer(jcfg, freeze_cnn=True)
    jstep = jax_joint.JointTrainStep(jcfg, jopt)
    jp = jax_params(tiny)
    jstate = jopt.init(jp)
    step = make_step(tiny, cfg=dict(gclip=0.05), opt=dict(freeze_cnn=True))
    params = port_params(tiny)
    state = step.opt.init(params)
    assert len(state.grad_params()) == 30 + 9
    images, tokens, lengths = tiny["batch"]
    for i in range(2):
        jp, jstate, jloss = jstep(jp, jstate,
                                  *jstep.shard_batch(images, tokens, lengths),
                                  jax.random.PRNGKey(i))
        params, state, loss = step(params, state,
                                   *step.shard_batch(images, tokens,
                                                     lengths), i)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    assert_adam_close(lrcn.flat_tree(params.decoder), to_flat(jp.decoder))
    for k in VGG_KEYS:
        np.testing.assert_array_equal(params.cnn[k].detach().numpy(),
                                      tiny["cnn"][k])
    # a clip over the decoder's gradients alone takes another step
    def w_out_after_one(decoder_only: bool) -> torch.Tensor:
        one = make_step(tiny, cfg=dict(gclip=0.05),
                        opt=dict(freeze_cnn=True))
        p = port_params(tiny)
        s = one.opt.init(p)
        if decoder_only:
            s.grad_params = lambda: list(s.decoder)
        one(p, s, *one.shard_batch(images, tokens, lengths), 0)
        return p.decoder["w_out"].detach()

    assert not torch.allclose(w_out_after_one(False), w_out_after_one(True),
                              rtol=0, atol=1e-5)


def test_frozen_without_clip_skips_the_cnn_backward(tiny):
    """With the CNN frozen and no clip nothing reads the CNN's gradient:
    the step asks only for the decoder's and the CNN stays bit-equal."""
    step = make_step(tiny, opt=dict(freeze_cnn=True))
    params = port_params(tiny)
    state = step.opt.init(params)
    assert len(state.grad_params()) == 9
    step(params, state, *step.shard_batch(*tiny["batch"]), 0)
    for k in VGG_KEYS:
        assert params.cnn[k].grad is None
        np.testing.assert_array_equal(params.cnn[k].detach().numpy(),
                                      tiny["cnn"][k])
    assert not np.array_equal(params.decoder["w_out"].detach().numpy(),
                              tiny["decoder"]["w_out"])


def test_multi_step_matches_sequential_steps(tiny):
    """K=2 steps in one ``multi_step`` == two single steps with the keys
    ``fold_in(base, offset + i)``; dropout on, bit for bit."""
    step = make_step(tiny, cfg=dict(dropout=0.4))
    images, tokens, lengths = tiny["batch"]
    rng = np.random.default_rng(7)
    images2 = rng.integers(0, 256, images.shape).astype(np.uint8)
    images1 = rng.integers(0, 256, images.shape).astype(np.uint8)
    tokens2 = rng.integers(3, 30, tokens.shape).astype(np.int32)
    seq = port_params(tiny)
    seq_state = step.opt.init(seq)
    seq_losses = []
    for i, (im, tk) in enumerate(((images1, tokens), (images2, tokens2))):
        seq, seq_state, loss = step(seq, seq_state,
                                    *step.shard_batch(im, tk, lengths),
                                    fold_in(11, 5 + i))
        seq_losses.append(loss)
    multi = port_params(tiny)
    multi_state = step.opt.init(multi)
    chunk = step.shard_chunk(np.stack([images1, images2]),
                             np.stack([tokens, tokens2]),
                             np.stack([lengths, lengths]))
    assert chunk[0].dtype == torch.uint8 and chunk[0].shape[:2] == (2, B)
    multi, multi_state, losses = step.multi_step(multi, multi_state, *chunk,
                                                 11, 5)
    assert torch.equal(losses, torch.stack(seq_losses))
    for a, b in zip(lrcn.flat_tree(seq).values(),
                    lrcn.flat_tree(multi).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(seq_state.state_leaves(), multi_state.state_leaves()):
        np.testing.assert_array_equal(a, b)


def test_uint8_feed_matches_host_preprocess(tiny):
    """uint8 pixels + on-device mean-subtract == host float32 preprocess;
    the uint8 wire format stays uint8."""
    rng = np.random.default_rng(9)
    avg = rng.uniform(90.0, 130.0, (224, 224, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (B, 224, 224, 3)).astype(np.uint8)
    _, tokens, lengths = tiny["batch"]
    params = port_params(tiny)
    with_avg = make_step(tiny, average_image=avg)
    dev = with_avg.shard_batch(u8, tokens, lengths)
    assert dev[0].dtype == torch.uint8
    t_dev, c_dev = with_avg.eval_batch(params, *dev)
    zero = make_step(tiny)
    host = u8.astype(np.float32) - avg
    t_host, c_host = zero.eval_batch(params, *zero.shard_batch(
        host, tokens, lengths))
    assert zero.shard_batch(host, tokens, lengths)[0].dtype == torch.float32
    assert float(c_dev) == float(c_host) == float(np.maximum(
        lengths + 1, 0).sum())
    np.testing.assert_allclose(float(t_dev), float(t_host), rtol=1e-6)


def test_init_draws_both_sets_on_the_device(tiny):
    """``init`` from a seed: a VGG of JAX's full layout unless one is
    given, the decoder from its own stream (the same with or without the
    given VGG), and a fresh optimizer of 80 leaves."""
    step = make_step(tiny)
    small = vgg.init_vgg_params(torch.Generator().manual_seed(0), **WIDTH)
    p1, s1 = step.init(5, vgg_params=small)
    p2, _ = step.init(5, vgg_params=tiny["cnn"])
    assert p1.cnn.device == p1.decoder.device == CPU
    for k in PARAM_KEYS:
        assert torch.equal(p1.decoder[k], p2.decoder[k])
    assert torch.equal(p2.cnn["fc6/w"], torch.from_numpy(tiny["cnn"]["fc6/w"]))
    assert len(s1.state_leaves()) == 80
