"""The port's ``JointTrainer`` against the JAX package's, on the CPU:
``fit`` on a JPEG set on disk (both packages decoding through the native
loader) for K = 1, 2, joint checkpoints that either package writes and the
other resumes with their 80 optimizer leaves, and the port's own
mid-epoch resume.  The step, loss and optimizer are held to JAX's in
``tests/test_torch_joint.py``; this file is apart so that the two run on
separate workers.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig as JaxConfig
from lrcn_tpu.core.tokenizer import Caption as JaxCaption
from lrcn_tpu.core.vocab import Vocab as JaxVocab
from lrcn_tpu.data.batcher import bucket_batches as jax_bucket_batches
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.train import checkpoint as jax_ckpt
from lrcn_tpu.train import joint as jax_train_joint
from lrcn_tpu.train.metrics import MetricsLogger as JaxMetrics
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.tokenizer import Caption
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.batcher import bucket_batches
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.joint import JointParams
from lrcn_tpu_torch.train import checkpoint as torch_ckpt
from lrcn_tpu_torch.train import joint as joint_mod
from lrcn_tpu_torch.train.joint import JointTrainer
from lrcn_tpu_torch.train.metrics import MetricsLogger

CPU = torch.device("cpu")


def to_flat(tree) -> dict[str, np.ndarray]:
    return lrcn.flat_tree(jax.tree.map(np.asarray, tree))


# --- the epoch loop against JAX's, on JPEGs ---


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    """``tests/test_joint.py``'s resume set: 8 random 230x240 JPEGs, one
    caption each, batch 2, in both packages' classes; JAX's initial
    parameters (VGG at width 0.05, fc 16), flat; a mean image of 117 (as
    ``benchmarks/bench_joint.py``: centred pixels keep the random VGG's
    activations, and the two trajectories, close; uncentred 0-255 pixels
    let the f32 rounding of the first steps grow to 1e-3 in 8)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(7)
    paths, texts = {}, {}
    for i in range(8):
        iid = 9000 + i
        paths[iid] = str(root / f"{iid}.jpg")
        Image.fromarray(rng.integers(0, 255, (230, 240, 3)).astype(
            np.uint8)).save(paths[iid])
        texts[iid] = ("w0", "w1", f"w{2 + i % 3}")
    words = [f"w{i}" for i in range(6)]
    kw = dict(hidden=(12, 12), embed=8, cnn_feature_dim=16, vocab_size=9,
              dropout=0.0, lr=1e-2, compute_dtype="float32", seed=3,
              batch_size=2)
    jcfg, cfg = JaxConfig(**kw), LRCNConfig(**kw)
    jvocab, vocab = JaxVocab(words), Vocab(words)
    assert len(vocab) == kw["vocab_size"]
    jbatches = jax_bucket_batches([JaxCaption(i, t) for i, t in
                                   texts.items()], jvocab, 2,
                                  apply_small_dataset_rule=False)
    batches = bucket_batches([Caption(i, t) for i, t in texts.items()],
                             vocab, 2, apply_small_dataset_rule=False)
    cnn = jax.jit(functools.partial(jax_vgg.init_vgg_params,
                                    width_multiplier=0.05, fc_dim=16))(
        jax.random.PRNGKey(0))
    decoder = jax_lrcn.init_params(jax.random.PRNGKey(1), jcfg)
    init = {**{f"cnn/{k}": v for k, v in to_flat(cnn).items()},
            **{f"decoder/{k}": v for k, v in to_flat(decoder).items()}}
    return dict(paths=paths, jcfg=jcfg, cfg=cfg, jvocab=jvocab, vocab=vocab,
                jbatches=jbatches, batches=batches, init=init,
                avg=np.full((224, 224, 3), 117.0, np.float32))


class Recorder(MetricsLogger):
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


def jax_trainer(s, k=1, rec=None):
    return jax_train_joint.JointTrainer(
        s["jcfg"], s["jvocab"], s["paths"], s["avg"],
        metrics=rec or JaxRecorder(), steps_per_dispatch=k)


def port_trainer(s, k=1, rec=None, cfg=None):
    return JointTrainer(cfg or s["cfg"], s["vocab"], s["paths"],
                        s["avg"], metrics=rec or Recorder(),
                        steps_per_dispatch=k, device="cpu")


def jax_init(s, trainer):
    params = jax_train_joint.load_joint_params(jax.tree.map(
        jnp.asarray, jax_ckpt._unflatten_params(s["init"])))
    return params, trainer.opt.init(params)


@pytest.fixture(scope="module")
def jax_fits(jpeg_set):
    """JAX's ``JointTrainer.fit``, 2 epochs with validation, K = 1, 2."""
    out = {}
    for k in (1, 2):
        rec = JaxRecorder()
        trainer = jax_trainer(jpeg_set, k, rec)
        params, _ = trainer.fit(*jax_init(jpeg_set, trainer),
                                jpeg_set["jbatches"], jpeg_set["jbatches"],
                                jax.random.PRNGKey(2), epochs=2)
        out[k] = (to_flat(params),
                  [r for r in rec.records if r["event"] == "epoch"])
    return out


def port_flat(params: JointParams) -> dict[str, np.ndarray]:
    return lrcn.flat_tree(params)


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_fit_matches_jax(jpeg_set, jax_fits, steps_per_dispatch):
    """Same JPEGs (the native loader in both), parameters, batch order and
    step: the epochs' validation losses within 1e-4 (the logs round to 4
    places) and every parameter within 2e-5 absolute after 8 steps (f32
    sums in another order, Adam's scalars in double; reads 7.0e-6)."""
    want, want_records = jax_fits[steps_per_dispatch]
    rec = Recorder()
    trainer = port_trainer(jpeg_set, steps_per_dispatch, rec)
    params, opt = trainer.restore(jpeg_set["init"])
    params, opt = trainer.fit(params, opt, jpeg_set["batches"],
                              jpeg_set["batches"], 2, epochs=2)
    records = [r for r in rec.records if r["event"] == "epoch"]
    assert [r["epoch"] for r in records] == [1, 2]
    for got, exp in zip(records, want_records):
        assert abs(got["val_loss"] - exp["val_loss"]) <= 1e-4 + 1e-12
    got = port_flat(params)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    leaves = opt.state_leaves()
    assert len(leaves) == 80 and int(leaves[0]) == 2 * len(
        jpeg_set["batches"])


class Crash(Exception):
    pass


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_mid_epoch_resume_is_exact(tmp_path, monkeypatch, jpeg_set,
                                   steps_per_dispatch):
    """Crash the port's fine-tune after its first mid-epoch save; the
    resumed run replays the uninterrupted one bit for bit (dropout 0.4:
    the step generators come from the saved epoch key and the index)."""
    cfg = dataclasses.replace(jpeg_set["cfg"], dropout=0.4)
    make = lambda: port_trainer(jpeg_set, steps_per_dispatch, cfg=cfg)
    t = make()
    full, _ = t.fit(*t.restore(jpeg_set["init"]), jpeg_set["batches"], None,
                    2, epochs=2)
    ckpt_dir = str(tmp_path / "ck")
    real = joint_mod.save_checkpoint

    def crashing(*a, **kw):
        real(*a, **kw)
        if kw.get("position") is not None:
            raise Crash()

    with monkeypatch.context() as m:
        m.setattr(joint_mod, "save_checkpoint", crashing)
        t = make()
        with pytest.raises(Crash):
            t.fit(*t.restore(jpeg_set["init"]), jpeg_set["batches"], None,
                  2, epochs=2, savefile=ckpt_dir, ckpt_every=1)
    ck = torch_ckpt.load_checkpoint(ckpt_dir, CPU)
    assert ck["position"] is not None and len(ck["opt_leaves"]) == 80
    assert ck["vgg"] is not None
    t = make()
    resumed, _ = t.fit(*t.restore(ck["params"], ck["opt_leaves"]),
                       jpeg_set["batches"], None, 2, epochs=2,
                       resume_position=ck["position"])
    for a, b in zip(port_flat(full).items(), port_flat(resumed).items()):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_joint_checkpoints_resume_in_the_other_package(tmp_path, jpeg_set,
                                                       writer):
    """An epoch-complete joint checkpoint with its 80 optimizer leaves,
    written after one epoch by either package, restores in both (the
    leaves exactly) and both continue to the same parameters one epoch
    later (2e-5 absolute, as ``test_fit_matches_jax``)."""
    path = str(tmp_path / "ck")
    if writer == "port":
        t = port_trainer(jpeg_set)
        t.fit(*t.restore(jpeg_set["init"]), jpeg_set["batches"], None, 2,
              epochs=1, savefile=path)
    else:
        t = jax_trainer(jpeg_set)
        t.fit(*jax_init(jpeg_set, t), jpeg_set["jbatches"], None,
              jax.random.PRNGKey(2), epochs=1, savefile=path)
    port_ck = torch_ckpt.load_checkpoint(path, CPU)
    jax_ck = jax_ckpt.load_checkpoint(path)
    assert port_ck["epoch"] == jax_ck["epoch"] == 1
    assert len(port_ck["opt_leaves"]) == len(jax_ck["opt_leaves"]) == 80
    for a, b in zip(port_ck["opt_leaves"], jax_ck["opt_leaves"]):
        np.testing.assert_array_equal(a, b)
    assert set(port_ck["params"]) == set(jpeg_set["init"])
    copy = str(tmp_path / "copy")
    shutil.copytree(path, copy)

    t = jax_trainer(jpeg_set)
    params = jax_train_joint.load_joint_params(
        jax.tree.map(jnp.asarray, jax_ck["params"]))
    opt_state = jax_ckpt.restore_opt_state(t.opt.init(params),
                                           jax_ck["opt_leaves"])
    params, _ = t.fit(params, opt_state, jpeg_set["jbatches"], None,
                      jax.random.PRNGKey(3), epochs=2, completed_epochs=1)
    want = to_flat(params)

    ck = torch_ckpt.load_checkpoint(copy, CPU)
    t = port_trainer(jpeg_set)
    params, opt = t.restore(ck["params"], ck["opt_leaves"])
    for a, b in zip(opt.state_leaves(), jax_ck["opt_leaves"]):
        np.testing.assert_array_equal(a, b)
    params, opt = t.fit(params, opt, jpeg_set["batches"], None, 3, epochs=2,
                        completed_epochs=1)
    got = port_flat(params)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert int(opt.state_leaves()[0]) == 2 * len(jpeg_set["batches"])
