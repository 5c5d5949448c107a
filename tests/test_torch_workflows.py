"""Whole workflows through ``lrcn-torch`` against ``lrcn``, on the CPU in
f32: the ``docs/RUNBOOK_PARITY.md`` chain of ``tests/test_runbook.py``
(extract-features from a MatConvNet file, train, generate, eval) and the
real-language BLEU gate of ``tests/test_real_captions.py`` on the
reference's human captions (skipped where they are absent).

The chain is held at its ends: the port's fc7 store against ``lrcn
extract-features`` on the same files, the port's ``generate`` from the
JAX-trained checkpoint byte-equal to JAX's, and ``eval``'s output equal
to JAX's.  The two trainings need not match: the packages' random streams
differ."""

import json
import os

import numpy as np
import pytest

from lrcn_tpu_torch.core.tokenizer import tokenize_coco_caption
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.evaluation.bleu import multi_bleu_files
from lrcn_tpu_torch.evaluation.references import write_reference_files
from test_runbook import WORDS
from test_torch_cli import jax_main, port_main
from test_vgg import _save_small_mat

# fc7 of the same f32 encoder in both packages, relative to its largest
# entry (tests/test_torch_cli_images.py)
FC7_RTOL = 1e-5
F32 = ["--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_runbook.py's corpus: 32 JPEGs, COCO train/val jsons and a
    width-scaled MatConvNet file, from the same seed."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("runbook")
    rng = np.random.default_rng(31)
    img_dir = tmp / "train2014"
    img_dir.mkdir()
    ids = [61000 + i for i in range(32)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (240, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.jpg"))

    def caption_json(path):
        anns = [{"image_id": iid,
                 "caption": " ".join(rng.choice(WORDS, 5)) + " ."}
                for iid in ids for _ in range(5)]
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return str(path)

    train_json = caption_json(tmp / "captions_train2014.json")
    val_json = caption_json(tmp / "captions_val2014.json")
    mat = str(tmp / "imagenet-vgg-verydeep-16.mat")
    _save_small_mat(mat, rng)
    return {"tmp": tmp, "images": str(img_dir), "ids": ids, "mat": mat,
            "train": train_json, "val": val_json}


def _run(main, capsys, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0, argv[0]
    return capsys.readouterr().out


def test_runbook_chain_through_lrcn_torch(corpus, capsys):
    tmp = corpus["tmp"]
    files = ["--datafiles", corpus["train"], corpus["val"]]

    # step 2: fc7 extraction from the .mat, in both packages
    stores = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = str(tmp / f"{name}_feats")
        _run(main, capsys, ["extract-features", "--cnn", corpus["mat"],
                            "--images", corpus["images"], "--out", out,
                            "--batch-size", "8", "--scan-depth", "2", *F32])
        stores[name] = out
    port, jax = (FeatureStore.load(stores[n]) for n in ("port", "jax"))
    assert port.ids() == jax.ids() == corpus["ids"]
    assert port.dim == jax.dim == 24 and port.normalized
    got, ref = port.gather(port.ids()), jax.gather(port.ids())
    assert np.abs(got - ref).max() / np.abs(ref).max() <= FC7_RTOL

    # step 3: train on the port's store, in both packages
    ckpts = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        ckpts[name] = str(tmp / f"{name}_ckpt")
        _run(main, capsys, ["train", *files, "--features", stores["port"],
                            "--val-features", stores["port"], "--savefile",
                            ckpts[name], "--epochs", "2", "--batchsize", "8",
                            "--hidden", "24", "24", "--embed", "16",
                            "--seed", "9", "--dropout", "0.0", *F32])

    # step 4: caption the held-out split; from the JAX checkpoint both
    # packages write the same files
    def generate(main, ckpt, tag):
        cand, ids = str(tmp / f"{tag}_cands"), str(tmp / f"{tag}_ids")
        printed = _run(main, capsys, [
            "generate", "--loadfile", ckpt, "--features", stores["port"],
            *files, "--capnumber", "16", "--generate", "8", "--beam_width",
            "2", "--batch-size", "16", "--out", cand, "--ids-out", ids,
            "--seed", "7", *F32])
        with open(cand, "rb") as f, open(ids, "rb") as g:
            return cand, ids, f.read(), g.read(), printed.replace(tag, "")

    port_gen = generate(port_main, ckpts["jax"], "port_on_jax")
    jax_gen = generate(jax_main, ckpts["jax"], "jax_on_jax")
    assert port_gen[2:] == jax_gen[2:]
    assert port_gen[2].count(b"\n") == 16
    own = generate(port_main, ckpts["port"], "port_on_port")
    assert own[3] == port_gen[3]                 # the same held-out ids
    assert own[2].count(b"\n") == 16

    # step 5: references and BLEU, the same lines and files
    evals = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        refs = str(tmp / f"{name}_refs")
        printed = _run(main, capsys, [
            "eval", "--candidates", port_gen[0], "--candidate-ids",
            port_gen[1], "--annotations", corpus["val"], "--refs-dir", refs])
        written = {}
        for fname in sorted(os.listdir(refs)):
            with open(os.path.join(refs, fname), "rb") as f:
                written[fname] = f.read()
        evals[name] = (printed.replace(refs, "<refs>"), written)
    assert evals["port"] == evals["jax"]
    assert "BLEU = " in evals["port"][0]
    printed = _run(port_main, capsys, [
        "eval", "--candidates", own[0], "--candidate-ids", own[1],
        "--annotations", corpus["val"], "--refs-dir", str(tmp / "own_refs")])
    line = [ln for ln in printed.splitlines() if ln.startswith("BLEU")][-1]
    assert 0.0 <= float(line.split("/")[3].split()[0]) <= 100.0


# --- the real-language gate (tests/test_real_captions.py) ---

N_IMAGES = 64
MAX_WORDS = 16
HELD_OUT = 4          # the 5th reference is never trained on


def _load_refs(reference_eval_dir, subdir, prefix):
    refdir = os.path.join(reference_eval_dir, subdir)
    if not os.path.isdir(refdir):
        pytest.skip(f"{subdir} not available")
    return [open(os.path.join(refdir, f"{prefix}{i}")).read().splitlines()
            for i in range(5)]


@pytest.mark.parametrize("subdir,prefix", [
    ("flickr_refs", "f_ref"),       # Flickr30k test-set human captions
    ("coco_refs", "ref"),           # COCO val human captions
])
def test_real_captions_gate_through_lrcn_torch(reference_eval_dir, tmp_path,
                                               subdir, prefix):
    """tests/test_real_captions.py's protocol, bars and negative control
    through the port's CLI, tokenizer, references and BLEU: trained on 4
    of 5 human references of 64 images, captions from unseen noisy feature
    codes scored against the 5th, against the human inter-annotator BLEU;
    mismatched features must crater."""
    refs = _load_refs(reference_eval_dir, subdir, prefix)
    sel = [i for i in range(len(refs[0]))
           if all(3 <= len(r[i].split()) <= MAX_WORDS for r in refs)]
    assert len(sel) >= N_IMAGES, "fixture drift: too few short-caption rows"
    sel = sel[:N_IMAGES]
    ids = [5000 + k for k in range(len(sel))]
    sel_by_id = dict(zip(ids, sel))

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    with open(train_json, "w") as f:
        json.dump({"annotations": [
            {"image_id": iid, "caption": refs[r][i]}
            for iid, i in zip(ids, sel) for r in range(4)]}, f)
    with open(val_json, "w") as f:
        json.dump({"annotations": [
            {"image_id": iid, "caption": refs[HELD_OUT][i]}
            for iid, i in zip(ids, sel)]}, f)

    eye = np.eye(len(ids), dtype=np.float32)

    def noisy_store(seed):
        rng = np.random.default_rng(seed)
        feats = {iid: eye[k] + 0.02 * np.abs(
            rng.standard_normal(len(ids))).astype(np.float32)
            for k, iid in enumerate(ids)}
        return {iid: v / v.sum() for iid, v in feats.items()}

    store = str(tmp_path / "feats_train")
    FeatureStore.from_dict(noisy_store(17), normalized=True).save(store)
    eval_store = str(tmp_path / "feats_eval")
    eval_feats = noisy_store(18)               # fresh noise, unseen rows
    FeatureStore.from_dict(eval_feats, normalized=True).save(eval_store)
    for iid in ids[:4]:                        # really different vectors
        assert not np.allclose(noisy_store(17)[iid], eval_feats[iid])

    ckpt = str(tmp_path / "ckpt")
    assert port_main([
        "train", "--datafiles", train_json, val_json,
        "--features", store, "--savefile", ckpt, "--vocab-min-count", "1",
        "--epochs", "28", "--batchsize", "16", "--lr", "6e-3",
        "--hidden", "96", "96", "--embed", "64", "--seed", "13",
        "--dropout", "0.0", *F32]) == 0

    def generate(features, tag):
        cand, ids_file = str(tmp_path / f"{tag}.txt"), str(
            tmp_path / f"{tag}_ids.txt")
        assert port_main([
            "generate", "--loadfile", ckpt, "--features", features,
            "--datafiles", train_json, val_json, "--vocab-min-count", "1",
            "--capnumber", str(len(ids)), "--generate", str(MAX_WORDS + 4),
            "--beam_width", "3", "--batch-size", str(len(ids)),
            "--out", cand, "--ids-out", ids_file, "--seed", "7", *F32]) == 0
        with open(ids_file) as f:
            return cand, [int(x) for x in f.read().split()]

    cand, order = generate(eval_store, "cands")
    assert sorted(order) == sorted(ids)
    caps = {iid: [(refs[HELD_OUT][sel_by_id[iid]].strip().strip(".")
                   + " .").lower()] for iid in order}
    write_reference_files(order, caps, str(tmp_path / "refs1"), "ref",
                          n_refs=1)
    stem = str(tmp_path / "refs1" / "ref")
    model = multi_bleu_files(stem, cand)

    human_b1, human_b4 = [], []
    for r in range(4):
        hyp = str(tmp_path / f"human{r}.txt")
        with open(hyp, "w") as f:
            for iid in order:
                f.write(" ".join(tokenize_coco_caption(
                    refs[r][sel_by_id[iid]])) + " .\n")
        h = multi_bleu_files(stem, hyp)
        human_b1.append(h.bleu[0])
        human_b4.append(h.bleu[3])
    h1, h4 = float(np.mean(human_b1)), float(np.mean(human_b4))
    assert h4 > 0.03, f"fixture drift: human ceiling degenerate ({h4})"

    with open(cand) as f:
        lines = f.read().splitlines()
    diag = (f"model {model.format()}\nhuman b1={h1:.4f} b4={h4:.4f}\n"
            f"first candidates: {lines[:3]}")
    assert len(set(lines)) >= len(ids) // 2, diag
    assert model.bleu[3] >= 0.6 * h4, diag
    assert model.bleu[0] >= 0.8 * h1, diag

    # negative control: every image decoded from its neighbour's code
    shuffled = {ids[k]: eval_feats[ids[(k + 1) % len(ids)]]
                for k in range(len(ids))}
    bad_store = str(tmp_path / "feats_shuffled")
    FeatureStore.from_dict(shuffled, normalized=True).save(bad_store)
    bad_cand, bad_order = generate(bad_store, "cands_bad")
    write_reference_files(bad_order, caps, str(tmp_path / "refs_bad"),
                          "ref", n_refs=1)
    bad = multi_bleu_files(str(tmp_path / "refs_bad" / "ref"), bad_cand)
    assert bad.bleu[3] < 0.6 * h4, (model.bleu, bad.bleu)
    assert bad.bleu[3] < 0.5 * model.bleu[3], (model.bleu, bad.bleu)
