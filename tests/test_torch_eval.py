"""The port's evaluation half against the JAX package's, on the CPU: the
multi-BLEU scorer (native core and Python loop), its reference-file
loader and CLI, the reference builders, and the writer's eval helpers."""

import json
import os

import numpy as np
import pytest

from lrcn_tpu.core.tokenizer import Caption as JaxCaption
from lrcn_tpu.data.feature_store import FeatureStore as JaxStore
from lrcn_tpu.decode import writer as jax_writer
from lrcn_tpu.evaluation import bleu as jax_bleu
from lrcn_tpu.evaluation import references as jax_refs
from lrcn_tpu_torch.core.tokenizer import Caption
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.decode import writer
from lrcn_tpu_torch.evaluation import bleu, references
from lrcn_tpu_torch.native import bleu_library


def random_corpus(seed: int, n: int = 60, n_refs: int = 5):
    """Hypotheses and references from a 12-word vocabulary (so n-grams
    repeat and clip), with empty lines and mixed case."""
    rng = np.random.default_rng(seed)
    words = ["a", "man", "dog", "Rides", "the", "horse", "in", "park",
             "two", "play", ".", "ÉCOLE"]

    def line():
        return " ".join(rng.choice(words, rng.integers(0, 12)))

    hyps = [line() for _ in range(n)]
    refs = [[line() for _ in range(n_refs)] for _ in range(n - 3)]
    return hyps, refs     # the last 3 hypotheses have no references


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lowercase", [False, True])
def test_multi_bleu_matches_jax(monkeypatch, seed, lowercase):
    """The native core and the Python loop give the JAX package's result,
    field for field, on random corpora."""
    assert bleu_library() is not None
    hyps, refs = random_corpus(seed)
    want = jax_bleu.multi_bleu(hyps, refs, lowercase=lowercase)
    native = bleu.multi_bleu(hyps, refs, lowercase=lowercase)
    monkeypatch.setenv("LRCN_NATIVE", "0")
    python = bleu.multi_bleu(hyps, refs, lowercase=lowercase)
    assert bleu._counts_native(hyps, refs, lowercase) is None
    for got in (native, python):
        assert got.format() == want.format()
        assert (got.bleu, got.hyp_len, got.ref_len, got.ratio) == (
            want.bleu, want.hyp_len, want.ref_len, want.ratio)


def test_reference_files_and_cli_match_jax(tmp_path, capsys):
    """``load_reference_files`` (numbered files, the bare stem),
    ``multi_bleu_files`` and the ``-lc`` CLI print the JAX package's
    line."""
    hyps, refs = random_corpus(4, n=20, n_refs=3)
    stem = str(tmp_path / "ref")
    for i in range(3):
        with open(f"{stem}{i}", "w") as f:
            f.write("".join(r[i] + "\n" for r in refs))
    with open(stem, "w") as f:
        f.write("".join(r[0].upper() + "\n" for r in refs))
    hyp_path = str(tmp_path / "hyp")
    with open(hyp_path, "w") as f:
        f.write("".join(h + "\n" for h in hyps))
    assert bleu.load_reference_files(stem) == \
        jax_bleu.load_reference_files(stem)
    assert bleu.multi_bleu_files(stem, hyp_path).format() == \
        jax_bleu.multi_bleu_files(stem, hyp_path).format()
    import sys
    printed = []
    for mod in (bleu, jax_bleu):
        with open(hyp_path) as stdin:
            sys.stdin, saved = stdin, sys.stdin
            try:
                assert mod.main(["-lc", stem]) == 0
            finally:
                sys.stdin = saved
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].startswith("BLEU = ")
    assert bleu.main([str(tmp_path / "missing")]) == 1
    with pytest.raises(FileNotFoundError):
        bleu.load_reference_files(str(tmp_path / "missing"))


def test_reference_builders_match_jax(tmp_path):
    """COCO and Flickr flows (eval/eval.jl) write the same reference files
    in the same candidate order."""
    rng = np.random.default_rng(6)
    ids = [int(i) for i in rng.permutation(np.arange(100, 112))]
    annotations = [{"image_id": i, "caption": f" A Dog Runs {j}.. "}
                   for i in ids for j in range(6)]
    coco = str(tmp_path / "captions.json")
    with open(coco, "w") as f:
        json.dump({"annotations": annotations}, f)
    token = str(tmp_path / "flickr.token")
    with open(token, "w") as f:
        for i in ids:
            for j in range(5):
                f.write(f"{i}.jpg#{j}\tA Cat Sits {j} \n")
        f.write("\n")
    cand = str(tmp_path / "candidate_ids.txt")
    with open(cand, "w") as f:
        f.write("".join(f"{i}\n" for i in ids[:7]))
    for build, src, prefix in (
            ("build_coco_references", coco, "ref"),
            ("build_flickr_references", token, "f_ref")):
        stems = [getattr(mod, build)(cand, src, str(tmp_path / name))
                 for mod, name in ((references, "port"), (jax_refs, "jax"))]
        assert [os.path.basename(s) for s in stems] == [prefix, prefix]
        for i in range(5):
            with open(stems[0] + str(i)) as a, open(stems[1] + str(i)) as b:
                assert a.read() == b.read()
    with open(coco) as f:
        text = f.read()
    assert references.coco_reference_captions(text) == \
        jax_refs.coco_reference_captions(text)
    with pytest.raises(KeyError, match="999"):
        references.write_reference_files([999], {}, str(tmp_path / "x"),
                                         "ref")


def test_writer_eval_helpers_match_jax(tmp_path, capsys):
    """``write_candidate_files``, ``pick_eval_ids`` and
    ``pick_eval_ids_from_captions`` (with a store missing some ids) give
    the JAX package's files and ids from the same generator."""
    lines = ["a dog runs .", "two men play .", "."]
    ids = [7, 3, 11]
    paths = {}
    for mod, name in ((writer, "port"), (jax_writer, "jax")):
        paths[name] = (str(tmp_path / f"{name}_cand"),
                       str(tmp_path / f"{name}_ids"))
        mod.write_candidate_files(lines, ids, *paths[name])
    for a, b in zip(paths["port"], paths["jax"]):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    image_ids = [5, 3, 5, 9, 1, 3, 8, 2, 9]
    assert writer.pick_eval_ids(image_ids, 4, np.random.default_rng(1)) == \
        jax_writer.pick_eval_ids(image_ids, 4, np.random.default_rng(1))
    caps = [(i % 13, ("w",)) for i in range(40)]
    store, jstore = FeatureStore(dim=2), JaxStore(dim=2)
    for i in range(0, 13, 2):
        store.add(i, np.ones(2, np.float32))
        jstore.add(i, np.ones(2, np.float32))
    for capnumber, with_store in ((5, True), (20, True), (6, False)):
        got = writer.pick_eval_ids_from_captions(
            [Caption(i, w) for i, w in caps], capnumber,
            np.random.default_rng(2), store if with_store else None)
        want = jax_writer.pick_eval_ids_from_captions(
            [JaxCaption(i, w) for i, w in caps], capnumber,
            np.random.default_rng(2), jstore if with_store else None)
        assert got == want
        outs = capsys.readouterr().out.splitlines()
        assert len(outs) % 2 == 0 and outs[:len(outs) // 2] == \
            outs[len(outs) // 2:]
