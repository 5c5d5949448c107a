"""Runnable end-to-end demo on synthetic data (no datasets needed); the
counterpart of ``examples/synthetic_end_to_end.py``.

Builds a LEARNABLE synthetic corpus (one-hot class features, one fixed
caption per class), then runs the reference workflow through the port's
command line and ASSERTS the quality gate:

    train -> generate (beam search) -> build references -> BLEU-4 >= 0.9

Because features determine the caption, a correct train -> decode -> eval
chain must overfit the corpus; exit codes alone would pass with a
silently broken model.  ``build_dataset`` writes the same files as the
JAX example (the same seed and the same store format).

    python -m lrcn_tpu_torch.examples.synthetic_end_to_end [--device cuda|cpu] [workdir]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from lrcn_tpu_torch import cli, require_cuda
from lrcn_tpu_torch.data.feature_store import FeatureStore, l1_normalize
from lrcn_tpu_torch.evaluation.bleu import BleuResult, multi_bleu_files
from lrcn_tpu_torch.evaluation.references import build_coco_references

WORDS = ("a man rides his bike dog runs on grass two children play in the "
         "park near water under trees").split()
N_CLASSES = 12
BLEU4_GATE = 0.90


def build_dataset(workdir: str):
    """COCO-style train/val jsons + one-hot feature stores per split."""
    rng = np.random.default_rng(17)
    class_caps = [
        " ".join(rng.choice(WORDS, 7)) + " ." for _ in range(N_CLASSES)]

    def make_split(name, id0, n_imgs):
        anns = [{"image_id": id0 + i, "caption": class_caps[i % N_CLASSES]}
                for i in range(n_imgs) for _ in range(5)]
        path = os.path.join(workdir, f"captions_{name}.json")
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        feats = {id0 + i: l1_normalize(
            np.eye(N_CLASSES, dtype=np.float32)[i % N_CLASSES][None])[0]
            for i in range(n_imgs)}
        store = os.path.join(workdir, f"{name}_feats")
        FeatureStore.from_dict(feats, normalized=True).save(store)
        return path, store

    train_json, train_store = make_split("train", 5000, 48)
    val_json, val_store = make_split("val", 9000, 24)
    return train_json, train_store, val_json, val_store


def train(workdir: str, device: str, train_json: str, val_json: str,
          train_store: str) -> str:
    """Train the decoder; returns the checkpoint's directory."""
    ckpt = os.path.join(workdir, "ckpt")
    cli.main(["--device", device, "train", "--datafiles", train_json,
              val_json, "--features", train_store, "--savefile", ckpt,
              "--epochs", "30", "--batchsize", "16", "--lr", "3e-3",
              "--hidden", "32", "32", "--embed", "24", "--seed", "13",
              "--dropout", "0.0",
              "--metrics", os.path.join(workdir, "metrics.jsonl")])
    return ckpt


def generate(workdir: str, device: str, ckpt: str, val_store: str
             ) -> tuple[str, str]:
    """Beam-search captions of the val split; returns the candidates' and
    their image ids' files."""
    cand = os.path.join(workdir, "candidates.txt")
    ids = os.path.join(workdir, "candidate_ids.txt")
    cli.main(["--device", device, "generate", "--loadfile", ckpt,
              "--features", val_store, "--capnumber", "24", "--generate",
              "12", "--beam_width", "2", "--out", cand, "--ids-out", ids,
              "--seed", "7"])
    return cand, ids


def score(workdir: str, cand: str, ids: str, val_json: str) -> BleuResult:
    """Per-image reference files and multi-BLEU (the reference's eval)."""
    stem = build_coco_references(ids, val_json,
                                 os.path.join(workdir, "refs"))
    return multi_bleu_files(stem, cand)


def main(workdir: str | None = None, device: str = "cuda") -> BleuResult:
    """Run the chain on ``device``; raises if BLEU-4 misses the gate."""
    if device != "cpu":
        require_cuda(device)        # the card, or an error: no CPU fallback
    workdir = workdir or tempfile.mkdtemp(prefix="lrcn_demo_")
    os.makedirs(workdir, exist_ok=True)
    print(f"== workdir: {workdir} (device {device})")
    train_json, train_store, val_json, val_store = build_dataset(workdir)

    print("== training (30 epochs, learnable synthetic corpus)")
    ckpt = train(workdir, device, train_json, val_json, train_store)

    print("== generating captions for the val split with beam search")
    cand, ids = generate(workdir, device, ckpt, val_store)
    with open(cand) as f:
        for line in f.read().splitlines()[:3]:
            print("   ", line)

    print("== building references + BLEU (reference eval flow)")
    result = score(workdir, cand, ids, val_json)
    print("   ", result.format())
    if result.bleu[3] < BLEU4_GATE:
        raise RuntimeError(f"quality gate failed: BLEU-4 "
                           f"{result.bleu[3]:.3f} < {BLEU4_GATE}")
    print(f"== quality gate PASSED (BLEU-4 >= {BLEU4_GATE})")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card) or cpu")
    parser.add_argument("workdir", nargs="?", default=None,
                        help="where to write the data, the checkpoint and "
                             "the candidates (default: a new temporary "
                             "directory)")
    args = parser.parse_args()
    main(args.workdir, args.device)
