"""Build per-image reference files for multi-bleu scoring (a copy of
``lrcn_tpu/evaluation/references.py``, whose package imports JAX).

Re-implements ``eval/eval.jl`` from the reference repo: given the candidate
image-id file written during generation, emit 5 reference files
(``ref0..ref4`` / ``f_ref0..f_ref4``) whose line s holds the s-th candidate
image's i-th ground-truth caption.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence


def coco_reference_captions(captions_json_text: str) -> dict[int, list[str]]:
    """image_id -> first 5 normalized captions (eval/eval.jl:8-22).

    Normalization: strip whitespace, strip trailing periods, append " ."
    and lowercase — exactly the reference's rewrite.
    """
    annotations = json.loads(captions_json_text)["annotations"]
    caps: dict[int, list[str]] = {}
    for item in annotations:
        arr = caps.setdefault(int(item["image_id"]), [])
        if len(arr) == 5:
            continue
        cap = str(item["caption"]).strip().strip(".")
        arr.append((cap + " .").lower())
    return caps


def flickr_reference_captions(token_lines: Sequence[str]) -> dict[int, list[str]]:
    """image_id -> captions from a Flickr ``.token`` file (eval/eval.jl:44-58)."""
    caps: dict[int, list[str]] = {}
    for line in token_lines:
        if not line.strip():
            continue
        head, rest = line.split("#", 1)
        image_id = int(head.split(".")[0])
        cap = rest.split("\t", 1)[1]
        caps.setdefault(image_id, []).append(cap.strip().lower())
    return caps


def write_reference_files(candidate_ids: Sequence[int],
                          caps: Mapping[int, list[str]],
                          out_dir: str, prefix: str,
                          n_refs: int = 5) -> list[str]:
    """Write ``{prefix}0..{prefix}{n_refs-1}`` aligned to candidate order
    (eval/eval.jl:24-34, :60-75)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{prefix}{i}") for i in range(n_refs)]
    files = [open(p, "w") for p in paths]
    try:
        for cid in candidate_ids:
            arr = caps.get(cid)
            if arr is None:
                raise KeyError(f"id missing in reference: {cid}")
            for i, f in enumerate(files):
                f.write(arr[i].strip() + "\n")
    finally:
        for f in files:
            f.close()
    return paths


def build_coco_references(candidate_ids_path: str, captions_json_path: str,
                          out_dir: str) -> str:
    """COCO flow of eval/eval.jl:1-38.  Returns the ref stem for scoring."""
    with open(candidate_ids_path) as f:
        ids = [int(ln) for ln in f if ln.strip()]
    with open(captions_json_path) as f:
        caps = coco_reference_captions(f.read())
    write_reference_files(ids, caps, out_dir, "ref")
    return os.path.join(out_dir, "ref")


def build_flickr_references(candidate_ids_path: str, token_path: str,
                            out_dir: str) -> str:
    """Flickr flow of eval/eval.jl:40-78.  Returns the ref stem for scoring."""
    with open(candidate_ids_path) as f:
        ids = [int(ln) for ln in f if ln.strip()]
    with open(token_path) as f:
        caps = flickr_reference_captions(f.readlines())
    write_reference_files(ids, caps, out_dir, "f_ref")
    return os.path.join(out_dir, "f_ref")
