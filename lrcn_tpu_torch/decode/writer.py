"""Caption generation driver (counterpart of ``lrcn_tpu/decode/writer.py``).

The eval-file helpers (``write_candidate_files``, ``pick_eval_ids``,
``pick_eval_ids_from_captions``) are copies of the JAX package's: they are
numpy-only, but their module imports JAX.  ``caption_to_line`` and
``detokenize_batch``, copies too, live in ``core/vocab.py`` (the exported
programs' consumer path loads nothing of ``decode``) and are re-exported
here.  Each caption line is the generated words joined by spaces with a
trailing `` .`` (lrcn.jl:634-640).

``generate_captions`` decodes beam (or greedy, ``beam_width=1``) captions
in groups of ``scan_depth`` batches of ``batch_size`` rows, each group one
search on the device, or, with ``sample_n > 0``, the paper's best-of-N
sampling (``decode/sample.py``), one batch of ``batch_size`` images a
search.  The decoder is the LRCN decoder or the MoE text decoder
(``models/moe_text.py``); the search picks its steps by the decoder's
type, once a search (``decode/beam.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch import as_device
from lrcn_tpu_torch.core.vocab import (  # noqa: F401
    Vocab,
    caption_to_line,
    detokenize_batch,
)
from lrcn_tpu_torch.data.feature_store import (
    FeatureStore,
    device_table,
    l1_normalize,
)
from lrcn_tpu_torch.decode.beam import rows_search, search
from lrcn_tpu_torch.decode.sample import best_of_n_search
from lrcn_tpu_torch.models.lrcn import LRCNDecoder
from lrcn_tpu_torch.utils.profiling import span

MAX_INFLIGHT = 4   # searches queued ahead of the oldest fetch


def generate_captions(decoder: LRCNDecoder, vocab: Vocab,
                      store: FeatureStore, image_ids: Sequence[int], *,
                      device, beam_width: int = 3, max_words: int = 30,
                      batch_size: int = 64, scan_depth: int = 4,
                      max_inflight: int = MAX_INFLIGHT,
                      resident_store: bool | None = None,
                      normalize: bool | None = None,
                      sample_n: int = 0, temperature: float = 2.0,
                      generator: torch.Generator | None = None) -> list[str]:
    """Decode captions for ``image_ids``; one line per id, in order.

    Strategies: beam search (default), greedy (``beam_width=1``), or the
    paper's best-of-N sampling (``sample_n > 0`` draws at
    ``temperature``; the noise comes from ``generator``, on ``device``, a
    seed-0 one by default).  Sampling decodes each batch of
    ``batch_size`` images as one search of ``batch_size * sample_n`` rows
    and ignores ``scan_depth`` and ``resident_store``.

    ``normalize``: L1-normalize the features on the fly; by default
    unless the store says they already are (the reference's ``featsn``
    files are pre-normalized; its live path normalizes at lrcn.jl:597).

    ``scan_depth`` batches decode as one search; up to ``max_inflight``
    searches are queued on the device before the oldest one's tokens are
    fetched, so the host enqueues the next group while the device works
    (more in flight holds more device memory).  Every group is padded to
    one shape, so on a card the run searches its first group eagerly,
    captures one search graph at the second and replays it for the rest;
    each replay returns tokens of their own, which the next one does not
    overwrite.

    ``resident_store``: upload the whole feature table to ``device`` once
    and gather rows there by index; by default when the run decodes at
    least as many rows as the table holds.

    Spans (``utils/profiling.py:span``): ``lrcn.generate`` around the
    call; inside it ``lrcn.generate.table`` (the resident table's
    ``device_table``: L1 normalization, upload and cast),
    ``lrcn.generate.enqueue`` (a group's row index or gather and its
    search call), ``lrcn.generate.fetch`` (its tokens to the host) and
    ``lrcn.generate.detokenize``.
    """
    with span("lrcn.generate"):
        device = as_device(device)
        if decoder.device != device:
            raise ValueError(f"decoder is on {decoder.device}, not {device}")
        if normalize is None:
            normalize = not store.normalized
        if sample_n > 0 and not isinstance(decoder, LRCNDecoder):
            raise ValueError("best-of-N sampling runs the LRCN decoder only")
        if sample_n > 0:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            scan_depth, resident_store = 1, False
        if resident_store is None:
            resident_store = 0 < len(store) <= len(image_ids)
        feat_dtype = decoder.compute_dtype   # the search casts to it first
        max_inflight = max(1, max_inflight)

        table = None
        if resident_store and len(store):
            with span("lrcn.generate.table"):
                table = device_table(store, device, feat_dtype,
                                     normalize=normalize)

        lines: list[str] = []
        # (device tokens, n_real)
        pending: list[tuple[torch.Tensor, int]] = []

        def drain_one():
            tokens, n_real = pending.pop(0)
            with span("lrcn.generate.fetch"):
                tokens = tokens.cpu().numpy()
            with span("lrcn.generate.detokenize"):
                lines.extend(detokenize_batch(tokens[:n_real], vocab))

        rows_per_group = batch_size * max(1, scan_depth)
        for start in range(0, len(image_ids), rows_per_group):
            chunk = list(image_ids[start:start + rows_per_group])
            n_real = len(chunk)
            # pad to the full group with the last id: rows are independent
            chunk += [chunk[-1]] * (rows_per_group - n_real)
            with span("lrcn.generate.enqueue"):
                if table is not None:
                    idx = torch.from_numpy(store.rows(chunk).astype(np.int64))
                    tokens, _ = rows_search(decoder, table, idx.to(device),
                                            beam_width=beam_width,
                                            max_words=max_words)
                else:
                    feats = store.gather(chunk)
                    if normalize:
                        feats = l1_normalize(feats)
                    feats = torch.from_numpy(feats).to(device)
                    if sample_n > 0:
                        tokens, _ = best_of_n_search(
                            decoder, feats, n_samples=sample_n,
                            temperature=temperature, max_words=max_words,
                            generator=generator)
                    else:
                        tokens, _ = search(decoder, feats,
                                           beam_width=beam_width,
                                           max_words=max_words)
            pending.append((tokens, n_real))
            if len(pending) > max_inflight:
                drain_one()
        while pending:
            drain_one()
        return lines


def write_candidate_files(lines: Sequence[str], image_ids: Sequence[int],
                          candidates_path: str, ids_path: str) -> None:
    """Write the caption + id files consumed by the eval harness
    (reference: lrcn.jl:133-139,600)."""
    with open(candidates_path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    with open(ids_path, "w") as f:
        for image_id in image_ids:
            f.write(f"{int(image_id)}\n")


def pick_eval_ids(image_ids: Sequence[int], capnumber: int,
                  rng: np.random.Generator) -> list[int]:
    """Choose ``capnumber`` unique image ids at random (lrcn.jl:142-150)."""
    unique = list(dict.fromkeys(int(i) for i in image_ids))
    rng.shuffle(unique)
    return unique[:capnumber]


def pick_eval_ids_from_captions(captions: Sequence, capnumber: int,
                                rng: np.random.Generator,
                                store: FeatureStore | None = None
                                ) -> list[int]:
    """The reference's eval-id sampling protocol (lrcn.jl:142-150).

    Shuffle the *held-out caption split* (``caption_dicts[2]`` for COCO val,
    ``caption_dicts[3]`` for the Flickr test split, lrcn.jl:132-150) and
    collect unique image ids until ``capnumber`` are chosen.  Sampling from
    the caption split — never from the feature store — guarantees no
    training image is ever captioned for evaluation, even against a
    full-corpus store (e.g. the Karpathy import covers all 30k Flickr
    images).

    Ids whose features are missing from ``store`` are skipped with a
    warning (the reference instead dies mid-run on the first missing
    feature, lrcn.jl:603).
    """
    order = list(captions)
    rng.shuffle(order)
    ids: list[int] = []
    seen: set[int] = set()
    missing = 0
    for cap in order:
        image_id = int(cap.image_id)
        if image_id in seen:
            continue
        seen.add(image_id)
        if store is not None and image_id not in store:
            missing += 1
            continue
        ids.append(image_id)
        if len(ids) == capnumber:
            break
    if missing:
        print(f"generate: skipped {missing} held-out ids with no stored "
              f"features")
    return ids
