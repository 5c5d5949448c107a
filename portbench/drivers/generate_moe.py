"""Bulk caption generation over stored fc7 features with the MoE text
decoder (``lrcn_tpu_torch/models/moe_text.py``), as ``lrcn-torch
generate`` runs it: ``decode/writer.py:generate_captions`` over every id
of the split, with the resident table, at the geometry
``cli.decode_geometry`` picks for the run.

Set-up: the decoder's weights made from the seed a tensor at a time and
cast to bf16 on the card (``moe_inputs.py``), a feature store of the
split's rows, then two passes that warm up the one search shape (the
first runs eagerly, the second captures its graph); the expert counter is
zeroed after them.  A unit of the window is one pass over the split.

After the window (``release``), the timed search runs once more at the
timed sizes, as ``generate_captions`` runs it (the table and the group
of row indices of the last pass), and its tokens and scores are kept;
then the program is freed.  The check (``check``) compares logits, not
sampled tokens, over every caption of the last pass, against the float32
reference (``reference/kimi_vl_text.py``, teacher-forced on each
caption's words, one layer's weights made on the card at a time, each
matrix rounded as the program holds it, ``moe_inputs.Weights``'s
``held``):

- ``missing_captions``: the window's captions never returned;
- ``rerun_mismatch``: lines of the rerun unlike the last pass's (the
  scores below are the rerun's, so they are the last pass's only where
  its tokens are);
- ``score_gap``: the widest gap, in nats a token, between a caption's
  returned score and the reference's sum of the log-probabilities of the
  tokens that score covers (its path's words, then EOS where it ended;
  ``reference.path_words``: a path that emitted EOS and went on keeps
  the words after it, which its line leaves out): it reads the prefill,
  the latent cache and its reorder, the experts and the log-sum-exp at
  once;
- ``score_deficit``: the widest amount, in nats a token, by which a
  returned score lies below that sum.  Rounding errs the other way: a
  search keeps the tokens its own rounding favours, so bf16's scores lie
  above the reference's (0.22 nats a token on average, on an H100), and
  a search whose scores all lie low, as under a log-sum-exp too large by
  a term of its own size, reads here where ``score_gap`` cannot tell it
  from bf16's spread;
- ``caption_gap``: the widest gap, in nats, by which a token of a served
  path lies below the reference's ``beam``-th best log-probability at
  its position (``drivers/captions.py``).

Routing near-ties of the reference (a token whose 6th and 7th experts
score within ``reference.NEAR_TIE``) are counted and printed beside the
check: they, and the vocabulary's own near-ties, set the program's
spread.

    python3 portbench/drivers/generate_moe.py --seeds 1 2 3 \
        [--program [--fault NAME ...]]

prints the upper readings (``control``: the reference's beam search over
the traffic's ``control_images`` rows with every product's operands in
float8 e4m3, and faults planted in its float32 search's answers, each
checked against the cell's limits), or with ``--program`` the program's
own (set-up, one unit and the check), sound or with each fault of
``FAULTS`` planted in it; one JSON line a seed and reading, with its
checks' values and whether they pass: the readings that set the cell's
limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from unittest import mock

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import inputs  # noqa: E402
from portbench.drivers import captions  # noqa: E402
from portbench.harness.main import Check  # noqa: E402
from portbench.moe_inputs import Weights  # noqa: E402
from portbench.reference import kimi_vl_text as ref  # noqa: E402
from portbench.reference.precision import fp8, strict_float32  # noqa: E402


def program_decoder(ctx):
    from lrcn_tpu_torch.config import MoETextConfig
    from lrcn_tpu_torch.models.moe_text import MoETextDecoder

    cfg = ctx.config
    return MoETextDecoder(MoETextConfig.from_dict(cfg),
                          Weights(cfg, ctx.seed, ctx.device),
                          getattr(torch, cfg["compute_dtype"]))


class Work:
    def __init__(self, ctx):
        from lrcn_tpu_torch.cli import decode_geometry
        from lrcn_tpu_torch.data.feature_store import FeatureStore

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.n = tr["images"]
        self.ids = [int(i) for i in inputs.image_ids(self.n, ctx.seed)]
        rows = inputs.fc7_rows(self.n, cfg["cnn_feature_dim"], ctx.seed,
                               ctx.device).cpu().numpy()
        self.store = FeatureStore(dim=cfg["cnn_feature_dim"], normalized=True)
        for image_id, row in zip(self.ids, rows):
            self.store.add(image_id, row)
        ctx.note("store")
        self.decoder = program_decoder(ctx)
        self.vocab = captions.program_vocab(cfg)
        self.batch, self.depth = decode_geometry(self.n, None, None)
        self.passes: list[list[str]] = []
        self.rerun = None
        ctx.note("decoder")

    def run_pass(self) -> list[str]:
        from lrcn_tpu_torch.decode.writer import generate_captions

        tr = self.ctx.traffic
        return generate_captions(
            self.decoder, self.vocab, self.store, self.ids,
            device=self.ctx.device, beam_width=tr["beam_width"],
            max_words=tr["max_words"], batch_size=self.batch,
            scan_depth=self.depth, resident_store=True)

    def unit(self) -> None:
        self.passes.append(self.run_pass())

    def counts(self) -> dict:
        from lrcn_tpu_torch.models.moe_text import expert_counts

        out = captions.pass_counts(self.passes, self.n, self.ctx.traffic)
        out["experts"] = expert_counts(self.decoder)
        out["searches"] = len(self.passes) * -(-self.n // (self.batch
                                                          * self.depth))
        out["hypotheses"] = (self.ctx.traffic["beam_width"] * self.batch
                             * self.depth)
        return out

    def search_again(self) -> tuple[np.ndarray, np.ndarray]:
        """The timed search once more over the last pass's group: tokens
        and scores of its real rows, on the host."""
        from lrcn_tpu_torch.data.feature_store import device_table
        from lrcn_tpu_torch.decode.beam import rows_search

        tr = self.ctx.traffic
        rows = self.batch * self.depth
        chunk = self.ids + [self.ids[-1]] * (rows - self.n)
        table = device_table(self.store, self.ctx.device,
                             self.decoder.compute_dtype)
        idx = torch.from_numpy(self.store.rows(chunk).astype(np.int64))
        tokens, scores = rows_search(self.decoder, table,
                                     idx.to(self.ctx.device),
                                     beam_width=tr["beam_width"],
                                     max_words=tr["max_words"])
        return (tokens[:self.n].cpu().numpy(),
                scores[:self.n].float().cpu().numpy())

    def release(self) -> None:
        if self.n > self.batch * self.depth:
            raise ValueError("the rerun takes one search of the split")
        self.rerun = self.search_again()
        self.decoder = self.store = None

    def check(self):
        from lrcn_tpu_torch.core.vocab import detokenize_batch

        ctx = self.ctx
        lines = self.passes[-1]
        missing = sum(self.n - len(p) for p in self.passes)
        out = [Check("missing_captions", float(missing),
                     ctx.limits["missing_captions"])]
        tokens, scores = self.rerun
        again = detokenize_batch(tokens, self.vocab)
        out.append(Check("rerun_mismatch", float(sum(
            a != b for a, b in zip(again, lines)) + abs(len(again)
                                                        - len(lines))),
            ctx.limits["rerun_mismatch"]))
        words = [ref.path_words(row[1:]) for row in tokens.tolist()]
        feats = inputs.fc7_rows(self.n, ctx.config["cnn_feature_dim"],
                                ctx.seed, ctx.device)
        gaps = reference_gaps(ctx, feats, words,
                              torch.as_tensor(scores, device=ctx.device))
        return out + gap_checks(ctx, gaps)


GAPS = ("score_gap", "score_deficit", "caption_gap")


def gap_checks(ctx, gaps: dict) -> list[Check]:
    return [Check(n, gaps[n], ctx.limits[n]) for n in GAPS]


def reference_weights(ctx, device) -> Weights:
    """The seed's weights for the reference, as the program holds them."""
    cfg = ctx.config
    return Weights(cfg, ctx.seed, device, keep=("embedding", "head"),
                   held=getattr(torch, cfg["compute_dtype"]))


def reference_gaps(ctx, feats: torch.Tensor, words: list[list[int]],
                   scores: torch.Tensor, quant=None) -> dict:
    """``score_gap``, ``score_deficit`` and ``caption_gap`` of paths
    ``words``
    (``reference.path_words``) with scores ``scores`` over fc7 rows
    ``feats``, against the float32
    reference teacher-forced on them (``quant``: the reference's own
    precision where it is not float32); prints the routing near-ties."""
    cfg, tr = ctx.config, ctx.traffic
    get = reference_weights(ctx, feats.device)
    chunk = tr["check_chunk"]
    signed, caption_gap, ties = [], 0.0, []
    started = time.time()
    with strict_float32():
        for start in range(0, len(words), chunk):
            part = words[start:start + chunk]
            lp, kth, mask = ref.scored(get, cfg, feats[start:start + chunk],
                                       part, tr["max_words"],
                                       tr["beam_width"], quant, ties=ties)
            total = torch.where(mask, lp, 0.0).sum(1)
            signed.append((scores[start:start + chunk] - total)
                          / mask.sum(1))
            caption_gap = max(caption_gap, float(torch.where(
                mask, (kth - lp).clamp(min=0), 0.0).max()))
    signed = torch.cat(signed)
    print(f"check: score - reference a token over captions: mean "
          f"{float(signed.mean()):.4f} sd {float(signed.std()):.4f} min "
          f"{float(signed.min()):.4f} max {float(signed.max()):.4f}",
          file=sys.stderr)
    near, tokens = map(sum, zip(*ties)) if ties else (0, 0)
    print(f"check: routing near-ties {near} of {tokens} token-layers "
          f"(6th and 7th experts within {ref.NEAR_TIE}); reference "
          f"{time.time() - started:.1f} s", file=sys.stderr)
    return {"score_gap": float(signed.abs().max()),
            "score_deficit": float(-signed.min()),
            "caption_gap": caption_gap,
            "routing_near_ties": near / max(1, tokens)}


def setup(ctx) -> Work:
    from lrcn_tpu_torch.models.moe_text import reset_expert_counts

    work = Work(ctx)
    for _ in range(2):
        work.run_pass()
    reset_expert_counts(work.decoder)
    ctx.note("warm-up")
    return work


def control(ctx) -> dict[str, list[Check]]:
    """The upper readings, over the first ``control_images`` rows, each
    checked against the cell's limits: the reference's own beam search
    with fp8 operands, and two faults planted in its float32 search's
    answers (each caption's middle word replaced by the next word id;
    each row given the next row's caption and score), each read against
    float32; and, as the lower reading, the float32 search itself."""
    tr, cfg = ctx.traffic, ctx.config
    n = tr["control_images"]
    feats = inputs.fc7_rows(tr["images"], cfg["cnn_feature_dim"],
                            ctx.seed, ctx.device)[:n]
    get = reference_weights(ctx, ctx.device)
    search = lambda quant: ref.beam_search(get, cfg, feats, tr["beam_width"],
                                           tr["max_words"], quant=quant)
    with strict_float32():
        low, low_scores = search(fp8)
        best, scores = search(None)
    altered = [c[:len(c) // 2] + [inputs.N_RESERVED + (
        c[len(c) // 2] + 1 - inputs.N_RESERVED) % (
        cfg["vocab_size"] - inputs.N_RESERVED)] + c[len(c) // 2 + 1:]
        if c else [inputs.N_RESERVED] for c in best]
    readings = {"sound_f32": (best, scores),
                "control_fp8": (low, low_scores),
                "fault_token_altered": (altered, scores),
                "fault_wrong_image": (best[1:] + best[:1],
                                      torch.roll(scores, -1))}
    return {name: gap_checks(ctx, reference_gaps(ctx, feats, words, sc))
            for name, (words, sc) in readings.items()}


def _router_weights_by_bias():
    """The router weights its experts by ``s + bias``."""
    from lrcn_tpu_torch.models import moe_text

    def route(dec, j, x):
        cfg = dec.cfg
        i = cfg.first_k_dense_replace + j
        choice = torch.sigmoid(x.float() @ dec[f"layers/{i}/router"]) + dec[
            f"layers/{i}/router_bias"]
        w, idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1)
        return idx, w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor

    return moe_text, "route", route


def _shared_dropped():
    from lrcn_tpu_torch.models import moe_text

    combine = moe_text.combine
    return moe_text, "combine", lambda routed, w, shared: combine(
        routed, w, torch.zeros_like(shared))


def _cache_not_reordered():
    from lrcn_tpu_torch.models import moe_text

    return moe_text, "reorder_cache", lambda *args: None


def _lse_off_by_itself():
    """The log-sum-exp over twice the row's terms: off by log 2."""
    from lrcn_tpu_torch.decode import beam

    topk = beam.topk_logsumexp

    def broken(logits, k):
        vals, idx, lse = topk(logits, k)
        return vals, idx, lse + math.log(2.0)

    return beam, "topk_logsumexp", broken


# faults planted in the program, which the check has to catch
FAULTS = {"router_weights_by_bias": _router_weights_by_bias,
          "shared_dropped": _shared_dropped,
          "cache_not_reordered": _cache_not_reordered,
          "lse_off_by_itself": _lse_off_by_itself}


def planted(fault: str):
    """A context in which the program runs with ``fault`` planted."""
    return mock.patch.object(*FAULTS[fault]())


def _readings(checks: list[Check]) -> dict:
    return {**{c.name: c.value for c in checks},
            "correct": all(c.passed for c in checks)}


def main(argv: list[str]) -> int:
    from portbench.harness import spec as specs
    from portbench.harness.main import Context, measure

    p = argparse.ArgumentParser(description="the cell's limit readings")
    p.add_argument("--workload", default="kimi-vl-a3b-coco-fc7-generate")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", nargs="+", choices=sorted(FAULTS),
                   default=[], help="with --program: plant each in turn")
    args = p.parse_args(argv)
    cell = specs.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("generate_moe: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        if args.program:
            for fault in args.fault or [None]:
                with planted(fault) if fault else contextlib.nullcontext():
                    result = measure(cell, seed, 0.0, False, "cuda",
                                     time.time())
                checks = {k: v["value"] for k, v in result["checks"].items()}
                print(json.dumps({
                    "workload": args.workload, "seed": seed,
                    "device": torch.cuda.get_device_name(0),
                    fault or "program": {**checks,
                                         "correct": result["correct"]},
                    "memory_peak_bytes": result["device"][
                        "memory_peak_bytes"]}), flush=True)
                torch.cuda.empty_cache()
            continue
        ctx = Context(seed=seed, device=torch.device("cuda"),
                      config=cell.config, traffic=cell.traffic,
                      limits=cell.limits)
        found = {name: _readings(checks)
                 for name, checks in control(ctx).items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": torch.cuda.get_device_name(0),
                          **found}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
