"""The readings that set each cell's upper limits: the control and the
planted faults, with the plain reference in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--program]

prints one JSON line per seed.  The benchmark's own runs never run this.
With ``--program`` it reads instead the program's own numbers (the lower
readings): for each seed, in this one process, the cell's set-up, one
unit of its window and its check.

- The control: the reference computed at the next precision below the
  configuration's (fp8 products for bf16, ``reference/precision.py``),
  read by the cell's own numbers against the float32 reference.
- Training cells: half of each batch left out, the mean taken over the
  rest (a fault planted in the reference).  A state left unchanged reads
  1 by the change's measure and needs no run.
- Caption cells: an answer altered where it is produced: in each
  reference caption the middle word replaced by the next word id; the
  answers of the next image returned for each image; and, where the
  cell compares ``beam_mismatch``, a greedy search in place of the
  beam.

Caption cells read the check's random sample (without the longest
caption, which depends on the served captions); rows are independent, so
the sample's readings are those of the full pass.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import inputs  # noqa: E402
from portbench.drivers import captions, training  # noqa: E402
from portbench.harness import spec as specs  # noqa: E402
from portbench.harness.main import Context, measure  # noqa: E402
from portbench.reference import lrcn as ref  # noqa: E402
from portbench.reference.precision import fp8, strict_float32  # noqa: E402


def training_readings(ctx, driver) -> dict:
    params, epochs = driver.reference_inputs(ctx)
    truth = training.reference_readings(ctx, params, epochs)
    return {
        "control_fp8": training.gaps(training.reference_readings(
            ctx, params, epochs, quant=fp8), truth, sys.stderr, "fp8"),
        "fault_half_batch": training.gaps(training.reference_readings(
            ctx, params, epochs, half_batch=True), truth, sys.stderr,
            "half_batch"),
        "fault_unchanged": {"change_gap": 1.0},
    }


def caption_readings(ctx, driver) -> dict:
    tr = ctx.traffic
    rng = inputs.host_rng(ctx.seed, inputs.CHECK)
    picked = np.sort(rng.choice(tr["images"], size=tr["check_captions"],
                                replace=False))
    truth = driver.reference_feats(ctx, picked)
    low = driver.reference_feats(ctx, picked, quant=fp8)
    p = inputs.decoder_weights(ctx.config, ctx.seed, ctx.device, "serve")
    search = functools.partial(ref.beam_search, p,
                               max_words=tr["max_words"])
    with strict_float32():
        control, _ = search(low, tr["beam_width"], quant=fp8)
        best, _ = search(truth, tr["beam_width"])
    altered = [c[:len(c) // 2] + [inputs.N_RESERVED + (
        c[len(c) // 2] + 1 - inputs.N_RESERVED) % (
        ctx.config["vocab_size"] - inputs.N_RESERVED)] + c[len(c) // 2 + 1:]
        if c else [inputs.N_RESERVED] for c in best]
    shifted = best[1:] + best[:1]
    read = lambda caps: {
        "caption_gap": captions.caption_gap(ctx, truth, caps),
        "beam_mismatch": captions.beam_mismatch(ctx, truth, caps, best)}
    out = {"control_fp8": read(control),
           "fault_token_altered": read(altered),
           "fault_wrong_image": read(shifted)}
    if "beam_mismatch" in ctx.limits:
        with strict_float32():
            out["fault_greedy"] = read(search(truth, 1)[0])
    if "fc7_gap" in ctx.limits:
        rel = ((low - truth).norm(dim=1) / truth.norm(dim=1)).max()
        out["control_fp8"]["fc7_gap"] = float(rel)
        shifted_feats = torch.roll(truth, 1, dims=0)
        out["fault_wrong_image"]["fc7_gap"] = float(
            ((shifted_feats - truth).norm(dim=1) / truth.norm(dim=1)).max())
    return out


def readings(cell: specs.Cell, seed: int, device) -> dict:
    ctx = Context(seed=seed, device=torch.device(device),
                  config=cell.config, traffic=cell.traffic,
                  limits=cell.limits)
    driver = specs.driver(cell.traffic["driver"])
    if hasattr(driver, "reference_inputs"):
        return training_readings(ctx, driver)
    return caption_readings(ctx, driver)


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    cell = specs.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        if args.program:
            result = measure(cell, seed, 0.0, False, "cuda", time.time())
            found = {"program": {k: v["value"]
                                 for k, v in result["checks"].items()}}
        else:
            found = readings(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": torch.cuda.get_device_name(0),
                          **found}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
