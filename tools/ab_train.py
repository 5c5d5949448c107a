"""Time the port's training step at the reference width in several
checkouts, in turns, on one CUDA card.

    python3 tools/ab_train.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (from the commit that added
``chip_smoke.py``'s training phase on).  Each runs in a process of its
own, in the order given (e.g. ``parent change change parent``, so that a
drift of the shared host shows as such): ``chip_smoke.train_setup`` of
that checkout (B=256, L=20, K=8, dropout 0.4, bf16, a 10,000-row table on
the card), one warm-up dispatch, then three timings of
``Trainer.train_epoch`` over the other 5 dispatches.  Prints one line a
run: ms per step of each timing and their median, and the peak memory.
No kernel is built: training launches none.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time


def time_one(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke

    if not chip_smoke.__file__.startswith(root):
        sys.exit(f"ab_train: imported {chip_smoke.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, params, opt, batches, store = chip_smoke.train_setup()
    shuffle = np.random.default_rng(chip_smoke.SEED)
    k = chip_smoke.TRAIN_K
    trainer.train_epoch(params, opt, batches[:k], store, 1, shuffle,
                        log_every=0)                    # warm-up dispatch
    timed = batches[k:]
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(params, opt, timed, store, 1, shuffle,
                            log_every=0)                # synchronizes
        ms.append((time.perf_counter() - t0) / len(timed) * 1e3)
    print(f"ab_train {root}: ms per step {[round(m, 3) for m in ms]}, "
          f"median {statistics.median(ms):.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        time_one(os.path.abspath(sys.argv[2]))
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)


if __name__ == "__main__":
    main()
