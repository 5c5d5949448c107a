"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with a CUDA card.  The program's kernel
build cache stays in ``build/lrcn_tpu_torch/`` inside the checkout (the
program fixes it there), and any Triton or extension cache goes under
``build/portbench/``; the first run in a checkout builds, later ones load.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
sys.path.insert(0, ROOT)

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
