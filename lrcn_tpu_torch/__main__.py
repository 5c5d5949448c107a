"""``python -m lrcn_tpu_torch``: the port's command line (``cli.py``)."""

import sys

from lrcn_tpu_torch.cli import main

sys.exit(main())
