#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload em_dirichlet_imagenet.zs --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is the result (benchmark/README.md).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
