"""The benchmark of zigflac_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Prints one JSON line last (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, then
``checks``); exits non-zero with no result where there is no card, where
the program is missing, or where the process loaded JAX or the JAX package.
See benchmark/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    from harness.main import main  # noqa: E402

    sys.exit(main(sys.argv[1:], T0))
