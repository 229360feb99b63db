"""The benchmark's own tests. On the CPU they run the harness at small sizes
with ``device="cpu"``; tests marked ``cuda`` run it on the card and skip
where there is none:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is false"
    )
