"""The benchmark's tests: `python -m pytest benchmark/tests -q` from the
repository's root (CPU; the `cuda` tests skip there).  On a CUDA host:
`python -m pytest benchmark/tests -q -m cuda`."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
