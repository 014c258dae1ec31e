"""The benchmark's own tests: ``python -m pytest hwabench/tests`` from the
root of the repo (they import ``hwabench`` from the root and the port
from ``src``)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

