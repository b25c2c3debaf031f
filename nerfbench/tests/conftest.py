"""The benchmark's tests: run from the repository root with
`python -m pytest nerfbench/tests -q` (CPU); the card's with
`python -m pytest nerfbench/tests -q -m cuda` on a machine with one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
