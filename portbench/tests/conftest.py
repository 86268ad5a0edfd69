"""The benchmark's own tests: torch only, on the CPU (``cuda``-marked ones
skip without a card)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parents[1]))
