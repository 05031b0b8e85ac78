"""Shared set-up of the benchmark's own tests (CPU, small boxes; the
``cuda`` tests skip without a card). Run from the repository's root:
``python -m pytest mdbench/tests``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
