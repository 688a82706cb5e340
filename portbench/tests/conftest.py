"""The benchmark's own tests (not part of the repository's suite):

    python -m pytest portbench/tests -q

They run on the CPU at toy sizes; the one test that needs the card is
marked `cuda` and skips, deciding inside the test, where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
