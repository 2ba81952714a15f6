"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from the
checkout's root.  Tests marked ``cuda`` need the card and skip without it."""

import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
