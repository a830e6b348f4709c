"""The benchmark's own tests: its modules import each other by plain name
(``run.py`` puts its folder on the path), so the tests do the same."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
