"""The benchmark's tests: run from the repository's root,
``python -m pytest port_bench/tests -q``; those that need the card carry
the ``gpu`` marker and decide inside a fixture."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
