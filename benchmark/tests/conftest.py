"""The benchmark's own tests: they run on the CPU, beside the repository's
suite (python -m pytest benchmark/tests). The harness's modules live in
benchmark/, imported by their short names as run.py imports them."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parents[1]))
