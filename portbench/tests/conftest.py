"""The benchmark's own tests, on the CPU: ``python -m pytest portbench/tests``
(from the repository's root; they import no jax)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
