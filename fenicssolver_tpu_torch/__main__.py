"""``python -m fenicssolver_tpu_torch case.json`` (port of
``fenicssolver_tpu/__main__.py``).

Runs on ``FST_DEVICE`` (default ``cuda``; ``FST_DEVICE=cpu`` for the CPU)
in float64 unless ``FST_X32=1``.
"""

import sys

from .main import main

main(sys.argv)
