"""Entry point: ``PYTHONPATH=src python -m repro_torch.analysis [paths ...]``."""
import sys

from .cli import main

sys.exit(main())
