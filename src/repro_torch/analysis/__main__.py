"""Entry point for ``python -m repro_torch.analysis``."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
