"""CLI entry point: ``python -m repro_torch.obs <run.jsonl>``."""

import sys

from repro_torch.obs.inspect import main

if __name__ == "__main__":
    sys.exit(main())
