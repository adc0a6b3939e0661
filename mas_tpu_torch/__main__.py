"""``python -m mas_tpu_torch`` -> the CLI."""

import sys

from .cli import main

sys.exit(main())
