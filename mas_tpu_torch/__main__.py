"""``python -m mas_tpu_torch`` -> the CLI (``cli.run``).

The ``__name__`` guard keeps an import of this module from running the
CLI: worker processes started by spawn re-import the main module.
"""

import sys

from .cli import run

if __name__ == "__main__":
    sys.exit(run())
