"""``python -m astcenc_torch``: the CLI (``cli.main``) on the card."""

import sys

from .cli import main

sys.exit(main())
