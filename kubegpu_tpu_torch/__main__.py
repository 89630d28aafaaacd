"""``python -m kubegpu_tpu_torch`` → the kubetpu CLI."""

import sys

from kubegpu_tpu_torch.cli import main

sys.exit(main())
