"""`python -m shadow_tpu_torch [options] shadow.config.xml`."""

import sys

from shadow_tpu_torch.cli import main

sys.exit(main())
