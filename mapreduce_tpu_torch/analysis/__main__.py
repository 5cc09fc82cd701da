"""``python -m mapreduce_tpu_torch.analysis`` -> the graphcheck CLI."""

import sys

from mapreduce_tpu_torch.analysis.cli import main

sys.exit(main())
