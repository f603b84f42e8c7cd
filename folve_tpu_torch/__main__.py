import sys

from folve_tpu_torch.cli import main

sys.exit(main())
