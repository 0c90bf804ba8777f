import sys

from pfemfort_tpu_torch.drivers.cli import main

sys.exit(main())
