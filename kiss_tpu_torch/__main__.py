import sys

from kiss_tpu_torch.cli import main

sys.exit(main())
