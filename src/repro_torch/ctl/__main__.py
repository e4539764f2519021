import sys

from repro_torch.ctl.cli import main

sys.exit(main())
