import sys

from repro_torch.verify.cli import main

sys.exit(main())
