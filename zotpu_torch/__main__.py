import sys

from zotpu_torch.cli import main

sys.exit(main())
