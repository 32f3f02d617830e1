"""``python -m lvt_tpu_torch kitti|euroc|tum|synthetic|bench``: see cli.py."""

import sys

from lvt_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
