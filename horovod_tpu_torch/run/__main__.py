"""``python -m horovod_tpu_torch.run`` == ``hvdrun``."""

import sys

from horovod_tpu_torch.run.launcher import main

if __name__ == "__main__":
    sys.exit(main())
