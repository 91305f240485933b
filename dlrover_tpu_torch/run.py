"""``python -m dlrover_tpu_torch.run`` — console entry for the elastic launcher.

Copy of ``dlrover_tpu/run.py``.

Reference parity: the ``dlrover-run`` console script
(``dlrover/setup.py:57-59`` → ``dlrover/trainer/torch/main.py``).
"""

import sys

from dlrover_tpu_torch.trainer.elastic_run import main

if __name__ == "__main__":
    sys.exit(main())
