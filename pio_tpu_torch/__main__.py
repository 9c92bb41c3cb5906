"""``python -m pio_tpu_torch`` — the `pio` CLI of the port."""

import sys

from pio_tpu_torch.tools.cli import main

if __name__ == "__main__":
    sys.exit(main())
