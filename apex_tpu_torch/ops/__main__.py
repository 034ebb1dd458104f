"""``python -m apex_tpu_torch.ops`` — the on-card check of every hand
kernel (``ops/compile_check.py``): builds and launches each kernel on the
attached card and holds it against its plain version. Exits non-zero
without a card."""

import sys

from apex_tpu_torch.ops.compile_check import main

if __name__ == "__main__":
    sys.exit(main())
