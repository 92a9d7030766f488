"""``python -m byzantine_aircomp_tpu_torch.analysis <reader> [args]``: run
one reader's CLI (``python -m byzantine_aircomp_tpu_torch.analysis.<reader>``
does the same)."""

import importlib
import sys

from . import READERS

if len(sys.argv) < 2 or sys.argv[1] not in READERS:
    print(f"usage: python -m byzantine_aircomp_tpu_torch.analysis "
          f"{{{','.join(READERS)}}} [args]", file=sys.stderr)
    sys.exit(2)
sys.exit(importlib.import_module(f".{sys.argv[1]}", __package__).main(sys.argv[2:]) or 0)
