import sys

from .cli import main

rc = main()
# the tune subcommand returns its exit code; a run returns its record
sys.exit(rc if isinstance(rc, int) else 0)
