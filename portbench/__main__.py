"""``python3 -m portbench``: see :mod:`portbench.harness`."""

import time

_T_START = time.monotonic()

if __name__ == "__main__":
    import sys

    from portbench.harness import main

    sys.exit(main(t_start=_T_START))
