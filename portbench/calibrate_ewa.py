"""``calibrate.py`` for the EWA cells: the same runs and output lines, with
the EWA control (``ewa_control.py``: the reference's EWA remap in bfloat16)
in place of the control's EWA planes:

    python3 -m portbench.calibrate_ewa --workload gopro4k-ewa-preview --seconds 2 --seeds <n> ...
"""
from __future__ import annotations

import sys

from . import calibrate, ewa_control


def main(argv=None) -> int:
    with ewa_control.installed():
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
