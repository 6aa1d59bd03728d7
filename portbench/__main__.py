import sys

from portbench.harness import main

if __name__ == "__main__":
    sys.exit(main())
