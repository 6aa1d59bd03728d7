"""Stand-in for the program's optional C++ helper: the reference always takes
the plain numpy and Python loops that the copied modules fall back to."""


def available() -> bool:
    return False
