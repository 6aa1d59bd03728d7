"""Millions of positions a frame that the program's coords launches project (gf.coords.points)."""
from portbench.ewa_readers import count_per_frame


def read(t):
    n = count_per_frame(t, "gf.coords.points")
    return None if n is None else n / 1e6
