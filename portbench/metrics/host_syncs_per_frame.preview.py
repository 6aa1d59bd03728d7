"""Calls a frame of the program that block the host on the stream (its gf.host_syncs counter)."""
from portbench.program_trace import host_syncs


def read(t):
    return host_syncs(t)
