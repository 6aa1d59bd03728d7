"""Lens calibration: only ``drawing`` (the chessboard overlay) is carried by
the port so far."""
