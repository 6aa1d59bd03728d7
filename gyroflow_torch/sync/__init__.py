"""Gyro-to-video synchronization: only ``optimsync`` (sync-point picking) is
carried by the port so far."""
