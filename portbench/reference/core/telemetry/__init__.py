"""The two telemetry parsers the benchmark's deployments read: ``gcsv``
(a GoPro-style 200 Hz gyro log) and ``sony`` (rtmd KLV samples in an MP4)."""
