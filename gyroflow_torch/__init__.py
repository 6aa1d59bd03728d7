"""gyroflow_torch — the gyroflow-tpu stabilizer on PyTorch and CUDA (Hopper).

A port of ``gyroflow_tpu`` that imports torch and never jax, and nothing of
``gyroflow_tpu``. The host layers (telemetry, IMU integration, smoothing,
keyframes, lens profiles, the frame transform) are this package's own copies
of the JAX package's numpy modules, laid out as they are there; the remap is a
torch twin, and the Pallas kernels of the render path are CUDA kernels in
``csrc/`` (built with nvcc at first use).

Entry point: ``gyroflow_torch.core.manager.StabilizationManager``, which runs
on ``cuda:0`` unless the caller passes another device (``device="cpu"``).
"""

__version__ = "0.1.0"
