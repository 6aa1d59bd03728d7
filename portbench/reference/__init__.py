"""The benchmark's plain reference: a frozen copy of the port's host modules
and its plain torch remap, imported by no code of the program.

It recomputes what a stabilized frame depends on from the raw inputs the
benchmark wrote (the gyro log or the Sony clip, the lens profile JSON, the
host frame planes): telemetry parsing, IMU integration, smoothing, adaptive
zoom, the per-row rolling-shutter matrices and FOV of the frame transform,
then the per-pixel coordinates (RS row select, lens projection, Sony mesh,
focal-plane shears and IBIS), lanczos4 sampling and the finish (background,
colour range, rint, clamp, uint16) in plain torch float32.

The files under ``core/``, ``ops/`` and ``utils/`` are copies of the port's
modules of the same paths, taken when the benchmark was defined, with three
edits: ``ops/remap.py`` ends before ``remap_plane_cuda`` (the kernel entry
points), ``native.py`` is a stand-in that makes the copies take their plain
Python loops instead of the program's C++ helper, and
``core/telemetry/__init__.py`` is reduced to the two parsers used here.
``stabilizer.py`` is the part of the port's ``StabilizationManager`` that a
render of these deployments runs: loading, the recompute chain, the frame
transform and the per-plane configuration. Later changes to the program do
not reach these files, so the reference stays the yardstick.
"""
