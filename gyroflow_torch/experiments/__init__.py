"""The JAX package's TPU experiments (``experiments/``) on the port's kernels.

Each module is the counterpart of one experiment that reaches a Pallas
kernel, with its kernel written for Hopper and a plain torch version beside
it:

- ``fused_bbox``: ``experiments/pallas_fused.py`` (projection + sampling
  with a per-tile uv bbox), kernel ``csrc/fused_bbox.cu``;
- ``perf_probe3``: window column sums at four alignments,
  ``csrc/probe_window.cu``;
- ``probe_sampler`` (driven by ``perf_probe4``, ``perf_probe5`` and
  ``perf_probe6``): the sampler's cost split and column-mix precisions,
  ``csrc/probe_sampler.cu``;
- ``perf_probe8``: an elementwise pass, a Triton kernel.

``run_all(device)`` runs every probe; ``python -m
gyroflow_torch.experiments.perf_probeN`` runs one on ``cuda:0``. Four
modules are no kernel probes: ``ewa_bench`` and ``probe_bench`` time the EWA
kernel and the probe-sampler and fused_bbox kernels of several copies of
the package side by side; ``prod_path_probe`` and ``renderer_loop_bench``
(the counterparts of the experiments of the same names) split a
production-path frame into its host stages and time the render loop with
the device step stubbed, for ``gyroflow_torch.bench``.
"""
from .perf_probe import run_all

__all__ = ["run_all"]
