"""The benchmark of ``dsort_tpu_torch`` on an NVIDIA H100.

``python3 -m sortbench.run --workload W --seed N --seconds S --trace 0|1``
runs one cell of the root ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one configuration, traffic mix, entry point or
metric sits in a file of its own, found by the name the manifest gives it:

- ``configs/<config>.json``: the deployment (job size, key type, the
  ``JobConfig`` a user's command builds, the entry it drives);
- ``traffic/<traffic>.json``: the mix's parameters, read by the generator
  module it names under ``traffic/``;
- ``entries/<entry>.py``: how a job enters the program (``KIND`` and
  ``build(config, device)``);
- ``metrics/<metric>.py``: one reader a metric (``read(run)``), or
  ``metrics/<stem>.py`` for every ``<stem>.<suffix>`` metric.

The yardstick lives here too: the plain NumPy reference and the
comparison that decides ``correct`` (`reference`), the table of peaks and
the interval arithmetic (`yardstick`), the reduction of a torch.profiler
trace (`trace`).  Nothing in this package imports ``jax`` or the JAX
package ``dsort_tpu``; the program is imported only by the entries.
"""
