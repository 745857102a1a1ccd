"""rtbench: the benchmark of ``tpu_rt_torch`` (the PyTorch and CUDA port) on
one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` and prints one JSON line
last on standard output, the numbers compared for ``correct`` last on
standard error:

    python3 -m rtbench.run --workload conference-ao8 --seed 7 --seconds 10 --trace 0

``--trace 1`` prints the per-layer metrics, ``device.busy_s`` /
``device.window_s`` and a ``breakdown`` from a profiled window.  The
limits' readings come from ``python3 -m rtbench.calibrate`` (the program
on a dozen seeds, the control on three).  The CPU tests:
``python -m pytest rtbench/tests -q`` (the card's: ``-m card``).

Caches, at fixed paths inside the checkout (git-ignored), so that only a
checkout's first run of a cell builds: the port's nvcc and g++ libraries in
``build/tpu_rt_torch/``; the scenes' meshes in ``build/rtbench/meshes/``;
the SBVH and quad-collapse cache in ``build/rtbench/bvhcache/``;
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under ``build/rtbench/``.
The profiler's trace is written to ``build/rtbench/trace/`` and deleted
once read.

Everything is found by name; a later change adds files and edits none:

- a configuration: ``configs/<name>.json`` (the frozen generator in
  ``data/procedural.py``, its arguments, the camera rule, the route) and an
  entry in ``BENCHMARK.json`` ``configs``;
- a traffic mix: ``traffic/<mix>.json`` (``driver``, ``ray_type``,
  ``samples``, ``sort_secondary``, frame size, ``poses``, ``max_batch`` and
  the judged sample's size);
- a driver (a new kind of window loop): ``drivers/<driver>.py`` with a
  ``Driver(common.Driver)`` (``drivers/common.py`` says what it defines);
- a per-layer metric: ``metrics/<metric>.py`` with ``read(record)``, which
  returns None where the run has nothing to read;
- a cell: an entry in ``BENCHMARK.json`` ``workloads`` and its limits,
  ``limits/<cell>.json``.

The plain reference (``reference/``) and the frozen data (``data/``)
import nothing of the program, of JAX or of the JAX package.
"""
