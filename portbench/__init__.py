"""The benchmark of ``lungmask_tpu_torch`` (the PyTorch/CUDA port) on one
NVIDIA H100.

    python3 -m portbench.run --workload r231.apply --seed 7 --seconds 48 --trace 0

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration (``configs/``), its model family (``families/``; the
lungmask 2-D U-Net where the configuration names none), traffic mix
(``traffic/``), a lane the harness does not have (``lanes_extra/``) and
per-layer metrics (``layer_metrics/``) are files of their own that the
harness finds by name. ``reference/`` is the plain float32 PyTorch/NumPy reference that
decides ``correct``; it imports nothing of the port.
"""
