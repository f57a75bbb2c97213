"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
file-to-CSR and file-to-edge-list loads through its front door, driven by
``BENCHMARK.json`` at the root of the checkout.  ``python -m
gvelbench.run --help``."""
