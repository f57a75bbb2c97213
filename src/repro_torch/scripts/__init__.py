"""Command-line twins of the JAX package's scripts, run as modules:
``python -m repro_torch.scripts.convert`` and
``python -m repro_torch.scripts.chaos_matrix``."""
