"""The port's twins of the reference's ``examples/``: each module does
what its reference does, step by step, with the same prints, on the card
unless ``--device cpu``.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.distributed_load [--world 2]
    python -m repro_torch.examples.serve_lm
    python -m repro_torch.examples.train_lm --steps 200
"""
