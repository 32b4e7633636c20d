"""The reference's example programs, run on the port:
``python -m repro_torch.examples.quickstart [--device cpu]``."""
