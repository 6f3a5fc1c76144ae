"""The user-facing drivers of the port, run as
``python -m traversability_estimation_tpu_torch.scripts.<name>``."""
