"""Command-line tools of the port (``python -m objectdetectionpl_tpu_torch.tools.<name>``)."""
