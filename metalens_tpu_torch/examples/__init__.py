"""Runnable end-to-end examples of the port (``python3 -m
metalens_tpu_torch.examples.<name>``)."""
