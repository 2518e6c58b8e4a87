"""Measurement tools of the port: ``python -m mcm_tpu_torch.tools.<name>``."""
