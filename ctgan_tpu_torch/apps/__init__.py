"""Runnable apps (``python -m ctgan_tpu_torch.apps.<name>``)."""
