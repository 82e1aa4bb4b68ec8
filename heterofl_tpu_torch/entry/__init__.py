"""Entry points (``python -m heterofl_tpu_torch.entry.<name>``)."""
