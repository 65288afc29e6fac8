"""Examples of the port, run as modules (``python -m
horovod_tpu_torch.examples.<name>``)."""
