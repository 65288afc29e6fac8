"""models of the PyTorch/CUDA port (see horovod_tpu_torch/__init__.py)."""
