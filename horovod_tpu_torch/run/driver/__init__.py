"""The task services' driver (the port's copy of
``horovod_tpu/run/driver/``)."""
