"""The worker side of the elastic launcher's protocol: the rendezvous KV
client (``http``), the authenticated frames (``common.util``) and the
notification service a driver reaches each worker on (``elastic``). The
driver itself is the JAX package's launcher (``python -m
horovod_tpu.run``), whose frames these are byte for byte."""
