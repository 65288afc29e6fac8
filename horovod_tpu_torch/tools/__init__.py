"""The port's operator tools, run as modules (``python -m
horovod_tpu_torch.tools.<name>``): the control plane's round-trip bench
(``controller_bench``), the attention kernels' microbench
(``kernel_bench``), a profiled image-model step (``profile_resnet``) and
the chaos schedule inspector (``chaos_sched``)."""
