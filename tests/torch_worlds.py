"""Gloo worlds of the port for the tests: N subprocesses, one per rank.

``launch`` starts ``size`` processes of ``python -c worker spec inputs
out_0 .. out_{size-1}`` with the launcher environment of one host
(``HOROVOD_RANK/SIZE/LOCAL_*``, a free controller port whose successor,
the native controller's port, is free too); each rank writes
its results to ``out_<rank>`` as an ``.npz``. ``results`` waits for every
rank (killing them all past the timeout) and returns each rank's results.
A worker that sets ``dist.init_process_group`` itself (``WORLD_PRELUDE``)
can ``hvd.init``/``hvd.shutdown`` many meshes in one world.
"""

import json
import os
import subprocess
import sys

import numpy as np

from horovod_tpu_torch.common.config import free_port_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Joins the gloo world once; hvd.init then adopts it, so one process can
# run many meshes (hvd.shutdown leaves an adopted group alone).
WORLD_PRELUDE = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, size = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
dist.init_process_group(
    "gloo",
    init_method=f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}",
    rank=rank, world_size=size)
spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
res = {}
"""
# Leaves the world together: a rank that exits while a peer still holds
# its gloo connections can kill that peer's process at exit.
WORLD_EPILOGUE = r"""
np.savez(sys.argv[3 + rank], **res)
dist.barrier()
dist.destroy_process_group()
"""


class World:
    """A launched world; ``results()`` waits for it."""

    def __init__(self, procs, outs):
        self.procs, self.outs = procs, outs
        self._results = None

    def results(self, timeout=180):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r}:\n{log}"
            self._results = [dict(np.load(o)) for o in self.outs]
        return self._results


def launch(worker: str, size: int, tmp, spec: dict, inputs: dict,
           local_size=None) -> World:
    """Start a ``size``-rank world running ``worker`` (Python source);
    ``local_size`` ranks to a host (default all), cross-major."""
    local_size = local_size or size
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps(spec))
    outs = [tmp / f"rank{r}.npz" for r in range(size)]
    port = free_port_pair()
    procs = []
    for r in range(size):
        renv = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size),
                    HOROVOD_LOCAL_RANK=str(r % local_size),
                    HOROVOD_LOCAL_SIZE=str(local_size),
                    HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                    HOROVOD_CONTROLLER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, str(tmp / "spec.json"),
             str(tmp / "inputs.npz"), *map(str, outs)], cwd=REPO, env=renv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return World(procs, outs)
