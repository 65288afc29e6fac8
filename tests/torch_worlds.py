"""Gloo worlds of the port for the tests: N subprocesses, one per rank.

``launch`` starts ``size`` processes of ``python -c worker spec inputs
out_0 .. out_{size-1}`` with the launcher environment of one host
(``HOROVOD_RANK/SIZE/LOCAL_*``, a free controller port whose successor,
the native controller's port, is free too); each rank writes
its results to ``out_<rank>`` as an ``.npz``. ``results`` waits for every
rank (killing them all past the timeout) and returns each rank's results.
A worker that sets ``dist.init_process_group`` itself (``WORLD_PRELUDE``)
can ``hvd.init``/``hvd.shutdown`` many meshes in one world.

``ElasticLauncher`` runs an elastic launcher (``python -m horovod_tpu.run``
or ``python -m horovod_tpu_torch.run``) over a worker script with a
discovery script that reads ``hosts.txt``; ``ELASTIC_TRAIN`` is such a
worker on the port's binding.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np

from horovod_tpu_torch.common.config import NATIVE_PORT_OFFSET, free_port_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# First lines of a port interpreter that must not load jax: an import
# hook refusing ``jax``, ``jaxlib`` and ``horovod_tpu``. TensorFlow tries
# ``from jax import jit`` at import and takes its own ``ImportError``
# branch; a port module that imported any of them fails.
REFUSE_JAX = r"""
import importlib.abc, sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"):
            raise ImportError(f"{name} is refused in the port's interpreter")
        return None


sys.meta_path.insert(0, _Refuse())
"""

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


def held_port_pair():
    """(base port, holders): a pair from ``free_port_pair``, each port held
    at once by a socket of this process bound with ``SO_REUSEADDR`` that
    never listens. The world's rank 0 binds its store and native
    controller beside them (both set ``SO_REUSEADDR``), but no
    ``connect()`` on the host takes either as its ephemeral port while the
    world starts, before rank 0 holds them itself. Close the holders when
    the world has ended."""
    for _ in range(64):
        port, holders = free_port_pair(), []
        try:
            for p in (port, port + NATIVE_PORT_OFFSET):
                holders.append(socket.socket())
                holders[-1].setsockopt(socket.SOL_SOCKET,
                                       socket.SO_REUSEADDR, 1)
                holders[-1].bind(("", p))
            return port, holders
        except OSError:
            for sock in holders:
                sock.close()
    raise RuntimeError("no pair of free ports for a world")


class World:
    """A launched world; ``results()`` waits for it."""

    def __init__(self, procs, outs, holders=()):
        self.procs, self.outs = procs, outs
        self._holders = list(holders)
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
                for sock in self._holders:
                    sock.close()
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
    port, holders = held_port_pair()
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
    return World(procs, outs, holders)


# An elastic worker on the port's binding: ``CHURN_TARGET`` committed
# batches of a linear model whose gradient is all-reduced by name, a line
# a batch in ``CHURN_LOG``; with ``CHURN_DIE_MARKER`` rank 1 exits 13 at
# batch 3 once (the marker file stops its successor). It checks that
# neither jax nor the JAX package was loaded.
ELASTIC_TRAIN = textwrap.dedent("""
    import os, sys, time
    import torch
    import horovod_tpu_torch.torch as hvd

    LOG = os.environ.get("CHURN_LOG")
    TARGET = int(os.environ.get("CHURN_TARGET", "6"))
    MARKER = os.environ.get("CHURN_DIE_MARKER")
    PAUSE = float(os.environ.get("CHURN_PAUSE", "0"))

    def log_line(text):
        if LOG:
            with open(LOG, "a") as f:
                f.write(text + "\\n")

    hvd.init(device="cpu")
    model = torch.nn.Linear(4, 1)
    # No broadcast before the loop: state.sync() brings a worker that
    # joins mid-job into line.
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < TARGET:
            x = torch.ones(2, 4) * (hvd.rank() + 1)
            loss = model(x).sum()
            opt.zero_grad()
            loss.backward()
            grad = hvd.allreduce(model.weight.grad, op=hvd.Average,
                                 name=f"grad.b{state.batch}")
            model.weight.grad.copy_(grad)
            opt.step()
            if MARKER and hvd.rank() == 1 and state.batch == 3 \\
                    and not os.path.exists(MARKER):
                open(MARKER, "w").close()
                os._exit(13)
            state.batch += 1
            log_line(f"BATCH {state.batch} RANK {hvd.rank()} "
                     f"SIZE {hvd.size()}")
            time.sleep(PAUSE)
            state.commit()
        return state.batch

    batches = train(state)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]
    log_line(f"DONE RANK {hvd.rank()} BATCHES {batches}")
    print(f"ELASTIC_RANK_{hvd.rank()}_DONE_{batches}")
""")


class ElasticLauncher:
    """``python -m <module>`` (elastic, ``-np 2 --min-np 2``, a discovery
    script reading ``hosts.txt``) over ``script`` (Python source), its
    output in ``launcher.out``. On exit the launcher is interrupted and
    then killed if it still runs, and every worker it started (they run
    in sessions of their own) is killed: a failed test leaves no process
    behind."""

    def __init__(self, tmp_path, hosts, extra_args=(), extra_env=None,
                 module="horovod_tpu.run", script=ELASTIC_TRAIN):
        path = tmp_path / "train.py"
        path.write_text(script)
        self.hosts = tmp_path / "hosts.txt"
        self.hosts.write_text(hosts)
        discover = tmp_path / "discover.sh"
        discover.write_text(f"#!/bin/sh\ncat {self.hosts}\n")
        discover.chmod(0o755)
        self._tag = f"HVD_PORT_ELASTIC_TEST={tmp_path}"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   HVD_PORT_ELASTIC_TEST=str(tmp_path), **(extra_env or {}))
        self.out = tmp_path / "launcher.out"
        self._out_f = open(self.out, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "-np", "2",
             "--min-np", "2", "--host-discovery-script", str(discover),
             "--cycle-time-ms", "1.0", *extra_args, sys.executable,
             str(path)], env=env, cwd=REPO, stdout=self._out_f,
            stderr=subprocess.STDOUT)

    def wait(self, timeout):
        self.proc.wait(timeout=timeout)
        return self.proc.returncode, self.out.read_text()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        needle = self._tag.encode()
        for entry in os.listdir("/proc"):
            if not entry.isdigit() or int(entry) == os.getpid():
                continue
            try:
                with open(f"/proc/{entry}/environ", "rb") as f:
                    if needle in f.read():
                        os.kill(int(entry), signal.SIGKILL)
            except OSError:
                pass
        self._out_f.close()


def wait_for(predicate, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.25)
    raise AssertionError(f"timed out waiting for {what}")


def read(path):
    try:
        return path.read_text()
    except FileNotFoundError:
        return ""
