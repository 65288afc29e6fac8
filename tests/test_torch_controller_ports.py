"""The native controller's port between the choice and the listen.

The native controller listens on the base port + 1 at every ``hvd.init``.
Where that port is free, any ``connect()`` on the host may take it as its
ephemeral local port, and rank 0 then fails with "coordinator failed to
listen". The intruder below binds the port as a ``connect()`` would,
without ``SO_REUSEADDR``.

- An elastic round: rank 0 chooses the pair, publishes it and later
  binds it. It holds the pair from the choice on, so the publish and the
  peers' polls cannot take it.
- A world that adopts the caller's ``torch.distributed`` group and runs
  several meshes (as the sp tests' worlds do): the port is free from the
  controller's bootstrap on, so rank 0 holds it from its first init,
  across ``hvd.shutdown`` and the next ``hvd.init``. The port refuses the
  intruder while the world is up and after each shutdown, and three
  inits in a row sum alike.
- A world the tests launch: the launching process holds the pair from
  its choice until the world ends (``torch_worlds.held_port_pair``), so
  the ports stay taken while the ranks start.
"""

import socket

import numpy as np

import torch_worlds

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import socket
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import config, state

intruder, held = None, []
for phase in range(3):
    hvd.init(device="cpu")
    total = hvd.allreduce(torch.tensor([rank + 1.0]), op=hvd.Sum)
    res[f"sum{phase}"] = total.numpy()
    # Rank 0 tries while the world is up, and again after its shutdown;
    # a port it takes stays taken.
    for when in ("up", "shut down"):
        if when == "shut down":
            hvd.shutdown()
        if rank == 0 and intruder is None:
            sock = socket.socket()
            try:
                sock.bind(("127.0.0.1", config.native_controller_port()))
                intruder = sock
                res["taken"] = np.array(f"phase {phase}, {when}")
            except OSError:
                sock.close()
        held.append(config.native_controller_port() in state._held_ports)
    dist.barrier()
res.setdefault("taken", np.array("never"))
res["held"] = np.array(held)
""" + torch_worlds.WORLD_EPILOGUE


def test_adopted_world_reinits_on_its_held_controller_port(tmp_path):
    world = torch_worlds.launch(WORKER, 2, tmp_path, {}, {"unused": 0})
    ranks = world.results(timeout=150)
    # Rank 0 holds the port while up and after each shutdown; rank 1
    # listens on nothing.
    np.testing.assert_array_equal(ranks[0]["held"], [True] * 6)
    np.testing.assert_array_equal(ranks[1]["held"], [False] * 6)
    for r in ranks:
        assert str(r["taken"]) == "never"
        for phase in range(3):
            np.testing.assert_array_equal(r[f"sum{phase}"], [3.0])


def test_elastic_rank0_holds_the_pair_it_publishes(monkeypatch):
    from horovod_tpu_torch.common import config, host_world, state
    from horovod_tpu_torch.run.elastic import rendezvous

    published = []
    monkeypatch.setattr(host_world, "_round_ports", {})
    monkeypatch.setattr(rendezvous, "publish_controller_endpoint",
                        lambda *a: published.append(a))
    try:
        host, base = host_world._exchange_endpoint(
            "127.0.0.1", 1, "localhost", 0, 0, 7)
        assert (host, published[0][3]) == ("localhost", base)
        for port in (base, base + config.NATIVE_PORT_OFFSET):
            with socket.socket() as intruder:
                try:
                    intruder.bind(("127.0.0.1", port))
                except OSError:
                    continue
                raise AssertionError(f"port {port} of the published pair "
                                     f"was free to take")
    finally:
        state._hold_ports(())


def test_a_launch_holds_its_pair_until_the_world_ends():
    """``torch_worlds.launch`` takes its ports with ``held_port_pair``:
    both refuse the intruder until the holders close."""
    port, holders = torch_worlds.held_port_pair()
    pair = (port, port + 1)
    for p in pair:
        with socket.socket() as intruder:
            try:
                intruder.bind(("127.0.0.1", p))
            except OSError:
                continue
            raise AssertionError(f"port {p} of a held pair was free to take")
    for sock in holders:
        sock.close()
    for p in pair:
        with socket.socket() as intruder:
            intruder.bind(("127.0.0.1", p))
