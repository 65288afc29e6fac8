"""Authenticated request/response services over TCP (the port's copy of
``horovod_tpu/run/common/util/network.py``).

A frame is the payload's length, its HMAC under the job's key and the
payload: a pickle of one request or response object. The launcher that
drives the workers is the JAX package's, so the objects travel under
its class paths (``horovod_tpu.run.common.util.network.PingRequest``,
``horovod_tpu.run.elastic.worker.HostsUpdatedRequest``, ...) in both
directions. This side writes those pickles without importing the JAX
package (``dumps``), and reads them with an unpickler that maps exactly
the registered wire classes onto the port's own and refuses every other
class (``loads``): a plain ``pickle.loads`` would import ``horovod_tpu``,
and with it jax, and would run whatever a frame names.
"""

from __future__ import annotations

import io
import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import secret

_LEN = struct.Struct("!I")

# The JAX package's modules whose class paths the frames carry.
NETWORK_WIRE_MODULE = "horovod_tpu.run.common.util.network"

_BY_PATH: Dict[Tuple[str, str], type] = {}
_BY_CLASS: Dict[type, Tuple[str, str]] = {}


def wire_class(module: str):
    """Register the decorated class as the port's counterpart of
    ``module.<its name>`` on the wire."""

    def register(cls):
        path = (module, cls.__name__)
        _BY_PATH[path] = cls
        _BY_CLASS[cls] = path
        return cls

    return register


@wire_class(NETWORK_WIRE_MODULE)
class PingRequest:
    pass


@wire_class(NETWORK_WIRE_MODULE)
class PingResponse:
    def __init__(self, service_name: str, source_address: str):
        self.service_name = service_name
        self.source_address = source_address


@wire_class(NETWORK_WIRE_MODULE)
class AckResponse:
    pass


def dumps(obj: Any) -> bytes:
    """A protocol-3 pickle of a registered wire object under its wire
    class path: the class by GLOBAL, an empty NEWOBJ, and its ``__dict__``
    by BUILD (what ``pickle.dumps`` writes for such an object, with the
    class path named rather than looked up). Protocol 3 writes ``bytes``
    as BINBYTES (protocol 2 calls ``_codecs.encode``, a global that
    ``loads`` refuses) and, unlike protocol 4, writes no frames, so the
    state's opcodes splice in whole."""
    path = _BY_CLASS.get(type(obj))
    if path is None:
        raise TypeError(f"{type(obj).__name__} is not a wire class")
    state = pickle.dumps(dict(vars(obj)), protocol=3)
    module, name = path
    # state[2:-1] drops the dict pickle's PROTO header and its STOP.
    return (b"\x80\x03c" + f"{module}\n{name}\n".encode() + b")\x81"
            + state[2:-1] + b"b.")


class _WireUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _BY_PATH.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"frame names {module}.{name}, which is not a wire class")
        return cls


def loads(payload: bytes) -> Any:
    """The wire object of a frame's payload (see ``dumps``); refuses any
    class that is not registered."""
    return _WireUnpickler(io.BytesIO(payload)).load()


def _send_frame(sock: socket.socket, obj: Any, key: bytes) -> None:
    payload = dumps(obj)
    digest = secret.compute_digest(key, payload)
    sock.sendall(_LEN.pack(len(payload)) + digest + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket, key: bytes) -> Any:
    n = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    digest = _recv_exact(sock, secret.DIGEST_LENGTH_BYTES)
    payload = _recv_exact(sock, n)
    if not secret.check_digest(key, payload, digest):
        raise PermissionError("HMAC digest mismatch: unauthenticated peer")
    return loads(payload)


def get_local_addresses() -> List[Tuple[str, str]]:
    """(interface name, IPv4) of every interface that has an address."""
    import array
    import fcntl

    out: List[Tuple[str, str]] = []
    try:
        names = socket.if_nameindex()
    except OSError:
        return out
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _, name in names:
            ifreq = array.array(
                "B", name.encode()[:15] + b"\0" * (32 - min(len(name), 15)))
            try:
                fcntl.ioctl(s.fileno(), 0x8915, ifreq)  # SIOCGIFADDR
            except OSError:
                continue
            out.append((name, socket.inet_ntoa(bytes(ifreq[20:24]))))
    finally:
        s.close()
    return out


class BasicService:
    """A threaded TCP service answering authenticated requests."""

    def __init__(self, service_name: str, key: bytes, nics=None):
        self._service_name = service_name
        self._key = key
        self._nics = nics
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = _recv_frame(self.request, outer._key)
                except (PermissionError, ConnectionError, EOFError,
                        pickle.UnpicklingError):
                    return
                peer = self.request.getpeername()[0]
                resp = outer._handle(req, peer)
                try:
                    _send_frame(self.request, resp, outer._key)
                except OSError:
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server(("0.0.0.0", 0), _Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"svc-{service_name}")
        self._thread.start()

    def _handle(self, req: Any, client_address: str) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse(self._service_name, client_address)
        raise NotImplementedError(
            f"{self._service_name}: unknown request {type(req)}")

    @property
    def port(self) -> int:
        return self._port

    def addresses(self) -> List[Tuple[str, int]]:
        """Every (ip, port) this service answers on, one an interface
        (only the ``nics`` given, when given)."""
        addrs = [("127.0.0.1", self._port)]
        for name, ip in get_local_addresses():
            if self._nics and name not in self._nics:
                continue
            if all(ip != a for a, _ in addrs):
                addrs.append((ip, self._port))
        if len(addrs) == 1 and not self._nics:
            try:
                hostname_ip = socket.gethostbyname(socket.gethostname())
                if hostname_ip != "127.0.0.1":
                    addrs.append((hostname_ip, self._port))
            except OSError:
                pass
        return addrs

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class BasicClient:
    """A one-request-at-a-time client of a ``BasicService``."""

    def __init__(self, service_name: str,
                 addresses: List[Tuple[str, int]], key: bytes,
                 probe_timeout: float = 5.0, attempts: int = 3):
        self._service_name = service_name
        self._key = key
        self._timeout = probe_timeout
        self._attempts = attempts
        self._address: Optional[Tuple[str, int]] = None
        last_err: Optional[Exception] = None
        for addr in addresses:
            try:
                resp = self._request_to(addr, PingRequest())
                if isinstance(resp, PingResponse) and \
                        resp.service_name == service_name:
                    self._address = addr
                    break
            except (OSError, PermissionError, ConnectionError) as e:
                last_err = e
        if self._address is None:
            raise ConnectionError(
                f"could not reach service '{service_name}' at any of "
                f"{addresses}: {last_err}")

    def _request_to(self, addr: Tuple[str, int], req: Any) -> Any:
        with socket.create_connection(addr, timeout=self._timeout) as sock:
            _send_frame(sock, req, self._key)
            return _recv_frame(sock, self._key)

    def _request(self, req: Any) -> Any:
        last_err: Optional[Exception] = None
        for _ in range(self._attempts):
            try:
                return self._request_to(self._address, req)
            except (OSError, ConnectionError) as e:
                last_err = e
        raise ConnectionError(
            f"service '{self._service_name}' at {self._address} "
            f"unreachable: {last_err}")

    def ping(self) -> bool:
        return isinstance(self._request(PingRequest()), PingResponse)
