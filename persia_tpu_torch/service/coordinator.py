"""Coordinator: service discovery and rendezvous
(``persia_tpu/service/coordinator.py``).

A small in-memory registry behind the RPC server. Services register
``(role, replica_index, addr)`` and, optionally, their observability
sidecar's address; clients poll until the expected replica count is
present. A key-value namespace covers rendezvous. The requests and
replies are the JAX coordinator's bytes, so either package's client
reaches either package's coordinator.

Run: ``python -m persia_tpu_torch.service.coordinator --port 0
--addr-file <path>``
"""

import argparse
import logging
import threading
import time
from typing import Dict, Optional

from persia_tpu_torch import _msgpack
from persia_tpu_torch.rpc import RpcClient, RpcServer
from persia_tpu_torch.utils import write_addr_file

_logger = logging.getLogger(__name__)

ROLE_PS = "embedding-parameter-server"
ROLE_WORKER = "embedding-worker"
ROLE_TRAINER = "nn-worker"
ROLE_DATALOADER = "data-loader"
ROLE_INFERENCE = "inference-server"


class Coordinator:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        # role -> {replica_index: addr}
        self._services: Dict[str, Dict[int, str]] = {}
        # role -> {replica_index: sidecar addr}
        self._http: Dict[str, Dict[int, str]] = {}
        self._kv: Dict[str, bytes] = {}
        self.server = RpcServer(host, port)
        for name, fn in (("register", self._register),
                         ("deregister", self._deregister),
                         ("list", self._list), ("topology", self._topology),
                         ("kv_put", self._kv_put), ("kv_get", self._kv_get)):
            self.server.register(name, fn)
        self.server.register("ping", lambda p: b"pong")

    @property
    def addr(self) -> str:
        return self.server.addr

    def _register(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        role, i = req["role"], req["replica_index"]
        with self._lock:
            self._services.setdefault(role, {})[i] = req["addr"]
            if req.get("http_addr"):
                self._http.setdefault(role, {})[i] = req["http_addr"]
            else:
                # a re-registration without a sidecar must not leave the
                # dead previous sidecar's address in the topology
                self._http.get(role, {}).pop(i, None)
        _logger.info("registered %s[%d] at %s (sidecar %s)", role, i,
                     req["addr"], req.get("http_addr") or "none")
        return b""

    def _deregister(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        with self._lock:
            self._services.get(req["role"], {}).pop(req["replica_index"],
                                                     None)
            self._http.get(req["role"], {}).pop(req["replica_index"], None)
        return b""

    def _list(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        with self._lock:
            members = self._services.get(req["role"], {})
            addrs = [members[i] for i in sorted(members)]
        return _msgpack.packb({"addrs": addrs})

    def _topology(self, payload: bytes) -> bytes:
        """Every registered service with its replica index, RPC address
        and sidecar address (None when it published none)."""
        with self._lock:
            members = [
                {"role": role, "replica": i, "addr": addr,
                 "http_addr": self._http.get(role, {}).get(i)}
                for role, reps in sorted(self._services.items())
                for i, addr in sorted(reps.items())
            ]
        return _msgpack.packb({"members": members})

    def _kv_put(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        with self._lock:
            self._kv[req["key"]] = req["value"]
        return b""

    def _kv_get(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        with self._lock:
            value = self._kv.get(req["key"])
        return _msgpack.packb({"value": value})


def _poll(read, done, timeout: float, what: str):
    """``read()`` with exponential backoff until ``done(value)``."""
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        value = read()
        if done(value):
            return value
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {timeout}s for {what}, have {value!r}")
        time.sleep(delay)
        delay = min(delay * 2, 1.0)


class CoordinatorClient:
    def __init__(self, addr: str):
        self.client = RpcClient(addr)

    def register(self, role: str, replica_index: int, addr: str,
                 http_addr: Optional[str] = None):
        self.client.call_msg("register", role=role,
                             replica_index=replica_index, addr=addr,
                             http_addr=http_addr)

    def topology(self):
        return self.client.call_msg("topology")["members"]

    def deregister(self, role: str, replica_index: int):
        self.client.call_msg("deregister", role=role,
                             replica_index=replica_index)

    def list(self, role: str):
        return self.client.call_msg("list", role=role)["addrs"]

    def wait_members(self, role: str, count: int, timeout: float = 60.0):
        """Poll until ``count`` replicas of ``role`` registered."""
        return _poll(lambda: self.list(role), lambda a: len(a) >= count,
                     timeout, f"{count} x {role}")

    def kv_put(self, key: str, value: bytes):
        self.client.call_msg("kv_put", key=key, value=value)

    def kv_get(self, key: str):
        return self.client.call_msg("kv_get", key=key)["value"]

    def wait_kv(self, key: str, timeout: float = 60.0) -> bytes:
        return _poll(lambda: self.kv_get(key), lambda v: v is not None,
                     timeout, f"kv key {key!r}")

    def ping(self) -> bool:
        try:
            return self.client.call("ping") == b"pong"
        except (ConnectionError, OSError):
            return False


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=23333)
    p.add_argument("--addr-file", default=None,
                   help="write the bound address here after listen; with "
                        "--port 0 this is how a parent learns the port")
    args = p.parse_args()
    coord = Coordinator(args.host, args.port)
    _logger.info("coordinator listening on %s", coord.addr)
    if args.addr_file:
        write_addr_file(coord.addr, args.addr_file)
    coord.server.serve_forever()


if __name__ == "__main__":
    main()
