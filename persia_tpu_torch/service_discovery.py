"""Service discovery (``persia_tpu/service_discovery.py``).

Resolves the embedding workers' addresses from ``EMBEDDING_WORKER_SERVICE``
(``host:port[,host:port...]``, the reference's contract) or a live
coordinator, and the fleet's observability sidecars from the coordinator
or a static ``PERSIA_FLEET_TARGETS`` list.
"""

import os
from typing import Dict, List, Optional

from persia_tpu_torch import knobs

# short per-role prefixes for fleet service names (ps0, worker1, ...): the
# names the service binaries give their tracing tracks, so the topology,
# the merged traces and the logs name a replica the same way
_ROLE_PREFIX = {
    "embedding-parameter-server": "ps",
    "embedding-worker": "worker",
    "nn-worker": "trainer",
    "data-loader": "loader",
    "inference-server": "serving",
    "fleet-monitor": "fleet",
}


def get_embedding_worker_services(
    coordinator_addr: Optional[str] = None,
) -> List[str]:
    env = os.environ.get("EMBEDDING_WORKER_SERVICE")
    if env:
        return [a.strip() for a in env.split(",") if a.strip()]
    if coordinator_addr is None:
        coordinator_addr = knobs.get_raw("PERSIA_COORDINATOR_ADDR")
    if coordinator_addr:
        from persia_tpu_torch.service.coordinator import (
            ROLE_WORKER,
            CoordinatorClient,
        )

        return CoordinatorClient(coordinator_addr).list(ROLE_WORKER)
    raise RuntimeError(
        "set EMBEDDING_WORKER_SERVICE or PERSIA_COORDINATOR_ADDR to locate "
        "embedding workers")


def service_name_for(role: str, replica: int) -> str:
    return f"{_ROLE_PREFIX.get(role, role)}{replica}"


def get_fleet_targets(
    coordinator_addr: Optional[str] = None,
    static: Optional[str] = None,
) -> List[Dict]:
    """The fleet's scrape targets: every service that published an
    observability sidecar.

    Sources, in order:

    - ``static`` / ``PERSIA_FLEET_TARGETS``: ``name=host:port`` pairs
      joined by commas (fixed fleets, serving tiers outside the
      coordinator's world);
    - the coordinator's ``topology`` RPC (``coordinator_addr`` /
      ``PERSIA_COORDINATOR_ADDR``): services registered with an
      ``http_addr``.

    Both may contribute; a sidecar address counts once. Returns
    ``[{service, role, replica, rpc_addr, http_addr}, ...]``.
    """
    targets: List[Dict] = []
    seen = set()
    static = static if static is not None else knobs.get(
        "PERSIA_FLEET_TARGETS")
    for part in (static or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, addr = part.partition("=")
        if not addr:
            name, addr = addr or f"svc{len(targets)}", name
        if addr in seen:
            continue
        seen.add(addr)
        targets.append({"service": name or f"svc{len(targets)}",
                        "role": "static", "replica": len(targets),
                        "rpc_addr": None, "http_addr": addr})
    if coordinator_addr is None:
        coordinator_addr = knobs.get_raw("PERSIA_COORDINATOR_ADDR")
    if coordinator_addr:
        from persia_tpu_torch.service.coordinator import CoordinatorClient

        for m in CoordinatorClient(coordinator_addr).topology():
            if not m.get("http_addr") or m["http_addr"] in seen:
                continue
            seen.add(m["http_addr"])
            targets.append({
                "service": service_name_for(m["role"], m["replica"]),
                "role": m["role"],
                "replica": m["replica"],
                "rpc_addr": m["addr"],
                "http_addr": m["http_addr"],
            })
    return targets
