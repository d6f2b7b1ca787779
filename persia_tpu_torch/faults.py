"""Deterministic fault injection: every recovery path must be testable
(``persia_tpu/faults.py``).

The fault surface of a hybrid multi-tier trainer grows with every
independently-scheduled tier (PAPERS.md, MPMD pipeline parallelism):
connections reset, PS replicas die mid-request, frames corrupt, one
shard runs slow. None of those paths can be trusted until they can be
*produced on demand*, so this module gives the RPC and PS tiers named
**injection sites** that a test, the chaos bench, or an operator can arm
with rules:

- ``delay:<sec>`` — sleep before proceeding (slow one shard)
- ``reset``      — raise ``ConnectionResetError`` (connection dies)
- ``drop``       — the site swallows the frame (peer hangs until timeout)
- ``corrupt``    — the site mangles the frame payload
- ``die[:rc]``   — ``os._exit`` the process (kill a PS mid-request)
- ``error[:msg]``— raise a generic application error

Rules are **seedable** (probabilistic rules draw from one
``random.Random``) and **deterministic by count** (``after=N`` skips the
first N matches, ``times=M`` fires at most M times), so a test that arms
"reset the 3rd lookup" reproduces exactly.

Control planes, in the ``__tags__``/``__trace__`` opt-in spirit:

- **env**: ``PERSIA_FAULTS="site:action[:arg][@k=v,...];..."`` armed at
  import (subprocess PS replicas inherit it), seeded by
  ``PERSIA_FAULTS_SEED``.
- **RPC**: a server started with ``PERSIA_FAULTS_RPC=1`` registers a
  ``__faults__`` method (rpc.py), so the chaos bench can re-arm a live
  PS subprocess mid-run (:func:`control`).
- **programmatic**: :func:`add` / :func:`reset_faults` for same-process
  tests.

Zero-overhead disabled path: call sites guard on the module global
``_active`` (one dict-load + attribute test, the same discipline as
``tracing._enabled``), so a production process that never arms a rule
pays a single predictable branch per site — the wire and the timing are
identical to a build without the harness.

Sites, by tier:

- ``rpc.client.send`` / ``rpc.server.recv`` — the transport plane
  (kwargs: addr/method);
- ``ps.lookup`` / ``ps.update`` — the PS data plane (kwargs: n, dim);
- ``ps.reshard.{begin,extract,install,drain,freeze,finish}`` — the live
  migration protocol's server side (``drain`` carries ``frozen=``, so a
  rule can tell the replay rounds from the cutover's drain);
- ``reshard.controller`` — fired by the ReshardController at each
  protocol transition (kwargs: ``state=`` copy / replay / freeze /
  cutover / drain, and ``donor=`` where there is one); a ``die`` rule
  here kills the controller at that state;
- ``obs.http`` — the observability sidecar (kwarg: path).

Example::

    faults.add("rpc.server.recv", "reset", after=2, method="predict")
    faults.add("rpc.client.send", "delay", arg=0.05, prob=0.5)
    faults.add("reshard.controller", "die", state="freeze")
"""

import json
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

from persia_tpu_torch import _msgpack, knobs

_logger = logging.getLogger(__name__)

# fast-path gate: call sites test this module global before building the
# fire() kwargs, so the disabled path costs one branch
_active = False


class InjectedFault(RuntimeError):
    """Raised by the ``error`` action (application-level injected
    failure; transport-level injections raise ConnectionResetError)."""


class FaultRule:
    """One armed injection: fires at ``site`` when the count/probability
    and the optional kwarg filters all match."""

    __slots__ = ("site", "action", "arg", "prob", "after", "times",
                 "match", "seen", "fired")

    def __init__(self, site: str, action: str, arg: Optional[float] = None,
                 prob: float = 1.0, after: int = 0,
                 times: Optional[int] = None,
                 match: Optional[Dict[str, str]] = None):
        if action not in ("delay", "reset", "drop", "corrupt", "die",
                          "error"):
            raise ValueError(f"unknown fault action {action!r}")
        self.site = site
        self.action = action
        self.arg = arg
        self.prob = float(prob)
        self.after = int(after)
        self.times = times if times is None else int(times)
        self.match = dict(match or {})
        self.seen = 0    # matching calls observed (incl. skipped)
        self.fired = 0   # times the action actually ran

    def describe(self) -> dict:
        return {"site": self.site, "action": self.action, "arg": self.arg,
                "prob": self.prob, "after": self.after, "times": self.times,
                "match": dict(self.match), "seen": self.seen,
                "fired": self.fired}


class FaultInjector:
    """Rule set + deterministic RNG. One process-wide instance
    (:func:`default_injector`); tests may build private ones."""

    def __init__(self, seed: Optional[int] = None):
        self._rules: List[FaultRule] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def seed(self, seed: Optional[int]):
        with self._lock:
            self._rng = random.Random(seed)

    def add(self, site: str, action: str, arg: Optional[float] = None,
            prob: float = 1.0, after: int = 0, times: Optional[int] = None,
            **match) -> FaultRule:
        rule = FaultRule(site, action, arg, prob, after, times,
                         {k: str(v) for k, v in match.items()})
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self):
        with self._lock:
            self._rules = []

    def rules(self) -> List[dict]:
        with self._lock:
            return [r.describe() for r in self._rules]

    def load_spec(self, spec: str):
        """Parse the compact rule grammar (the env/RPC control form):
        ``site:action[:arg][@key=value,...]`` rules joined by ``;``.
        Modifier keys ``p``/``after``/``times`` control firing; any
        other key is a kwarg filter (e.g. ``method=lookup``)."""
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            head, _, mods = part.partition("@")
            fields = head.split(":")
            if len(fields) < 2:
                raise ValueError(f"bad fault rule {part!r}")
            site, action = fields[0].strip(), fields[1].strip()
            arg = float(fields[2]) if len(fields) > 2 and fields[2] else None
            prob, after, times = 1.0, 0, None
            match: Dict[str, str] = {}
            if mods:
                for kv in mods.split(","):
                    k, _, v = kv.partition("=")
                    k = k.strip()
                    if k == "p":
                        prob = float(v)
                    elif k == "after":
                        after = int(v)
                    elif k == "times":
                        times = int(v)
                    else:
                        match[k] = v.strip()
            self.add(site, action, arg, prob, after, times, **match)

    def fire(self, site: str, **kw) -> Optional[str]:
        """Evaluate ``site`` against the armed rules. Executes ``delay``
        (sleeps), ``reset``/``error`` (raises) and ``die`` (exits)
        inline; returns ``"drop"``/``"corrupt"`` for the actions the
        call site must apply itself, or None when nothing fires."""
        rule = None
        with self._lock:
            for r in self._rules:
                if r.site != site:
                    continue
                if r.match and any(str(kw.get(k)) != v
                                   for k, v in r.match.items()):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                rule = r
                break
        if rule is None:
            return None
        _logger.warning("fault injected at %s: %s(%s) %s",
                        site, rule.action, rule.arg, kw)
        if rule.action == "delay":
            time.sleep(rule.arg or 0.0)
            return None
        if rule.action == "reset":
            raise ConnectionResetError(f"injected reset at {site}")
        if rule.action == "error":
            raise InjectedFault(f"injected error at {site}")
        if rule.action == "die":
            os._exit(int(rule.arg) if rule.arg is not None else 137)
        return rule.action  # "drop" | "corrupt"


_injector = FaultInjector()


def default_injector() -> FaultInjector:
    return _injector


def active() -> bool:
    return _active


def add(site: str, action: str, arg: Optional[float] = None,
        prob: float = 1.0, after: int = 0, times: Optional[int] = None,
        **match) -> FaultRule:
    """Arm a rule on the process injector and activate the harness."""
    global _active
    rule = _injector.add(site, action, arg, prob, after, times, **match)
    _active = True
    return rule


def install(spec: str, seed: Optional[int] = None):
    """Arm rules from the compact grammar (env / RPC control form)."""
    global _active
    if seed is not None:
        _injector.seed(seed)
    _injector.load_spec(spec)
    _active = bool(_injector.rules())


def reset_faults():
    """Disarm every rule and restore the zero-overhead disabled path."""
    global _active
    _injector.clear()
    _active = False


def fire(site: str, **kw) -> Optional[str]:
    """Hot-path entry: no-op unless the harness is armed. Call sites
    should pre-check ``faults._active`` to skip kwargs construction."""
    if not _active:
        return None
    return _injector.fire(site, **kw)


def corrupt_bytes(payload) -> bytes:
    """The ``corrupt`` action's canonical payload mangler: flip every
    bit of the first byte (a parse-visible, deterministic mutation)."""
    b = bytes(payload)
    if not b:
        return b
    return bytes([b[0] ^ 0xFF]) + b[1:]


def control(addr: str, spec: Optional[str] = None,
            seed: Optional[int] = None, clear: bool = False):
    """Re-arm the injector of a REMOTE process through its RPC server
    (the server must run with ``PERSIA_FAULTS_RPC=1``; rpc.py registers
    the ``__faults__`` method). The chaos bench uses this to slow one
    shard of a live PS subprocess without restarting it."""
    from persia_tpu_torch.rpc import RpcClient

    client = RpcClient(addr)
    try:
        client.call("__faults__", _msgpack.packb(
            {"spec": spec, "seed": seed, "clear": clear}))
    finally:
        client.close()


def _handle_control(payload: bytes) -> bytes:
    """Server side of :func:`control` (registered by rpc.RpcServer when
    PERSIA_FAULTS_RPC=1)."""
    req = _msgpack.unpackb(payload) if payload else {}
    if req.get("clear"):
        reset_faults()
    if req.get("spec"):
        install(req["spec"], seed=req.get("seed"))
    return json.dumps(_injector.rules()).encode()


# env arming at import: subprocess service replicas inherit the spec
# import_time_safe knobs: arming must happen at import so
# subprocess service replicas inherit the spec from their parent
_env_spec = knobs.get("PERSIA_FAULTS")
if _env_spec:
    try:
        install(_env_spec, seed=knobs.get("PERSIA_FAULTS_SEED"))
        _logger.warning("fault injection armed from PERSIA_FAULTS: %s",
                        _env_spec)
    except ValueError as e:
        _logger.error("bad PERSIA_FAULTS spec %r: %s", _env_spec, e)
