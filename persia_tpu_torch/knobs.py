"""The ``PERSIA_*`` environment knobs the port reads
(``persia_tpu/knobs.py``).

Only the knobs of the spill tier, the hotness sketches, the snapshot
retention, the storage layer's fsync and the device cache (its admission
policy, the hotness mapper's window and sketch, the multi-process
negotiation), with the JAX package's names, types, defaults and parse
conventions:

- ``bool`` knobs whose default is False are enabled by ``1`` / ``true`` /
  ``yes`` (case-insensitive);
- ``bool`` knobs whose default is True are disabled only by the literal
  ``0``;
- ``int`` and ``float`` knobs parse with ``int()`` / ``float()``; unset or
  empty -> the default;
- ``str`` knobs are returned as they are set.

:func:`get` reads ``os.environ`` at call time; an unknown name raises.
"""

import os
from dataclasses import dataclass
from typing import Dict

_TRUTHY = ("1", "true", "yes")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "bool" | "int" | "float" | "str"
    default: object


REGISTRY: Dict[str, Knob] = {k.name: k for k in [
    Knob("PERSIA_FSYNC", "bool", True),
    Knob("PERSIA_HOTNESS", "bool", False),
    Knob("PERSIA_HOTNESS_CM_DEPTH", "int", 4),
    Knob("PERSIA_HOTNESS_CM_WIDTH", "int", 8192),
    Knob("PERSIA_HOTNESS_TOPK", "int", 512),
    Knob("PERSIA_MULTIHOST_CACHE", "str", "off"),
    Knob("PERSIA_SNAPSHOT_KEEP", "int", 3),
    Knob("PERSIA_TIER_ADMIT", "str", "lru"),
    Knob("PERSIA_TIER_SKETCH_TOPK", "int", 0),
    Knob("PERSIA_TIER_WINDOW_FRAC", "float", 0.125),
]}


def _parse(knob: Knob, raw: str):
    if knob.type == "bool":
        if knob.default:
            return raw != "0"
        return raw.lower() in _TRUTHY
    if knob.type in ("int", "float"):
        # an empty numeric knob means unset (shells interpolate unset
        # variables as "")
        if raw == "":
            return knob.default
        return int(raw) if knob.type == "int" else float(raw)
    return raw


def get(name: str):
    """Typed value of knob ``name`` from the current environment, or its
    default. Unknown names raise."""
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"unregistered PERSIA knob {name!r}; the port "
                       f"reads only {sorted(REGISTRY)}")
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return _parse(knob, raw)
