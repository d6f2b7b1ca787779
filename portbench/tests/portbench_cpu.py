"""Cells cut to a size the CPU tests can run: every table capped in rows,
small batches and pools, a few warm and traced steps. Widths stay."""

import dataclasses

from portbench import registry

CELLS = [w["name"] for w in registry.manifest()["workloads"]]


def tiny(cell, rows=5000, batch=64, pool=4):
    cfg = dict(cell.config)
    cfg["arch_embedding_size"] = "-".join(
        str(min(int(r), rows)) for r in cfg["arch_embedding_size"].split("-"))
    traffic = dict(cell.traffic, batch=batch, pool=pool, warm_steps=2,
                   trace_steps=3, sync_steps=2)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def tiny_cell(name, **kw):
    return tiny(registry.load_cell(name), **kw)
