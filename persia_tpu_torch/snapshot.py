"""Coordinated whole-job snapshots + resume (``persia_tpu/snapshot.py``).

A snapshot makes a *job* survive a trainer restart: the dense weights,
the dense optimizer state, the data position and the PS stores are
captured at one consistent cut and restored together.

One snapshot is one directory ``<snapshot_dir>/snap_<seq>`` holding:

- ``replica_<i>.psd`` + ``embedding_dump_done`` — every PS replica's
  store, dumped through :func:`checkpoint.dump_sharded` AFTER the
  snapshot barrier (below), with the routing table recorded in the
  marker when non-uniform (the ownership-filter contract);
- ``dense.pt`` — the ``torch.save`` bytes of the model's and the dense
  optimizer's state dicts (the JAX package writes flax msgpack as
  ``dense.msgpack``);
- ``cursor.json`` — the deterministic dataloader cursor
  (:class:`persia_tpu_torch.data.dataloader.ResumableDataset`), so resume
  replays exactly the batches the wiped post-snapshot steps consumed;
- ``manifest.json`` — written LAST, via the fsync'd
  :meth:`storage.PersiaPath.write_bytes_atomic`, carrying a sha256 +
  size for every other file, the trainer step, per-replica PS
  update-version watermarks, the routing epoch, and the inc-packet
  watermark.

**Barrier.** :func:`snapshot_job` first drains the backward pipeline
(``flush_backward_engines``, the staleness-permit machinery), so
at the capture point there are ZERO in-flight gradient updates: the PS
dump, the dense state, and the cursor all describe the same consistent
cut "every update of batches ``0..cursor.consumed`` applied, nothing
else". That cut is what makes the resume path's bounded-loss argument
exact: rolling the whole job back to the snapshot and replaying the
deterministic batch stream from the cursor re-derives the wiped
suffix once — per-sign counting identities hold with zero ambiguity.

**Completeness.** A snapshot is complete iff ``manifest.json`` exists
AND every checksum verifies. The manifest is written last and
atomically, so a trainer killed mid-snapshot leaves a manifest-less
(or checksum-failing) directory that :func:`latest_snapshot` refuses,
falling back to the previous complete snapshot. Retention
(``PERSIA_SNAPSHOT_KEEP``) removes older completes and torn debris.

**Inc-packet watermark.** The manifest's ``inc_watermark`` names the
complete incremental-update packets at capture time in the JAX package;
the port has no incremental-update tier yet (``ROADMAP.md`` queue A item
6), so it is None and ``inc_dir`` is refused.
"""

import hashlib
import json
import logging
import os
import re
import time
from typing import List, Optional, Tuple

from persia_tpu_torch import checkpoint as ckpt
from persia_tpu_torch import knobs
from persia_tpu_torch.storage import PersiaPath

_logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
SNAP_PREFIX = "snap_"
CURSOR_FILE = "cursor.json"
_SNAP_RE = re.compile(r"^snap_(\d{6,})$")


class SnapshotError(RuntimeError):
    """A snapshot directory failed verification (torn / tampered)."""


def _snap_name(seq: int) -> str:
    return f"{SNAP_PREFIX}{seq:06d}"


def _snap_seq(name: str) -> Optional[int]:
    m = _SNAP_RE.match(name)
    return int(m.group(1)) if m else None


def _sha256_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


def list_snapshots(snapshot_dir: str) -> List[str]:
    """Every ``snap_*`` directory under ``snapshot_dir`` (complete or
    not), oldest first."""
    if not os.path.isdir(snapshot_dir):
        return []
    names = [(seq, n) for n in os.listdir(snapshot_dir)
             for seq in (_snap_seq(n),)
             if seq is not None
             and os.path.isdir(os.path.join(snapshot_dir, n))]
    return [os.path.join(snapshot_dir, n) for _, n in sorted(names)]


def load_manifest(snap_dir: str) -> dict:
    """Parse + VERIFY one snapshot's manifest. Raises
    :class:`SnapshotError` when the manifest is absent, unparsable, or
    any listed file is missing / size-mismatched / checksum-failed —
    the torn-snapshot refusal the resume path builds on."""
    mpath = os.path.join(snap_dir, MANIFEST)
    if not os.path.exists(mpath):
        raise SnapshotError(f"{snap_dir}: no {MANIFEST} (torn snapshot)")
    try:
        with open(mpath, "rb") as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise SnapshotError(f"{snap_dir}: unreadable manifest: {e}") from e
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        raise SnapshotError(f"{snap_dir}: manifest lists no files")
    for name, meta in files.items():
        path = os.path.join(snap_dir, name)
        if not os.path.exists(path):
            raise SnapshotError(f"{snap_dir}: manifest names missing "
                                f"file {name!r}")
        digest, size = _sha256_file(path)
        if size != meta.get("bytes"):
            raise SnapshotError(
                f"{snap_dir}/{name}: size {size} != manifest "
                f"{meta.get('bytes')} (torn write)")
        if digest != meta.get("sha256"):
            raise SnapshotError(f"{snap_dir}/{name}: checksum mismatch")
    return manifest


def latest_snapshot(snapshot_dir: str) -> Optional[Tuple[str, dict]]:
    """Newest COMPLETE snapshot ``(path, manifest)`` — newest-first
    scan, refusing torn/partial directories with a warning and falling
    back to the previous complete one. ``None`` when nothing usable
    exists (cold start)."""
    for snap in reversed(list_snapshots(snapshot_dir)):
        try:
            return snap, load_manifest(snap)
        except SnapshotError as e:
            _logger.warning("refusing snapshot %s: %s", snap, e)
    return None


def _complete_inc_packets(inc_dir: Optional[str]) -> Optional[List[str]]:
    """The replay watermark of the incremental-update packets: None when
    the job runs without them. The port has no incremental-update tier,
    so ``inc_dir`` raises."""
    if not inc_dir:
        return None
    raise NotImplementedError(
        "snapshot_job(inc_dir=...): the incremental-update tier "
        "(persia_tpu/inc_update.py ready_packets) is not ported yet; it "
        "waits for ROADMAP.md queue A item 6 (the online tier)")


def _ps_watermarks(worker) -> Optional[list]:
    """Per-replica ``{update_version, routing_epoch}`` from each PS's
    health doc, forensic watermarks for the manifest (the restore keys on
    the PSD files and the routing doc, not on these). An in-process
    holder has no health doc: None for it."""
    clients = getattr(worker, "ps_clients", None)
    if not clients:
        return None
    marks = []
    for c in clients:
        health = getattr(c, "health", None)
        if health is None:
            marks.append(None)
            continue
        try:
            doc = health()
            marks.append({"update_version": doc.get("update_version"),
                          "routing_epoch": doc.get("routing_epoch")})
        except Exception:  # noqa: BLE001 — the watermark is advisory
            marks.append(None)
    return marks


def snapshot_job(
    snapshot_dir: str,
    worker,
    *,
    state=None,
    cursor: Optional[dict] = None,
    inc_dir: Optional[str] = None,
    step: int = 0,
    keep: Optional[int] = None,
) -> str:
    """Take one coordinated job snapshot; returns the snapshot path.

    ``worker`` is the (in-process or remote) embedding worker whose
    ``dump`` fans the PS store out — its dump path already runs the
    ``flush_backward_engines`` barrier, but we run it explicitly FIRST
    so the cursor/dense capture below sits behind the same quiesce
    point. ``state`` is the ``(model, dense optimizer)`` pair (None for
    sparse-only jobs), ``cursor`` the dataloader cursor doc, ``inc_dir``
    the incremental-update packet directory (refused: not ported).
    """
    from persia_tpu_torch.pipeline import flush_backward_engines

    # refuse inc_dir before anything is written
    inc_watermark = _complete_inc_packets(inc_dir)
    os.makedirs(snapshot_dir, exist_ok=True)
    seqs = [_snap_seq(os.path.basename(p))
            for p in list_snapshots(snapshot_dir)]
    seq = 1 + max([s for s in seqs if s is not None], default=-1)
    snap = os.path.join(snapshot_dir, _snap_name(seq))
    os.makedirs(snap, exist_ok=True)

    # --- barrier: zero in-flight gradient updates past this line -----
    flush_backward_engines(worker)

    # --- sparse: every PS replica + routing-stamped done marker -------
    worker.dump(snap)

    # --- dense + cursor ----------------------------------------------
    if state is not None:
        PersiaPath(os.path.join(snap, ckpt.DENSE_FILE)).write_bytes(
            ckpt.dense_state_bytes(state))
    if cursor is not None:
        PersiaPath(os.path.join(snap, CURSOR_FILE)).write_bytes(
            json.dumps(cursor, sort_keys=True).encode())

    # --- manifest (LAST, atomic + fsync'd): completeness stamp --------
    files = {}
    for name in sorted(os.listdir(snap)):
        path = os.path.join(snap, name)
        if name == MANIFEST or not os.path.isfile(path):
            continue
        digest, size = _sha256_file(path)
        files[name] = {"sha256": digest, "bytes": size}
    marker = ckpt.read_done_marker(snap)
    manifest = {
        "version": 1,
        "seq": seq,
        "step": int(step),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "files": files,
        "cursor": cursor,
        "num_shards": marker.get("num_shards"),
        "routing": marker.get("routing"),
        "routing_epoch": getattr(worker, "routing_epoch", None),
        "ps_watermarks": _ps_watermarks(worker),
        "inc_watermark": inc_watermark,
    }
    PersiaPath(os.path.join(snap, MANIFEST)).write_bytes_atomic(
        json.dumps(manifest, sort_keys=True, indent=1).encode())

    gc_snapshots(snapshot_dir, keep=keep)
    return snap


def gc_snapshots(snapshot_dir: str, keep: Optional[int] = None) -> List[str]:
    """Retention: keep the newest ``keep`` (PERSIA_SNAPSHOT_KEEP)
    COMPLETE snapshots; remove older completes and any torn debris
    older than the newest complete (a torn directory NEWER than the
    newest complete may be a snapshot in progress — left alone).
    Returns the removed paths."""
    if keep is None:
        keep = knobs.get("PERSIA_SNAPSHOT_KEEP")
    keep = max(1, int(keep))
    snaps = list_snapshots(snapshot_dir)
    complete = []
    torn = []
    for snap in snaps:
        try:
            load_manifest(snap)
            complete.append(snap)
        except SnapshotError:
            torn.append(snap)
    removed = []
    for snap in complete[:-keep]:
        PersiaPath(snap).remove()
        removed.append(snap)
    if complete:
        newest = _snap_seq(os.path.basename(complete[-1]))
        for snap in torn:
            if _snap_seq(os.path.basename(snap)) < newest:
                PersiaPath(snap).remove()
                removed.append(snap)
    if removed:
        _logger.info("snapshot gc removed %d dir(s): %s", len(removed),
                     ", ".join(os.path.basename(r) for r in removed))
    return removed


# --- resume --------------------------------------------------------------


def dense_bytes(snap_dir: str) -> Optional[bytes]:
    """The snapshot's ``dense.pt`` bytes, None when it has none; a
    snapshot that holds only the JAX package's ``dense.msgpack`` is
    refused."""
    path = ckpt.dense_file(snap_dir)
    if path is None:
        return None
    with open(path, "rb") as f:
        return f.read()


def load_cursor(snap_dir: str) -> Optional[dict]:
    path = os.path.join(snap_dir, CURSOR_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return json.load(f)


def resolve_snapshot(path: str) -> Tuple[str, dict]:
    """``path`` may be one snapshot directory or a snapshot_dir parent:
    returns the verified ``(snap_dir, manifest)``, preferring the
    newest complete snapshot for a parent. Raises
    :class:`SnapshotError` when nothing complete exists."""
    if os.path.exists(os.path.join(path, MANIFEST)) or _snap_seq(
            os.path.basename(os.path.normpath(path))) is not None:
        return path, load_manifest(path)
    found = latest_snapshot(path)
    if found is None:
        raise SnapshotError(f"{path}: no complete snapshot to resume from")
    return found


def restore_job(path: str, worker) -> dict:
    """Roll the SPARSE tier back to a snapshot: verify it, then stream
    every PSD file into the live PS fleet (``worker.load`` →
    :func:`checkpoint.load_sharded`, which reshards by the dump-time
    ownership filter when the live routing/replica layout differs).
    Post-snapshot PS updates are wiped by design — the caller resumes
    the deterministic batch stream from the returned manifest's cursor
    and re-derives them exactly once. Returns the verified manifest;
    dense bytes stay on disk for :func:`dense_bytes`."""
    snap, manifest = resolve_snapshot(path)
    worker.load(snap)
    return manifest
