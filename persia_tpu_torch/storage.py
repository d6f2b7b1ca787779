"""Storage abstraction: local disk + HDFS (``persia_tpu/storage.py``;
reference: persia-storage).

The reference's ``PersiaPath`` dispatches between std::fs and shelling
out to ``hdfs dfs`` / ``hadoop fs`` (persia-storage/src/lib.rs:177-391).
Checkpoint and incremental-update paths accept ``hdfs://`` URIs through
this module; everything else is plain local IO.
"""

import os
import shutil
import subprocess
from typing import List

from persia_tpu_torch import knobs


def _hdfs_bin() -> List[str]:
    for candidate in (["hdfs", "dfs"], ["hadoop", "fs"]):
        if shutil.which(candidate[0]):
            return candidate
    raise RuntimeError("no hdfs/hadoop binary on PATH for hdfs:// paths")


class PersiaPath:
    """One file path on disk or HDFS."""

    def __init__(self, path: str):
        self.path = path
        self.is_hdfs = path.startswith("hdfs://")

    def _run(self, *args) -> subprocess.CompletedProcess:
        return subprocess.run(
            [*_hdfs_bin(), *args], check=True, capture_output=True
        )

    def read_bytes(self) -> bytes:
        if self.is_hdfs:
            return self._run("-cat", self.path).stdout
        with open(self.path, "rb") as f:
            return f.read()

    def read_range(self, offset: int, length: int) -> bytes:
        """``length`` bytes starting at ``offset`` — the spill tier's
        single-row fault-in. Local paths seek; HDFS has no cheap random
        read through the CLI, so it degrades to a full read + slice
        (spill packets are bounded, see ps/spill.py). Short reads raise
        (a truncated packet must fail loudly, not hand back garbage)."""
        if self.is_hdfs:
            data = self.read_bytes()[offset:offset + length]
        else:
            with open(self.path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        if len(data) != length:
            raise IOError(
                f"{self.path}: short read ({len(data)} of {length} bytes "
                f"at offset {offset})")
        return data

    def write_bytes(self, data: bytes):
        if self.is_hdfs:
            proc = subprocess.Popen(
                [*_hdfs_bin(), "-put", "-f", "-", self.path],
                stdin=subprocess.PIPE,
            )
            proc.communicate(data)
            if proc.returncode != 0:
                raise IOError(f"hdfs put failed for {self.path}")
            return
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "wb") as f:
            f.write(data)

    def write_bytes_atomic(self, data: bytes):
        """All-or-nothing AND durable write: the destination either
        keeps its old content (or stays absent) or holds ``data`` in
        full — never a torn prefix. Local paths write ``<name>.tmp``
        then rename (POSIX atomic within a filesystem), fsyncing the
        tmp file BEFORE the rename and the parent directory AFTER it
        (PERSIA_FSYNC, default on) — without both, a host crash after
        ``os.replace`` returns can still lose the record the caller
        was told is durable (journal entries, snapshot manifests).
        HDFS ``-put -f -`` already replaces whole files, so plain
        write_bytes is the same guarantee."""
        if self.is_hdfs:
            self.write_bytes(data)
            return
        fsync = knobs.get("PERSIA_FSYNC")
        tmp = PersiaPath(self.path + ".tmp")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(tmp.path, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp.path, self.path)
        if fsync and parent:
            # The rename itself lives in the directory entry; sync it
            # too or the file can revert to the old name post-crash.
            dfd = os.open(parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def exists(self) -> bool:
        if self.is_hdfs:
            try:
                self._run("-test", "-e", self.path)
                return True
            except subprocess.CalledProcessError:
                return False
        return os.path.exists(self.path)

    def makedirs(self):
        if self.is_hdfs:
            self._run("-mkdir", "-p", self.path)
        else:
            os.makedirs(self.path, exist_ok=True)

    def listdir(self) -> List[str]:
        if self.is_hdfs:
            out = self._run("-ls", self.path).stdout.decode()
            return [
                line.rsplit(" ", 1)[-1]
                for line in out.splitlines()
                if line.startswith(("-", "d"))
            ]
        return [os.path.join(self.path, n) for n in os.listdir(self.path)]

    def remove(self):
        if self.is_hdfs:
            self._run("-rm", "-r", "-f", self.path)
        elif os.path.isdir(self.path):
            shutil.rmtree(self.path)
        elif os.path.exists(self.path):
            os.remove(self.path)
