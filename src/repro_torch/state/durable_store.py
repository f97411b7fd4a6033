"""Durable snapshot chain: committed snapshots spilled to disk, verified
on the way back in.

The in-memory :class:`~repro_torch.state.snapshot_store.SnapshotStore` keeps
exactly one committed snapshot per job and keeps it *in this process* —
coordinator death loses every committed epoch, and a snapshot that rots
(disk corruption, torn write) is restored bit-for-bit without anybody
noticing.  :class:`DurableSnapshotStore` upgrades ``commit`` into a
durability point and recovery into a *verified* walk down a retention
chain:

* **Spill on commit.**  When a snapshot commits, its entries are read
  out of the IMap (preserving their explicit partition ids — routing
  never re-derives ``hash(key)`` across process generations) and written
  to ``<root>/<job_id>/snap-<id>/`` as pickled **segments** of bounded
  entry count, each guarded by a CRC32 over its exact byte payload.

* **Torn-write safety.**  Every file lands via the classic protocol:
  write to a ``*.tmp`` sibling, ``fsync`` the file, ``os.replace`` into
  place, ``fsync`` the directory.  The ``MANIFEST.json`` — carrying the
  job id, snapshot id, per-segment name/size/CRC and the job's replay
  meta — is written **last**, so a snapshot exists on disk iff its
  manifest does: a spill killed at any byte leaves the previous chain
  entry untouched and the torn directory unreferenced (reported as
  "manifest missing" if recovery ever looks at it).

* **Retention chain.**  Instead of destroying the predecessor at commit,
  the last ``retain`` committed snapshots stay on disk, newest first
  (:meth:`recovery_chain`).  In-memory IMap storage still keeps only the
  newest (the base-class behaviour) — disk is the durable tier.

* **Verified restore.**  :meth:`verify` checks manifest identity and
  every segment's size + CRC32 without unpickling anything;
  :meth:`prepare_restore` re-verifies while loading and rebuilds the
  snapshot's IMap from disk.  The engine restores **from disk, never
  from live memory** (``Job._select_restore_snapshot``), so a corrupted
  newest snapshot is *detected* and recovery falls back down the chain
  to the newest entry that still verifies — the skipped ids and reasons
  land in the job's recovery log.

* **Cold start.**  :meth:`discover_jobs` + the chain are all
  ``JetCluster.recover_job`` needs to adopt a job after full process
  death: nothing about recovery depends on the coordinator that wrote
  the snapshots still being alive.

Checksum granularity is the segment (default ≤512 entries): one flipped
bit invalidates one segment, which invalidates the snapshot — state is
all-or-nothing per epoch, matching the Chandy-Lamport consistency unit.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time as _time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .imap import IMapService
from .snapshot_store import SnapshotStore

#: bumped when the on-disk layout changes; a mismatch fails verification
FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
_SNAP_PREFIX = "snap-"


class DurableSnapshotStore(SnapshotStore):
    """Disk-backed snapshot chain (see module docstring for the contract)."""

    def __init__(self, service: IMapService, root,
                 retain: int = 3, segment_entries: int = 512):
        super().__init__(service)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        #: committed snapshots kept on disk per job (the fallback chain)
        self.retain = max(1, retain)
        #: max entries per segment file (the checksum granularity)
        self.segment_entries = max(1, segment_entries)
        # adopt whatever chains already exist under root (cold start):
        # newest on-disk id becomes the in-memory "latest committed" even
        # before verification — verification happens at restore time,
        # where a bad head falls back down the chain with a recorded
        # reason instead of being silently ignored here
        for job_id in self.discover_jobs():
            chain = self.recovery_chain(job_id)
            if chain:
                self.committed[job_id] = chain[0]

    # -- paths ---------------------------------------------------------------
    def job_dir(self, job_id: str) -> Path:
        return self.root / job_id

    def snapshot_dir(self, job_id: str, snapshot_id: int) -> Path:
        return self.job_dir(job_id) / f"{_SNAP_PREFIX}{snapshot_id:08d}"

    def manifest_path(self, job_id: str, snapshot_id: int) -> Path:
        return self.snapshot_dir(job_id, snapshot_id) / MANIFEST_NAME

    def segment_paths(self, job_id: str, snapshot_id: int) -> List[Path]:
        d = self.snapshot_dir(job_id, snapshot_id)
        if not d.is_dir():
            return []
        return sorted(p for p in d.iterdir()
                      if p.name.startswith("seg-") and p.suffix == ".bin")

    # -- discovery -----------------------------------------------------------
    def discover_jobs(self) -> List[str]:
        """Job ids that left at least one snapshot directory under root."""
        if not self.root.is_dir():
            return []
        return sorted(d.name for d in self.root.iterdir()
                      if d.is_dir() and any(
                          c.name.startswith(_SNAP_PREFIX)
                          for c in d.iterdir() if c.is_dir()))

    def recovery_chain(self, job_id: str) -> List[int]:
        """Snapshot ids on disk for ``job_id``, newest first.  Includes
        torn/corrupt directories — the chain is *candidates*; per-entry
        health is :meth:`verify`'s job, so a bad entry is skipped with a
        recorded reason rather than silently invisible."""
        jd = self.job_dir(job_id)
        if not jd.is_dir():
            return []
        sids = []
        for d in jd.iterdir():
            if d.is_dir() and d.name.startswith(_SNAP_PREFIX):
                try:
                    sids.append(int(d.name[len(_SNAP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(sids, reverse=True)

    def manifest(self, job_id: str, snapshot_id: int) -> Optional[Dict]:
        """Parsed manifest, or None when missing/unreadable."""
        try:
            return json.loads(
                self.manifest_path(job_id, snapshot_id).read_text())
        except (OSError, ValueError):
            return None

    # -- lifecycle -----------------------------------------------------------
    def commit(self, job_id: str, snapshot_id: int) -> None:
        """Spill the snapshot to disk (durability point: returns only
        after the manifest rename + fsync), then retire in-memory and
        on-disk predecessors beyond the retention chain."""
        prev = self.committed.get(job_id)
        self._spill(job_id, snapshot_id)
        self.committed[job_id] = snapshot_id
        if prev is not None and prev != snapshot_id:
            # in-memory tier keeps only the newest (base-class behaviour);
            # the chain lives on disk
            self._map(job_id, prev).destroy()
        self._trim(job_id)

    def _spill(self, job_id: str, snapshot_id: int) -> None:
        imap = self._map(job_id, snapshot_id)
        entries: List[Tuple[int, Any, Any]] = []
        for pid in range(self.service.partition_count):
            for key, value in imap.entries_for_partition(pid).items():
                entries.append((pid, key, value))
        d = self.snapshot_dir(job_id, snapshot_id)
        if d.exists():
            # stale torn spill of this same id from a previous coordinator
            shutil.rmtree(d)
        d.mkdir(parents=True)
        segments = []
        step = self.segment_entries
        chunks = [entries[i:i + step] for i in range(0, len(entries), step)] \
            or [[]]
        for idx, chunk in enumerate(chunks):
            payload = pickle.dumps(chunk, protocol=pickle.HIGHEST_PROTOCOL)
            name = f"seg-{idx:04d}.bin"
            _write_atomic(d / name, payload)
            segments.append({"name": name, "bytes": len(payload),
                             "crc32": zlib.crc32(payload),
                             "entries": len(chunk)})
        manifest = {
            "format": FORMAT_VERSION,
            "job_id": job_id,
            "snapshot_id": snapshot_id,
            "entries": len(entries),
            "segments": segments,
            # replay meta (source frontiers live in the entries themselves;
            # this is the job-level adoption info for recover_job)
            "meta": self.meta.get(job_id, {}).get(snapshot_id, {}),
            "written_unix": _time.time(),
        }
        _write_atomic(d / MANIFEST_NAME,
                      json.dumps(manifest, indent=1, default=repr).encode())

    def _trim(self, job_id: str) -> None:
        for sid in self.recovery_chain(job_id)[self.retain:]:
            shutil.rmtree(self.snapshot_dir(job_id, sid),
                          ignore_errors=True)

    # -- verification / restore ---------------------------------------------
    def verify(self, job_id: str, snapshot_id: int) -> Tuple[bool, str]:
        """Cheap integrity check: manifest identity plus every segment's
        size and CRC32 over raw bytes — no unpickling."""
        d = self.snapshot_dir(job_id, snapshot_id)
        if not d.is_dir():
            return False, "snapshot directory missing"
        mpath = d / MANIFEST_NAME
        if not mpath.exists():
            return False, "manifest missing (torn spill or deleted)"
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, ValueError) as e:
            return False, f"manifest unreadable: {e}"
        if manifest.get("format") != FORMAT_VERSION:
            return False, (f"manifest format {manifest.get('format')!r} "
                           f"!= {FORMAT_VERSION}")
        if (manifest.get("job_id") != job_id
                or manifest.get("snapshot_id") != snapshot_id):
            return False, "manifest identity mismatch"
        for seg in manifest.get("segments", []):
            p = d / seg["name"]
            try:
                data = p.read_bytes()
            except OSError:
                return False, f"segment {seg['name']} missing"
            if len(data) != seg["bytes"]:
                return False, (f"segment {seg['name']} truncated "
                               f"({len(data)} != {seg['bytes']} bytes)")
            if zlib.crc32(data) != seg["crc32"]:
                return False, f"segment {seg['name']} checksum mismatch"
        return True, ""

    def load_entries(self, job_id: str,
                     snapshot_id: int) -> List[Tuple[int, Any, Any]]:
        """All ``(pid, key, value)`` entries of one on-disk snapshot,
        CRC-checked segment by segment.  Raises ``ValueError`` on any
        integrity violation (callers treat it as "skip this chain
        entry")."""
        manifest = self.manifest(job_id, snapshot_id)
        if manifest is None:
            raise ValueError("manifest missing or unreadable")
        d = self.snapshot_dir(job_id, snapshot_id)
        entries: List[Tuple[int, Any, Any]] = []
        for seg in manifest.get("segments", []):
            data = (d / seg["name"]).read_bytes()
            if zlib.crc32(data) != seg["crc32"]:
                raise ValueError(f"segment {seg['name']} checksum mismatch")
            entries.extend(pickle.loads(data))
        return entries

    def prepare_restore(self, job_id: str,
                        snapshot_id: int) -> Tuple[bool, str]:
        """Rebuild the snapshot's IMap from its on-disk segments.  Disk is
        the source of truth for every restore: live in-memory state of the
        same epoch is discarded first, so a snapshot that no longer
        verifies on disk can never be restored from a stale in-memory
        copy."""
        ok, reason = self.verify(job_id, snapshot_id)
        if not ok:
            return False, reason
        try:
            entries = self.load_entries(job_id, snapshot_id)
        except (OSError, ValueError, pickle.UnpicklingError) as e:
            return False, f"segment load failed: {e}"
        self._map(job_id, snapshot_id).destroy()
        imap = self._map(job_id, snapshot_id)
        for pid, key, value in entries:
            imap.put_with_pid(key, value, pid)
        manifest = self.manifest(job_id, snapshot_id)
        if manifest and manifest.get("meta"):
            self.meta.setdefault(job_id, {})[snapshot_id] = manifest["meta"]
        return True, ""


def _write_atomic(path: Path, payload: bytes) -> None:
    """tmp file + fsync + atomic rename + directory fsync: a reader never
    observes a half-written file under ``path``, only the old state or
    the complete new one."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
