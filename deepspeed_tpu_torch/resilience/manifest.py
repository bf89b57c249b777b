"""Atomic checkpoint manifests: no silent bad restore, ever (copy of
``deepspeed_tpu/resilience/manifest.py``, which imports no JAX; the
schema is the same, so each package validates the other's manifests).

A preempted host can die mid-write; each payload file lands under a
``.tmp`` name and is renamed, but the *checkpoint as a unit* (payload +
metadata + the ``latest`` pointer) needs a durability witness, or
``load_checkpoint`` would restore whatever the filesystem held. The
manifest closes that hole:

* written LAST, via tmp+rename, only after every rank's payload is
  durable (``CheckpointIO._publish`` in checkpoint/state.py), so its presence
  certifies a complete save;
* records the tag, step, world topology, the data-pipeline cursor, and a
  per-file (size, crc32) table over the whole checkpoint dir, so torn or
  bit-rotted files are detected at load;
* :func:`validate_manifest` raises :class:`CheckpointCorruptError` with
  the concrete reason (missing file, size mismatch, checksum mismatch);
* :func:`find_latest_valid_tag` walks candidate tags newest-first so a
  corrupt latest falls back to the previous good tag instead of a torn
  restore.

Checksums stream with crc32 (zlib) — fast enough to run over multi-GB
payloads at save time without showing up next to the actual device→host
copy, and strong enough for the failure modes that matter here
(truncation, partial writes, zeroed pages). Paths under ``state/`` are
the tensor payload (one torch file per leaf); everything is checksummed
uniformly.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1

_SKIP_SUFFIXES = (".tmp",)
_CHUNK = 1 << 20


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed manifest validation (torn/corrupt save)."""

    def __init__(self, ckpt_dir: str, reason: str):
        self.ckpt_dir = ckpt_dir
        self.reason = reason
        super().__init__(
            f"checkpoint at {ckpt_dir} failed manifest validation: "
            f"{reason}. Refusing to restore a torn/corrupt save — "
            "pass an older tag, or delete the directory so auto-resume "
            "falls back to the previous good tag.")


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _is_tmp(name: str) -> bool:
    return any(s in name for s in _SKIP_SUFFIXES)


def _walk_files(ckpt_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in files:
            if name == MANIFEST_FILE or _is_tmp(name):
                continue
            out.append(os.path.relpath(os.path.join(root, name), ckpt_dir))
    return sorted(out)


def write_manifest(ckpt_dir: str, tag: str, *,
                   global_steps: int = 0,
                   world: Optional[Dict[str, Any]] = None,
                   data_cursor: Optional[Dict[str, Any]] = None,
                   extra: Optional[Dict[str, Any]] = None) -> str:
    """Checksum every file under ``ckpt_dir`` and publish the manifest
    atomically (tmp+rename). Call only after all payloads are durable."""
    files = {}
    for rel in _walk_files(ckpt_dir):
        p = os.path.join(ckpt_dir, rel)
        files[rel] = {"size": os.path.getsize(p),
                      "crc32": _file_crc32(p)}
    doc = {
        "kind": "dstpu_checkpoint_manifest",
        "version": MANIFEST_VERSION,
        "tag": str(tag),
        "global_steps": int(global_steps),
        "saved_at": time.time(),
        "world": dict(world or {}),
        "data_cursor": dict(data_cursor or {}),
        "n_files": len(files),
        "files": files,
    }
    if extra:
        doc.update(extra)
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """Parsed manifest, or None when absent (pre-resilience checkpoint).
    An unparseable manifest raises CheckpointCorruptError — a torn
    manifest write means the save did not complete."""
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(ckpt_dir, f"unreadable manifest: {e}")
    if doc.get("kind") != "dstpu_checkpoint_manifest":
        raise CheckpointCorruptError(ckpt_dir, "not a checkpoint manifest")
    return doc


def validate_manifest(ckpt_dir: str,
                      check_checksums: bool = True
                      ) -> Optional[Dict[str, Any]]:
    """Validate ``ckpt_dir`` against its manifest.

    Returns the manifest dict, or None when no manifest exists (legacy
    checkpoint — callers decide whether to accept). Raises
    :class:`CheckpointCorruptError` naming the first defect found."""
    doc = read_manifest(ckpt_dir)
    if doc is None:
        return None
    files = doc.get("files", {})
    for rel, ent in files.items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptError(ckpt_dir, f"missing file: {rel}")
        size = os.path.getsize(p)
        if size != ent.get("size"):
            raise CheckpointCorruptError(
                ckpt_dir, f"size mismatch for {rel}: manifest says "
                f"{ent.get('size')} bytes, found {size} (truncated/torn "
                "write)")
        if check_checksums and _file_crc32(p) != ent.get("crc32"):
            raise CheckpointCorruptError(
                ckpt_dir, f"checksum mismatch for {rel} (corrupt data)")
    return doc


def _candidate_tags(load_dir: str) -> List[str]:
    """Tag directories under ``load_dir`` sorted newest-first by manifest
    saved_at (manifest-less dirs sort last, by mtime)."""
    entries = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    for name in names:
        d = os.path.join(load_dir, name)
        if not os.path.isdir(d):
            continue
        mpath = os.path.join(d, MANIFEST_FILE)
        order = (0.0, os.path.getmtime(d))
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    order = (1.0, float(json.load(f).get("saved_at", 0.0)))
            except (OSError, ValueError):
                order = (1.0, 0.0)  # torn manifest: still a candidate slot
        entries.append((order, name))
    entries.sort(reverse=True)
    return [name for _o, name in entries]


def find_latest_valid_tag(load_dir: str,
                          exclude: Optional[List[str]] = None,
                          check_checksums: bool = True) -> Optional[str]:
    """Newest tag under ``load_dir`` that passes manifest validation
    (manifest-less legacy dirs do NOT qualify — a fallback must be
    provably good). ``exclude`` lists tags already known bad."""
    exclude = set(exclude or [])
    for tag in _candidate_tags(load_dir):
        if tag in exclude:
            continue
        d = os.path.join(load_dir, tag)
        try:
            doc = validate_manifest(d, check_checksums=check_checksums)
        except CheckpointCorruptError as e:
            logger.warning(f"resilience: skipping corrupt checkpoint "
                           f"candidate {tag!r}: {e.reason}")
            continue
        if doc is not None:
            return tag
    return None
