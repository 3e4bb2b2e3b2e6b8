"""Name/version model registry over ``checkpoint/io`` with an atomic
LATEST pointer (port of ``repro.serve.registry``).

The on-disk layout is the reference's, so a registry either package writes
the other reads, bit for bit (f32 and int32 leaves; bf16 as its raw 16
bits, as ``checkpoint/io`` stores it)::

    <root>/<name>/step_00000001.npz   # checkpoint.io payload
    <root>/<name>/step_00000001.json  # checkpoint.io manifest
    <root>/<name>/meta_00000001.json  # registry metadata (publisher info)
    <root>/<name>/LATEST              # active version pointer

A version is claimed by an exclusive-create sentinel, kept until the
payload is in place, so at every moment the sentinel or the payload holds
a claimed number; a claim succeeds only where neither exists (ROADMAP.md
queue 3, item 23).  ``publish`` writes the payload (atomic inside
``checkpoint.io.save``), then flips ``LATEST`` by write-temp +
``os.replace``: a serving process that
re-resolves ``latest`` between two requests sees the old or the new
version, never a torn state, so a live ``ServeEngine`` picks a new fit up
with ``engine.swap(registry.load(name))``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from typing import Any

from repro_torch.checkpoint import io as ckpt_io

PyTree = Any


class ModelRegistry:
    """Versioned store of finalized models, keyed by name."""

    def __init__(self, root: str):
        self.root = root

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    # -- write side ----------------------------------------------------------

    def publish(self, name: str, theta: PyTree, *, meta: dict | None = None,
                activate: bool = True) -> int:
        """Store ``theta`` as the next version of ``name``; with
        ``activate`` (default) the LATEST pointer moves to it.  Concurrent
        publishers each get their own version: the number is claimed with an
        exclusive-create sentinel before anything is written."""
        d = self._dir(name)
        os.makedirs(d, exist_ok=True)
        version = self._claim_version(name)
        ckpt_io.save(d, version, theta)
        # the payload now protects the number: drop the claim sentinel
        with contextlib.suppress(FileNotFoundError):
            os.unlink(os.path.join(d, f"step_{version:08d}.claim"))
        record = {
            **(meta or {}),
            # reserved manifest keys win over user metadata
            "name": name,
            "version": version,
            "published_at": time.time(),
        }
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(record, f)
        os.replace(tmp, os.path.join(d, f"meta_{version:08d}.json"))
        if activate:
            self.set_latest(name, version)
        return version

    def _claim_version(self, name: str) -> int:
        d = self._dir(name)
        claimed = [
            int(m.group(1))
            for fn in os.listdir(d)
            if (m := re.match(r"step_(\d+)\.(npz|claim)$", fn))
        ]
        version = (max(claimed) + 1) if claimed else 1
        while True:
            claim = os.path.join(d, f"step_{version:08d}.claim")
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:  # another publisher got here first
                version += 1
                continue
            # a publisher that listed the directory before us may have
            # written its payload and dropped its claim since: the payload
            # holds the number then (the reference checks only the claim)
            if os.path.exists(os.path.join(d, f"step_{version:08d}.npz")):
                os.unlink(claim)
                version += 1
                continue
            return version

    def set_latest(self, name: str, version: int) -> None:
        """Atomically repoint LATEST (the hot-swap primitive)."""
        d = self._dir(name)
        if not os.path.exists(os.path.join(d, f"step_{version:08d}.npz")):
            raise FileNotFoundError(f"{name!r} has no published version {version}")
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(str(version))
        os.replace(tmp, os.path.join(d, "LATEST"))

    # -- read side -----------------------------------------------------------

    def models(self) -> list:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            n for n in os.listdir(self.root)
            if os.path.isdir(self._dir(n)) and self.versions(n)
        )

    def versions(self, name: str) -> list:
        d = self._dir(name)
        if not os.path.isdir(d):
            return []
        return sorted(
            int(m.group(1))
            for fn in os.listdir(d)
            if (m := re.match(r"step_(\d+)\.npz$", fn))
        )

    def latest(self, name: str) -> int | None:
        """The ACTIVATED version: None until something is activated, so a
        model only ever staged (``activate=False``) is never served by
        default."""
        try:
            with open(os.path.join(self._dir(name), "LATEST")) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return None

    def resolve(self, name: str, version: int | None = None) -> int:
        v = version if version is not None else self.latest(name)
        if v is None or v not in self.versions(name):
            raise FileNotFoundError(f"registry has no version {version!r} of model {name!r}")
        return v

    def load(self, name: str, version: int | None = None, *, like: PyTree = None,
             shardings=None, device="cuda") -> PyTree:
        """Materialize a published model.  With ``like`` this is
        ``checkpoint.io.restore`` (its structure; each leaf takes its
        template's type and device); without it, nested-dict or bare-array
        thetas are rebuilt from the manifest keys as tensors on ``device``
        (default ``"cuda"``, raising without a GPU).  ``shardings`` (with
        ``like``) places each leaf on its mesh, as ``restore`` does."""
        v = self.resolve(name, version)
        if like is not None:
            return ckpt_io.restore(self._dir(name), v, like, shardings=shardings)
        return ckpt_io.restore_dict(self._dir(name), v, device=device)

    def meta(self, name: str, version: int | None = None) -> dict:
        v = self.resolve(name, version)
        with open(os.path.join(self._dir(name), f"meta_{v:08d}.json")) as f:
            return json.load(f)
