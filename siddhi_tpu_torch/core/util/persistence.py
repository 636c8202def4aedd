"""Persistence stores: where snapshots go (a copy of
``siddhi_tpu/core/util/persistence.py``).

Mirror of reference ``util/persistence/{InMemoryPersistenceStore.java:30,
FileSystemPersistenceStore.java:33}``. Incremental (op-log) stores are
intentionally absent: dense-array state snapshots are already O(state)
(SURVEY.md §5.4) — a full snapshot IS the efficient form here.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class InMemoryPersistenceStore:
    def __init__(self):
        self._store: Dict[str, Dict[str, bytes]] = {}

    def save(self, app_name: str, revision: str, snapshot: bytes):
        self._store.setdefault(app_name, {})[revision] = snapshot

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        return self._store.get(app_name, {}).get(revision)

    def get_last_revision(self, app_name: str) -> Optional[str]:
        revs = self.revisions(app_name)
        return revs[-1] if revs else None

    def revisions(self, app_name: str) -> List[str]:
        return sorted(self._store.get(app_name, {}))

    def clear_all_revisions(self, app_name: str):
        self._store.pop(app_name, None)


class FileSystemPersistenceStore:
    def __init__(self, base_path: str):
        self.base_path = base_path

    def _dir(self, app_name: str) -> str:
        return os.path.join(self.base_path, app_name)

    def save(self, app_name: str, revision: str, snapshot: bytes):
        d = self._dir(app_name)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, revision + ".tmp")
        with open(tmp, "wb") as f:
            f.write(snapshot)
        os.replace(tmp, os.path.join(d, revision + ".snapshot"))

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        path = os.path.join(self._dir(app_name), revision + ".snapshot")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def get_last_revision(self, app_name: str) -> Optional[str]:
        revs = self.revisions(app_name)
        return revs[-1] if revs else None

    def revisions(self, app_name: str) -> List[str]:
        d = self._dir(app_name)
        if not os.path.isdir(d):
            return []
        return sorted(
            f[: -len(".snapshot")] for f in os.listdir(d) if f.endswith(".snapshot")
        )

    def clear_all_revisions(self, app_name: str):
        for rev in self.revisions(app_name):
            os.remove(os.path.join(self._dir(app_name), rev + ".snapshot"))
