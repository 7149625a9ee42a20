"""In-memory Kubernetes-like API with watches.

The envtest analog (SURVEY §4): stores KubeObjects per kind, supports
list/get/create/update/delete with resource-version bumps, finalizer-gated
deletion, and queue-based watch streams consumed by the controllers.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..apis.objects import KubeObject


@dataclass(frozen=True)
class Event:
    type: str          # ADDED | MODIFIED | DELETED
    obj: KubeObject


class Conflict(Exception):
    """Optimistic-concurrency conflict (stale resourceVersion)."""


class NotFound(KeyError):
    pass


class FakeKube:
    def __init__(self, now: Callable[[], float] = time.time):
        self._mu = threading.RLock()
        self._store: Dict[Tuple[str, str, str], KubeObject] = {}
        self._watchers: List[Tuple[Optional[str], "queue.Queue[Event]"]] = []
        self._rv = 0
        self.now = now

    # -- CRUD --------------------------------------------------------------
    def create(self, obj: KubeObject) -> KubeObject:
        # admission: the CEL-rule analog runs where the kube-apiserver
        # would run it (apis/validation.py)
        from ..apis.validation import validate
        validate(obj)
        with self._mu:
            key = obj.key()
            if key in self._store:
                raise ValueError(f"AlreadyExists: {key}")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.now()
            self._store[key] = obj
            self._notify(Event("ADDED", obj))
            return obj

    def get(self, kind: str, name: str, namespace: str = "") -> KubeObject:
        with self._mu:
            key = (kind, namespace, name)
            if key not in self._store:
                raise NotFound(f"{kind}/{name}")
            return self._store[key]

    def try_get(self, kind: str, name: str, namespace: str = "") -> Optional[KubeObject]:
        with self._mu:
            return self._store.get((kind, namespace, name))

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[KubeObject]:
        with self._mu:
            out = []
            for (k, ns, _), obj in self._store.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and any(
                        obj.metadata.labels.get(lk) != lv
                        for lk, lv in label_selector.items()):
                    continue
                out.append(obj)
            return sorted(out, key=lambda o: (o.metadata.namespace, o.metadata.name))

    def update(self, obj: KubeObject, expect_version: Optional[int] = None) -> KubeObject:
        from ..apis.validation import validate, validate_update
        with self._mu:
            key = obj.key()
            cur = self._store.get(key)
            if cur is None:
                raise NotFound(f"{key}")
            if cur is not obj:
                # a distinct old object allows immutability checks too
                validate_update(cur, obj)
            else:
                # in-place mutation + update(obj is cur) is the common test
                # pattern; admission rules still apply
                validate(obj)
            if expect_version is not None and cur.metadata.resource_version != expect_version:
                raise Conflict(f"{key}: rv {cur.metadata.resource_version} != {expect_version}")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._store[key] = obj
            self._notify(Event("MODIFIED", obj))
            return obj

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        """Finalizer-aware: with finalizers present, only stamps
        deletionTimestamp; the object disappears when finalizers clear."""
        with self._mu:
            key = (kind, namespace, name)
            obj = self._store.get(key)
            if obj is None:
                raise NotFound(f"{kind}/{name}")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self.now()
                    self._rv += 1
                    obj.metadata.resource_version = self._rv
                    self._notify(Event("MODIFIED", obj))
                return
            del self._store[key]
            self._notify(Event("DELETED", obj))

    def remove_finalizer(self, obj: KubeObject, finalizer: str) -> None:
        with self._mu:
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                key = obj.key()
                if key in self._store:
                    del self._store[key]
                    self._notify(Event("DELETED", obj))
            else:
                self.update(obj)

    # -- watch -------------------------------------------------------------
    def watch(self, kind: Optional[str] = None) -> "queue.Queue[Event]":
        q: "queue.Queue[Event]" = queue.Queue()
        with self._mu:
            self._watchers.append((kind, q))
            # replay existing state as ADDED (informer initial-list semantics)
            for (k, _, _), obj in sorted(self._store.items()):
                if kind is None or k == kind:
                    q.put(Event("ADDED", obj))
        return q

    def _notify(self, ev: Event) -> None:
        for kind, q in self._watchers:
            if kind is None or ev.obj.kind == kind:
                q.put(ev)

    def reset(self) -> None:
        with self._mu:
            self._store.clear()
            self._watchers.clear()
            self._rv = 0
