"""Coupling data plane (Exp 5): in-memory vs filesystem exchange.

``InMemoryStore`` is the SmartRedis/Dragon-channel analogue (per-"node"
dict-backed KV store with PUT/GET latency tracing); ``FileSystemStore`` is
the RAM-disk baseline the paper compares against.  Both move real ndarray
payloads so the benchmark measures genuine serialization/copy costs.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np


class StoreStats:
    __slots__ = ("put_times", "get_times", "put_bytes", "get_bytes")

    def __init__(self):
        self.put_times: list = []
        self.get_times: list = []
        self.put_bytes = 0
        self.get_bytes = 0

    def summary(self) -> dict:
        def avg(xs):
            return sum(xs) / len(xs) if xs else 0.0

        return {
            "puts": len(self.put_times),
            "gets": len(self.get_times),
            "avg_put_ms": 1e3 * avg(self.put_times),
            "avg_get_ms": 1e3 * avg(self.get_times),
            "put_bytes": self.put_bytes,
            "get_bytes": self.get_bytes,
        }


class DataStore:
    """API shared by both coupling mechanisms."""

    def put(self, key: str, value) -> None:
        raise NotImplementedError

    def get(self, key: str, *, timeout: float = 10.0):
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStore(DataStore):
    """Node-local shared-memory exchange (SmartRedis analogue)."""

    def __init__(self, node_id: int = 0):
        self.node_id = node_id
        self._data: dict = {}
        self._cond = threading.Condition()
        self.stats = StoreStats()

    def put(self, key, value):
        t0 = time.perf_counter()
        if isinstance(value, np.ndarray):
            payload = value.copy()  # ownership transfer (no aliasing races)
            nbytes = payload.nbytes
        else:
            payload = value
            nbytes = len(pickle.dumps(value, protocol=5))
        with self._cond:
            self._data[key] = payload
            self._cond.notify_all()
        self.stats.put_times.append(time.perf_counter() - t0)
        self.stats.put_bytes += nbytes

    def get(self, key, *, timeout: float = 10.0):
        t0 = time.perf_counter()
        with self._cond:
            ok = self._cond.wait_for(lambda: key in self._data, timeout)
            if not ok:
                raise KeyError(f"timeout waiting for {key}")
            value = self._data[key]
        nbytes = (value.nbytes if isinstance(value, np.ndarray)
                  else len(pickle.dumps(value, protocol=5)))
        self.stats.get_times.append(time.perf_counter() - t0)
        self.stats.get_bytes += nbytes
        return value

    def delete(self, key):
        with self._cond:
            self._data.pop(key, None)


class FileSystemStore(DataStore):
    """File-based exchange (RAM-disk baseline). Uses /dev/shm when present."""

    def __init__(self, node_id: int = 0, root: Optional[str] = None):
        base = root or ("/dev/shm" if os.path.isdir("/dev/shm")
                        else tempfile.gettempdir())
        self.dir = tempfile.mkdtemp(prefix=f"rhapsody_fs_{node_id}_", dir=base)
        self.stats = StoreStats()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key.replace("/", "_") + ".npy")

    def put(self, key, value):
        t0 = time.perf_counter()
        path = self._path(key)
        tmp = path + ".tmp"
        if isinstance(value, np.ndarray):
            np.save(tmp + ".npy", value)
            os.replace(tmp + ".npy", path)
            nbytes = value.nbytes
        else:
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=5)
            os.replace(tmp, path)
            nbytes = os.path.getsize(path)
        self.stats.put_times.append(time.perf_counter() - t0)
        self.stats.put_bytes += nbytes

    def get(self, key, *, timeout: float = 10.0):
        t0 = time.perf_counter()
        path = self._path(key)
        deadline = t0 + timeout
        while not os.path.exists(path):
            if time.perf_counter() > deadline:
                raise KeyError(f"timeout waiting for {key}")
            time.sleep(1e-4)
        try:
            value = np.load(path)
        except (ValueError, pickle.UnpicklingError):
            with open(path, "rb") as f:
                value = pickle.load(f)
        self.stats.get_times.append(time.perf_counter() - t0)
        # mirror put's accounting (ndarray: raw bytes; pickle: file
        # size) so pickled payloads no longer read as zero bytes
        self.stats.get_bytes += (value.nbytes
                                 if isinstance(value, np.ndarray)
                                 else os.path.getsize(path))
        return value

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def make_store(kind: str, node_id: int = 0) -> DataStore:
    if kind == "memory":
        return InMemoryStore(node_id)
    if kind == "filesystem":
        return FileSystemStore(node_id)
    raise ValueError(f"unknown store kind {kind!r}")
