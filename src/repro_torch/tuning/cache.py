"""Persistent tuning cache: the winning launch tile and burst per problem.

Winners are keyed by the problem identity the paper's design sweep
varies: ``(kernel, M, N, K, dtype, shared-memory budget)``. The store is a
flat JSON file, so caches from different runs merge (a measured entry
beats a calibrated one, which beats an analytic one; within a source the
lower cost wins), and ship like the paper ships its 32 KB / burst-16
operating point.

The file's schema is the port's own (``"hopper-1"``): a cache the JAX
package wrote holds Pallas tiles for a TPU, so ``load`` refuses it and
``load_or_empty`` warns and starts empty; its tiles are never read as
Hopper launches.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = "hopper-1"


@dataclass(frozen=True)
class TuningKey:
    kernel: str
    m: int
    n: int
    k: int
    dtype: str                    # weight path: q8_0 | bf16
    smem_budget_bytes: int

    def encode(self) -> str:
        return (f"{self.kernel}|m{self.m}|n{self.n}|k{self.k}"
                f"|{self.dtype}|s{self.smem_budget_bytes}")

    @staticmethod
    def decode(s: str) -> "TuningKey":
        kernel, m, n, k, dtype, b = s.split("|")
        return TuningKey(kernel, int(m[1:]), int(n[1:]), int(k[1:]),
                         dtype, int(b[1:]))


@dataclass(frozen=True)
class TuningRecord:
    """A winner: the launch (``kernels/tiles.py``) and the burst
    ``block_k``, the block's output extent, its shared-memory claim, and
    the cost that won and where it came from."""
    block_m: int
    block_n: int
    block_k: int
    cost_s: float
    claim_bytes: int
    source: str                   # analytic | calibrated | measured
    launch: Tuple[int, ...]

    def __post_init__(self):      # JSON gives a list
        object.__setattr__(self, "launch", tuple(self.launch))

    def tiling(self) -> Tuple[int, ...]:
        """The kernel's tile argument: what a plan entry carries (``()``:
        a launch that takes none)."""
        return self.launch


def _better(a: TuningRecord, b: TuningRecord) -> TuningRecord:
    """Merge policy: measured beats calibrated beats analytic (more grounded
    sources win); within a source, lower cost."""
    rank = {"measured": 0, "calibrated": 1, "analytic": 2}
    ka = (rank.get(a.source, 3), a.cost_s)
    kb = (rank.get(b.source, 3), b.cost_s)
    return a if ka <= kb else b


@dataclass
class TuningCache:
    entries: Dict[TuningKey, TuningRecord] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key: TuningKey) -> Optional[TuningRecord]:
        rec = self.entries.get(key)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put(self, key: TuningKey, rec: TuningRecord) -> None:
        cur = self.entries.get(key)
        self.entries[key] = rec if cur is None else _better(rec, cur)

    def merge(self, other: "TuningCache") -> "TuningCache":
        for k, r in other.entries.items():
            self.put(k, r)
        return self

    # -- persistence ----------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION,
                "entries": {k.encode(): asdict(r)
                            for k, r in sorted(self.entries.items(),
                                               key=lambda kv: kv[0].encode())}}

    @classmethod
    def from_dict(cls, d: dict) -> "TuningCache":
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"tuning cache schema {d.get('schema')!r} "
                             f"!= {SCHEMA_VERSION!r}")
        c = cls()
        for ks, rv in d.get("entries", {}).items():
            c.entries[TuningKey.decode(ks)] = TuningRecord(**rv)
        return c

    def save(self, path: str) -> str:
        """Atomic write (tmp + rename): a crashed sweep never truncates a
        good cache."""
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def load_or_empty(cls, path: Optional[str]) -> "TuningCache":
        """Best-effort load for dispatch-time use: a cache is an
        optimization, so a missing, corrupt or schema-mismatched file (a
        cache of the JAX package among them) degrades to an empty cache,
        with a warning, instead of failing engine construction. Use
        ``load`` where that should be an error."""
        if path and os.path.exists(path):
            try:
                return cls.load(path)
            except (ValueError, KeyError, TypeError, OSError) as e:
                warnings.warn(f"ignoring unreadable tuning cache {path}: {e}")
        return cls()
