"""The control: the plain reference put in the program's place with one
stated guarantee broken, the way a faster store would be tempted to break it.

Every configuration states that existence answers are exact.  The control
answers ``multi_exists`` from a Bloom filter alone, at the configuration's
bits a key and probes (10 and 7): never a false negative, and about 1% false
positives on keys never written.  Gets, puts and retention stay exact.
The comparison that decides ``correct`` has to find it wrong on every cell.

Run it on the chip at a cell's own size, the seeds one after another in one
process::

    python3 -m tidebench.control --workload tide-1k.read --seeds 11,12,13 \
        --seconds 10

It prints, for each seed, the numbers the run compares and their limits.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from .reference import ReferenceStore

ROOT = Path(__file__).resolve().parents[1]


def _hashes(keys) -> tuple[np.ndarray, np.ndarray]:
    h1 = np.empty(len(keys), np.int64)
    h2 = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        d = hashlib.blake2b(k, digest_size=8).digest()
        h1[i] = int.from_bytes(d[:4], "little")
        h2[i] = int.from_bytes(d[4:], "little") | 1
    return h1, h2


class BloomOnlyStore(ReferenceStore):
    """A dict store whose existence answers come from a Bloom filter."""

    def __init__(self, retain_epochs=None, value_bytes: int = 1024,
                 bits_per_key: int = 10, k: int = 7):
        super().__init__(retain_epochs, value_bytes)
        self.bits_per_key, self.k = bits_per_key, k
        self._h1 = np.zeros(0, np.int64)
        self._h2 = np.zeros(0, np.int64)
        self._cap = 1 << 10
        self._bits = np.zeros(self._cap * bits_per_key // 32 + 1, np.uint32)

    def _probe_bits(self, h1, h2):
        nbits = self._bits.size * 32
        i = np.arange(self.k, dtype=np.int64)[:, None]
        return ((h1[None, :] + i * h2[None, :]) & 0xFFFFFFFF) % nbits

    def _add(self, h1, h2) -> None:
        b = self._probe_bits(h1, h2).ravel()
        np.bitwise_or.at(self._bits, b >> 5,
                         (np.uint32(1) << (b & 31).astype(np.uint32)))

    def put_many(self, items, keyspace=None, epoch: int = 0):
        items = list(items)
        super().put_many(items, epoch)
        h1, h2 = _hashes([k for k, _ in items])
        self._h1 = np.concatenate([self._h1, h1])
        self._h2 = np.concatenate([self._h2, h2])
        if self._h1.size > self._cap:
            # Grow by a quarter and add every key again, as a flush rebuilds
            # a cell's filter over its whole key set: 10 to 12.5 bits a key.
            while self._h1.size > self._cap:
                self._cap = self._cap * 5 // 4
            self._bits = np.zeros(self._cap * self.bits_per_key // 32 + 1,
                                  np.uint32)
            self._add(self._h1, self._h2)
        else:
            self._add(h1, h2)
        return list(range(len(items)))

    def multi_get(self, keys, keyspace=None):
        return [self.get(k) for k in keys]

    def multi_exists(self, keys, keyspace=None):
        b = self._probe_bits(*_hashes(keys))
        hit = (self._bits[b >> 5] >> (b & 31).astype(np.uint32)) & 1
        return [bool(x) for x in hit.all(axis=0)]

    def prune_step(self):
        return 0

    def flush(self):
        pass

    def close(self):
        pass


def control_factory(config: dict):
    """A ``store_factory`` that opens one ``BloomOnlyStore`` and gives the
    same one back on every reopen (it keeps what it acknowledged)."""
    from .drivers.store import retain_epochs
    store = BloomOnlyStore(retain_epochs(config), config["value_bytes"])
    return lambda path: store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    from .run import load_cell, prepare
    prepare(ROOT)
    config, workload, _cell = load_cell(ROOT, args.workload)
    from .drivers.store import run
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run(config, workload, seed, args.seconds,
                  store_factory=control_factory(config))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rounds": out["rounds"], "checks": out["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
