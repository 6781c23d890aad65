"""The plain reference of a key-value store with epoch retention.

A record of which keys were acknowledged, and in which epoch, fed the same
operations the program is fed.  A value is never kept: it is worked out from
its key (``traffic.value_of``), as the traffic made it.  The reference states
what each answer must be under the guarantees a configuration gives: every
acknowledged write reads back byte-exact, a key never written reads as
absent, and under ``retain_epochs = R`` the writes of the R newest epochs
written stay readable.  A key of an epoch that aged out has no fixed answer
(pruning may or may not have dropped it yet), so it is never asked about and
the reference refuses to judge it.

Acknowledgements are appended as they come and indexed by key only when the
first answer is judged, after the window: the window pays for no lookup
table that grows.

It imports nothing of the program under test.
"""
from __future__ import annotations

from .traffic import value_of


class Expired(KeyError):
    """A key whose epoch the retention policy let go: no answer is fixed."""


class ReferenceStore:
    def __init__(self, retain_epochs: int | None = None,
                 value_bytes: int = 1024):
        self.retain_epochs = retain_epochs
        self.value_bytes = value_bytes
        self.newest_epoch = 0
        self._pending: list[tuple[list[bytes], int]] = []
        self._epoch_of: dict[bytes, int] = {}

    def put_many(self, items, epoch: int = 0) -> None:
        """Acknowledge ``items`` (keys, or (key, value) pairs whose value is
        the key's own) in ``epoch``."""
        self._pending.append(
            ([it if isinstance(it, bytes) else it[0] for it in items], epoch))
        self.newest_epoch = max(self.newest_epoch, epoch)

    def _index(self) -> dict[bytes, int]:
        for keys, epoch in self._pending:
            self._epoch_of.update(dict.fromkeys(keys, epoch))
        self._pending.clear()
        return self._epoch_of

    def epoch_floor(self) -> int:
        """The oldest epoch still retained (0: every epoch is)."""
        if self.retain_epochs is None:
            return 0
        return self.newest_epoch - self.retain_epochs + 1

    def get(self, key: bytes, floor: int | None = None):
        """The value ``key`` must read as, with ``floor`` the oldest epoch
        retained when it was read (by default, now)."""
        epoch = self._index().get(key)
        if epoch is None:
            return None
        if 0 < epoch < (self.epoch_floor() if floor is None else floor):
            raise Expired(key)
        return value_of(key, self.value_bytes)

    def exists(self, key: bytes, floor: int | None = None) -> bool:
        return self.get(key, floor) is not None

    def wrong_values(self, keys, got, floor: int | None = None) -> int:
        """Answers of a ``multi_get`` that differ from the reference."""
        if got is None or len(got) != len(keys):
            return len(keys)
        return sum(1 for k, v in zip(keys, got) if v != self.get(k, floor))

    def wrong_exists(self, keys, got, floor: int | None = None) -> int:
        """Answers of a ``multi_exists`` that differ from the reference."""
        if got is None or len(got) != len(keys):
            return len(keys)
        return sum(1 for k, e in zip(keys, got)
                   if bool(e) != self.exists(k, floor))
