"""Tidehunter storage engine on PyTorch (paper §3–§5): the host engine, with
its Bloom probe and optimistic lookup launched as CUDA kernels on the card."""
from .api import (Engine, KeyspaceHandle, PruneOptions, ReadOptions,
                  WriteBatch, WriteOptions)
from .cache import BlobArrayCache, LruCache
from .db import DbConfig, TideDB
from .faults import (CorruptionError, DegradedError, FaultRule, FaultyIo,
                     IoBackend, KeyWidthError, TornRecordError,
                     UnrepairedHoleError, WalHoleError, WalReadError,
                     random_schedule)
from .index import (HeaderLookup, OptimisticLookup, serialize_header,
                    serialize_optimistic)
from .large_table import CellState, KeyspaceConfig, LargeTable
from .relocate import Decision, PruneController, PruneThread, Relocator
from .scrub import ScrubConfig, Scrubber, ScrubThread, read_scrub_table
from .system import (SYSTEM_KEYSPACE, SYSTEM_KS_ID, CopierGovernor,
                     StatsCollector,
                     decode_row_key, read_tables, row_key,
                     system_keyspace_config)
from .util import Metrics, PositionTracker
from .wal import CopyPool, Wal, WalConfig

__all__ = [
    "TideDB", "DbConfig", "KeyspaceConfig", "CellState",
    "LargeTable", "Engine", "KeyspaceHandle", "WriteBatch", "ReadOptions",
    "WriteOptions", "PruneOptions", "Wal", "WalConfig", "CopyPool",
    "Relocator", "PruneController", "PruneThread", "Decision",
    "Metrics", "PositionTracker", "LruCache", "BlobArrayCache",
    "OptimisticLookup", "HeaderLookup", "serialize_optimistic",
    "serialize_header",
    "SYSTEM_KEYSPACE", "SYSTEM_KS_ID", "StatsCollector", "CopierGovernor",
    "read_tables",
    "row_key", "decode_row_key", "system_keyspace_config",
    "IoBackend", "FaultyIo", "FaultRule", "random_schedule",
    "WalReadError", "CorruptionError", "TornRecordError", "WalHoleError",
    "UnrepairedHoleError", "DegradedError", "KeyWidthError",
    "Scrubber", "ScrubThread", "ScrubConfig", "read_scrub_table",
]
