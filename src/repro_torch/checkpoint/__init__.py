"""Persistence: the partitioned relation store and cascade hop snapshots.

Port of the relation half of ``src/repro/checkpoint/store.py``, with
the same on-disk format, so each package loads the other's stores.
"""

from .store import (DataCorrupt, latest_hop, load_hop, load_json,
                    load_partition_spec, load_partitioned, save_hop,
                    save_json_atomic, save_partitioned, set_fault_hook)

__all__ = ["DataCorrupt", "save_partitioned", "load_partitioned",
           "load_partition_spec", "save_json_atomic", "load_json",
           "save_hop", "load_hop", "latest_hop", "set_fault_hook"]
