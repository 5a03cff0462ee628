"""Persistence: LM checkpoints, the partitioned relation store and
cascade hop snapshots.

Port of ``src/repro/checkpoint/store.py``, with the same on-disk
format, so each package loads the other's checkpoints and stores.
"""

from .store import (CheckpointManager, DataCorrupt, latest_hop, latest_step,
                    load_hop, load_json, load_partition_spec,
                    load_partitioned, restore, save, save_hop,
                    save_json_atomic, save_partitioned, set_fault_hook)

__all__ = ["CheckpointManager", "DataCorrupt", "save", "restore",
           "latest_step", "save_partitioned", "load_partitioned",
           "load_partition_spec", "save_json_atomic", "load_json",
           "save_hop", "load_hop", "latest_hop", "set_fault_hook"]
