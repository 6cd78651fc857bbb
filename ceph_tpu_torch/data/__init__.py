"""ceph_tpu_torch.data — RADOS-native sharded training-data ingestion and a
deterministic, prefetching, resumable dataset iterator (the DataStore
subsystem; see COMPONENTS.md "Data ingestion").

Port of ceph_tpu/data, a copy: batches are host numpy records, as in the
reference; a record to ingest may also be a torch tensor."""

from ceph_tpu_torch.data.layout import (
    DataCorrupt,
    cursor_array,
    cursor_from_array,
    epoch_permutation,
)
from ceph_tpu_torch.data.reader import DataIterator, DataReader
from ceph_tpu_torch.data.store import DataStore
from ceph_tpu_torch.data.writer import DataConflict, DataWriter

__all__ = [
    "DataConflict",
    "DataCorrupt",
    "DataIterator",
    "DataReader",
    "DataStore",
    "DataWriter",
    "cursor_array",
    "cursor_from_array",
    "epoch_permutation",
]
