"""ECUtil analogues: per-shard cumulative hash metadata (HashInfo).

Re-expresses src/osd/ECUtil.h:101-160: every EC object
carries, as an attribute on each shard, the cumulative crc32c (seed -1) of
every shard's bytes plus the common chunk size — written at encode time and
verified by deep scrub (ECBackend::be_deep_scrub, ECBackend.cc:2461-2540).
Append-only updates extend the hashes exactly as HashInfo::append does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.common.crc import ceph_crc32c

SEED = 0xFFFFFFFF  # bufferhash(-1)


@dataclass
class HashInfo:
    total_chunk_size: int = 0
    cumulative_shard_hashes: list[int] = field(default_factory=list)

    @classmethod
    def from_shards(cls, shards: dict[int, bytes], n_chunks: int) -> "HashInfo":
        """Fresh metadata for a full write of all n_chunks shards."""
        hi = cls(0, [SEED] * n_chunks)
        size = len(next(iter(shards.values()))) if shards else 0
        hi.append({i: shards[i] for i in sorted(shards)}, size)
        return hi

    def append(self, to_append: dict[int, bytes], chunk_len: int) -> None:
        """Extend every shard's cumulative hash (ECUtil.cc HashInfo::append:
        all shards must grow by the same chunk_len)."""
        for shard, data in to_append.items():
            assert len(data) == chunk_len, "shards must append equally"
            self.cumulative_shard_hashes[shard] = ceph_crc32c(
                self.cumulative_shard_hashes[shard], data
            )
        self.total_chunk_size += chunk_len

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]
