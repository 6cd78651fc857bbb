"""journal: client-side journaling + async mirroring (src/journal,
src/tools/rbd_mirror).

The reference's journaling library appends every image mutation to rados
journal objects BEFORE applying it, and rbd-mirror daemons on a remote
cluster tail those journals to replay writes — asynchronous, ordered,
crash-consistent replication. Mini equivalents:

  * `Journaler` — an append/replay/commit/trim log whose entries live in a
    journal object mutated only by cls methods at the primary, so appends
    from concurrent clients serialize and positions never collide (the
    reference splays entries over multiple objects for parallelism; one
    chain keeps the same contract at mini scale).
  * `MirroredImage` — an rbd Image whose writes/resizes are journaled
    ahead of application (the rbd journaling feature).
  * `ImageReplayer` — the rbd-mirror core: tail the source journal from
    the committed position, replay events onto the destination cluster's
    image, advance the commit position, trim.
"""

from ceph_tpu_torch.journal.journal import (
    ImageReplayer,
    Journaler,
    MirroredImage,
)

__all__ = ["ImageReplayer", "Journaler", "MirroredImage"]
