"""cephfs: the POSIX-ish file layer (L9, fs-lite).

The reference's CephFS is a metadata SERVER (src/mds, 84k LoC: its own
journal, distributed locks, dirfrag trees) with clients doing capability
leases. Two tiers here:

  * `mds.MDSService` + `client.CephFSClient` — the DAEMON model:
    clients open sessions with the active MDS (mon FSMap + beacons,
    standby failover), mutations journal before they apply (replayed at
    takeover), and capabilities arbitrate file access with revoke
    round-trips. Data IO bypasses the MDS entirely.
  * `fs.FileSystem` — the direct library (no daemon), sharing the same
    on-RADOS layout; the MDS serialization job is done by cls methods
    running at each directory object's primary OSD:

  * every directory is a RADOS object ("dir.<ino>") whose entry map is
    mutated only by the `fs_dir` object class (link/unlink are
    atomic-per-directory, like an MDS dirfrag update);
  * inode numbers come from an `fs_ino` allocator class on a table object
    (the inotable's role);
  * file content is striped over data objects via RadosStriper
    ("ino.<n>" + striper header), the same file->objects layout idea as
    the reference's file_layout_t.

`FileSystem` walks paths from the root inode and exposes
mkdir/listdir/create/write/read/unlink/rmdir/rename/stat.
"""

from ceph_tpu_torch.cephfs.client import CephFSClient, CephFSError
from ceph_tpu_torch.cephfs.fs import FileSystem, FsError
from ceph_tpu_torch.cephfs.mds import MDSService

__all__ = [
    "CephFSClient", "CephFSError", "FileSystem", "FsError",
    "MDSService",
]
