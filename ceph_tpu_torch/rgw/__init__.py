"""rgw: the object-storage gateway (L9, rgw-lite).

The reference's RGW (src/rgw, ~150k LoC) serves S3/Swift on top of RADOS;
its load-bearing storage idea is the bucket index: a RADOS object whose
omap, updated by cls methods INSIDE the OSD (src/cls/rgw/cls_rgw.cc), maps
object keys to metadata — so index updates are atomic with respect to
concurrent writers and listing is a server-side range scan, not a pool
enumeration.

The mini gateway keeps exactly that shape: `ObjectGateway` stores object
data as RADOS objects and maintains a per-bucket index through a registered
`rgw_index` object class (insert/remove/list with marker pagination), with
ETags (crc32c of content, hex) computed at put. Two HTTP frontends serve
the SAME gateway, like the reference: `rest.S3Frontend` (SigV4 in all
three spec flavors, ACLs, versioning, multipart, lifecycle) and
`swift.SwiftFrontend` (TempAuth + containers/objects) — an object PUT
through one dialect reads back byte-identical through the other.

Port of the reference package's `rgw`: the same index rows, version
stacks, multipart rows, XML envelopes and ETags, byte for byte. The
gateway computes on the host; its data writes reach the primary OSDs,
whose `EncodeService` encodes them on the OSD's device.
"""

from ceph_tpu_torch.rgw.gateway import ObjectGateway, register_rgw_classes
from ceph_tpu_torch.rgw.rest import S3Frontend
from ceph_tpu_torch.rgw.swift import SwiftFrontend

__all__ = [
    "ObjectGateway", "S3Frontend", "SwiftFrontend",
    "register_rgw_classes",
]
