"""rbd: block images over RADOS objects (L9, librbd-lite).

The reference's librbd (src/librbd, 73k LoC) presents a virtual block
device as a sequence of 2^order-byte RADOS objects named
rbd_data.<id>.<objectno>, with a header object for metadata and an object
map tracking which objects exist. The mini equivalent here keeps that
layout: `Image` slices byte extents onto data objects (Striper-style
offset algebra), reads absent objects as zeros (sparse semantics — the
object map role is played by ENOENT), and does client-side
read-modify-write for partial-object updates since the mini OSD op set is
whole-object. Works unchanged on replicated and EC pools — EC images get
object shards encoded on the card by their primary OSD's EncodeService.
"""

from ceph_tpu_torch.rbd.image import Image, ImageNotFound

__all__ = ["Image", "ImageNotFound"]
