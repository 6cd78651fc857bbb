"""cephx-style authentication: tickets, rotating service keys,
authorizers (src/auth/cephx role)."""

from ceph_tpu_torch.auth.cephx import (
    make_ticket,
    open_ticket,
    seal,
    unseal,
)

__all__ = ["make_ticket", "open_ticket", "seal", "unseal"]
