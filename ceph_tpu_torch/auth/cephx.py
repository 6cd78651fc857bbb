"""Mini-cephx: sealed tickets + rotating service keys.

Re-expresses the cephx protocol shapes (src/auth/cephx/CephxProtocol.h):

  * The AUTH server (the mon's AuthMonitor) holds the entity key
    database and per-service ROTATING keys (epoch -> secret, the
    RotatingSecrets role). Daemons hold the current rotating window,
    never client keys.
  * A client authenticates to the mon with its own entity key (the
    messenger's mutual challenge/proof) and receives a TICKET: a blob
    sealed under the service's rotating key — opaque to the client —
    carrying {entity, session key, expiry, key epoch}, plus the session
    key sealed under the CLIENT's key so only it can extract it
    (CephXTicketBlob + the msg_a/msg_b split of CephXServiceTicketInfo).
  * Connecting to a daemon, the client presents the ticket + proves
    possession of the session key (the authorizer); the daemon unseals
    the ticket with its rotating window — accepting the previous epoch
    during rotation — and never needs to know the client at all.

Sealing is encrypt-then-MAC over an HMAC-SHA256 keystream (the standard
construction; the reference uses AES — same contract, pure-stdlib
primitives here): random IV, ct = payload XOR HMAC(key, iv||counter)
blocks, tag = HMAC(key, "mac"||iv||ct). Tampering or a wrong epoch key
fails closed (None), never partially decodes.
"""

from __future__ import annotations

import hashlib
import hmac
import os

from ceph_tpu_torch.common.encoding import DecodeError, Decoder, Encoder


def _stream(key: bytes, iv: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(
            key, b"enc" + iv + counter.to_bytes(8, "big"),
            hashlib.sha256,
        ).digest()
        counter += 1
    return bytes(out[:n])


def seal(key: bytes, payload: bytes) -> bytes:
    """Encrypt-then-MAC under `key`."""
    iv = os.urandom(16)
    ct = bytes(
        a ^ b for a, b in zip(payload, _stream(key, iv, len(payload)))
    )
    tag = hmac.new(key, b"mac" + iv + ct, hashlib.sha256).digest()
    return Encoder().blob(iv).blob(ct).blob(tag).bytes()


def unseal(key: bytes, blob: bytes) -> bytes | None:
    """Inverse of seal; None on any tamper/wrong-key evidence."""
    try:
        d = Decoder(blob)
        iv, ct, tag = d.blob(), d.blob(), d.blob()
    except DecodeError:
        return None
    want = hmac.new(key, b"mac" + iv + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        return None
    return bytes(
        a ^ b for a, b in zip(ct, _stream(key, iv, len(ct)))
    )


def make_ticket(
    service_key: bytes, epoch: int, entity: str,
    session_key: bytes, expires: float,
) -> bytes:
    """A service ticket: epoch in the clear (the daemon's key selector,
    CephXTicketBlob::secret_id), everything else sealed."""
    payload = (
        Encoder()
        .string(entity)
        .blob(session_key)
        .f64(expires)
        .bytes()
    )
    return (
        Encoder().u32(epoch).blob(seal(service_key, payload)).bytes()
    )


def open_ticket(
    service_keys: dict[int, bytes], blob: bytes, now: float
) -> tuple[str, bytes] | None:
    """(entity, session_key) from a ticket, or None (unknown epoch,
    tampered, or expired)."""
    try:
        d = Decoder(blob)
        epoch = d.u32()
        sealed = d.blob()
    except DecodeError:
        return None
    key = service_keys.get(epoch)
    if key is None:
        return None
    payload = unseal(key, sealed)
    if payload is None:
        return None
    try:
        d = Decoder(payload)
        entity = d.string()
        session_key = d.blob()
        expires = d.f64()
    except DecodeError:
        return None
    if now > expires:
        return None
    return entity, session_key
