"""msg: the wire-transport layer (L1).

The reference's Messenger stack (src/msg: Messenger::create at
Messenger.h:149, AsyncMessenger epoll loops, ProtocolV2 framing) carries
every daemon-to-daemon and client-to-daemon message. Here the same contracts
ride asyncio TCP on the host: deterministic crc-protected framing
(frames.py), an entity-addressed Messenger with Dispatcher fast-dispatch,
per-connection Policy (lossy client vs stateful lossless server) with
seq/ack resend, cephx-style HMAC session auth + message signing, throttle
backpressure, and config-driven fault injection (ms_inject_socket_failures,
options.cc:1044-1066).

Shard math does NOT go through this layer: it runs on the codec's device
(ec, ops); the messenger is the host control/data plane the reference's L1
provides — placement, sub-ops, maps, heartbeats.
"""

from ceph_tpu_torch.msg.frames import (
    Frame,
    FrameError,
    Message,
    Tag,
    payload_of,
    redirect_reply,
)
from ceph_tpu_torch.msg.messenger import (
    AsyncThrottle,
    Connection,
    Dispatcher,
    Messenger,
    Policy,
)

__all__ = [
    "AsyncThrottle",
    "Connection",
    "Dispatcher",
    "Frame",
    "FrameError",
    "Message",
    "Messenger",
    "Policy",
    "Tag",
    "payload_of",
    "redirect_reply",
]
