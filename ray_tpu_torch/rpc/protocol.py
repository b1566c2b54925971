"""Wire-protocol versioning (reference: the 37 pinned proto files under
``src/ray/protobuf/`` — protobuf gives the reference field-number-stable
evolution; our framed-pickle envelopes get the equivalent guarantees from
an explicit protocol version, a connection handshake, and per-field
``since`` annotations in :mod:`ray_tpu_torch.rpc.schema`).

Wire format (one TCP connection, many concurrent requests):

    frame   := header payload
    header  := <u32 little-endian payload length> <u8 frame type>
    payload := pickled dict

Frame types:

    1  REQ    {"id": int, "method": str, "kwargs": dict, "v": int}
    2  RESP   {"id": int, "result": ...} | {"id", "error": (kind, c, tb)}
    3  HELLO  client->server {"protocol": int, "min_protocol": int,
                              "schema": int}
              server->client {"protocol": int, "min_protocol": int,
                              "schema": int} |
                             {"error": str}  (then the server closes)

Negotiation: the client's FIRST frame on a connection is HELLO; the
server answers with its own versions and both sides speak
``min(client.protocol, server.protocol)`` from then on. A peer whose
protocol falls below the other's ``min_protocol`` is rejected loudly at
connect time instead of failing obscurely mid-call. A connection whose
first frame is a REQ (no HELLO) is served as protocol 1 — the rolling-
upgrade path for peers predating the handshake.

Version history (append-only; never renumber):

    1  round 2-3 implicit contract: REQ/RESP framed pickle, no "v" stamp
    2  round 4: HELLO handshake, "v" stamp on REQ, Field.since gating

Native codecs version independently: fastspec TaskSpec blobs are
self-describing via their ``RTFS`` magic (rpc/native/fastspec.c); a
layout change must introduce a new magic, not mutate the old one.
"""

from __future__ import annotations

# The version this build SPEAKS.
PROTOCOL_VERSION = 2
# The oldest peer this build still accepts (raise to drop legacy paths).
MIN_SUPPORTED_PROTOCOL = 1


class ProtocolError(Exception):
    """Version negotiation failed (incompatible peer)."""


def negotiate(peer_protocol: int, peer_min: int) -> int:
    """Return the protocol version to speak with a peer, or raise.

    Symmetric: both sides run this on the other's (protocol, min) and
    arrive at the same answer."""
    if peer_protocol < MIN_SUPPORTED_PROTOCOL:
        raise ProtocolError(
            f"peer speaks protocol {peer_protocol}, below this build's "
            f"minimum {MIN_SUPPORTED_PROTOCOL}")
    if PROTOCOL_VERSION < peer_min:
        raise ProtocolError(
            f"this build speaks protocol {PROTOCOL_VERSION}, below the "
            f"peer's minimum {peer_min}")
    return min(PROTOCOL_VERSION, peer_protocol)
