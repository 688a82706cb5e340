"""Cluster authentication + secure wire mode.

Analog of src/auth/ (cephx) + ProtocolV2's secure mode
(src/msg/async/ProtocolV2.cc auth frames, crypto_onwire.cc AES-GCM):

* a shared cluster secret (the keyring role) gates every connection:
  after the banner/ident exchange both sides run a mutual
  challenge-response proving possession of the key (HMAC-SHA256 over
  fresh nonces — the role cephx's ticket/authorizer exchange plays;
  the mon-issued-ticket indirection is collapsed onto the shared key,
  like a cluster where every daemon holds the same keyring);
* a per-connection session key is derived from the key + both nonces
  (CephXTicketHandler session_key role), never reused across
  transports;
* optional secure mode encrypts every frame payload with an
  encrypt-then-MAC AEAD built from keyed BLAKE2b (keystream = keyed
  hash of a per-direction counter; MAC over header data + ciphertext).
  The reference uses AES-GCM; this image has no AES primitive, so the
  AEAD is an HMAC-style PRF construction with the same interface and
  guarantees (confidentiality + integrity + per-frame nonces), which
  is the honest equivalent rather than a hand-rolled block cipher.

`AuthContext.from_conf` reads:
    auth_cluster_required = "none" | "shared"   (cephx on/off)
    auth_key              = hex/utf8 shared secret
    ms_secure_mode        = 0 (crc) | 1 (encrypted frames)
A "none" context disables everything (DummyAuth).
"""

from __future__ import annotations

import hashlib
import hmac
import os


class AuthError(Exception):
    pass


def _hmac(key: bytes, *parts: bytes) -> bytes:
    h = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        h.update(len(p).to_bytes(4, "big"))
        h.update(p)
    return h.digest()


class AuthContext:
    """Immutable auth configuration shared by a daemon's messenger."""

    __slots__ = ("mode", "key", "secure")

    def __init__(self, mode: str = "none", key: bytes = b"",
                 secure: bool = False):
        self.mode = mode
        self.key = key
        self.secure = secure and mode != "none"

    @classmethod
    def from_conf(cls, conf) -> "AuthContext | None":
        try:
            mode = conf["auth_cluster_required"]
            key = conf["auth_key"]
            secure = bool(conf["ms_secure_mode"])
        except Exception:
            return None
        if mode == "none" or not key:
            return None
        return cls(mode, key.encode(), secure)

    # -- handshake ---------------------------------------------------------

    def client_hello(self) -> tuple[bytes, dict]:
        nc = os.urandom(16)
        return nc, {"nonce": nc.hex()}

    def server_challenge(self, hello: dict, bind: bytes = b"") \
            -> tuple[bytes, bytes, dict]:
        """``bind`` is transcript material (the pre-auth ident blobs):
        mixing it into the proofs makes the unauthenticated part of the
        handshake tamper-evident — a MITM that rewrites an ident (e.g.
        to forge a session ack) breaks both proofs even though it
        relays the auth frames untouched."""
        nc = bytes.fromhex(hello["nonce"])
        ns = os.urandom(16)
        proof = _hmac(self.key, b"srv", nc, ns, bind)
        return nc, ns, {"nonce": ns.hex(), "proof": proof.hex()}

    def client_verify(self, nc: bytes, reply: dict,
                      bind: bytes = b"") -> tuple[bytes, dict]:
        ns = bytes.fromhex(reply["nonce"])
        want = _hmac(self.key, b"srv", nc, ns, bind)
        if not hmac.compare_digest(want,
                                   bytes.fromhex(reply["proof"])):
            raise AuthError("server failed key proof")
        proof = _hmac(self.key, b"cli", nc, ns, bind)
        return ns, {"proof": proof.hex()}

    def server_verify(self, nc: bytes, ns: bytes, reply: dict,
                      bind: bytes = b"") -> None:
        want = _hmac(self.key, b"cli", nc, ns, bind)
        if not hmac.compare_digest(want,
                                   bytes.fromhex(reply["proof"])):
            raise AuthError("client failed key proof")

    def session_key(self, nc: bytes, ns: bytes) -> bytes:
        return _hmac(self.key, b"session", nc, ns)


_BLOCK = 64          # blake2b digest size = keystream block


def _xor(a: bytes, b: bytes) -> bytes:
    # bigint XOR: C-speed for multi-MB frames (a bytewise generator is
    # ~100x slower)
    n = len(a)
    return (int.from_bytes(a, "little")
            ^ int.from_bytes(b, "little")).to_bytes(n, "little") \
        if n else b""


class SecureFramer:
    """Per-connection AEAD (crypto_onwire.cc role).

    Directional: the connection initiator seals with the "a" label and
    opens with "b"; the acceptor mirrors.  Each direction keeps its own
    frame counter (the AEAD nonce), so reordering/replay within a
    transport fails the MAC; a reconnect re-derives fresh session keys
    so counters never repeat under one key.
    """

    __slots__ = ("_tx", "_rx", "_txn", "_rxn")

    def __init__(self, session_key: bytes, initiator: bool):
        a = _hmac(session_key, b"dir-a")
        b = _hmac(session_key, b"dir-b")
        self._tx, self._rx = (a, b) if initiator else (b, a)
        self._txn = 0
        self._rxn = 0

    @staticmethod
    def _stream(key: bytes, nonce: int, n: int) -> bytes:
        out = bytearray()
        ctr = 0
        base = nonce.to_bytes(8, "big")
        while len(out) < n:
            out += hashlib.blake2b(
                base + ctr.to_bytes(8, "big"), key=key,
                digest_size=_BLOCK).digest()
            ctr += 1
        return bytes(out[:n])

    def seal(self, payload: bytes, aad: bytes = b"") -> bytes:
        """``aad`` is authenticated-but-unencrypted associated data —
        the messenger passes the frame tag so an on-path attacker
        cannot relabel a frame (e.g. flip it to TAG_CLOSE to fake a
        graceful shutdown) without failing the MAC."""
        n = self._txn
        self._txn += 1
        ks = self._stream(self._tx, n, len(payload))
        ct = _xor(payload, ks)
        mac = hashlib.blake2b(
            n.to_bytes(8, "big")
            + len(aad).to_bytes(4, "big") + aad + ct,
            key=self._tx, digest_size=16).digest()
        return ct + mac

    def open(self, blob: bytes, aad: bytes = b"") -> bytes:
        if len(blob) < 16:
            raise AuthError("short secure frame")
        n = self._rxn
        self._rxn += 1
        ct, mac = blob[:-16], blob[-16:]
        want = hashlib.blake2b(
            n.to_bytes(8, "big")
            + len(aad).to_bytes(4, "big") + aad + ct,
            key=self._rx, digest_size=16).digest()
        if not hmac.compare_digest(mac, want):
            raise AuthError("secure frame MAC mismatch")
        ks = self._stream(self._rx, n, len(ct))
        return _xor(ct, ks)
