"""Dependency-free minimal Kafka producer (wire protocol v0).

The port's copy of the JAX package's ``utils/kafka.py`` (the reference
streams request logs into Kafka: kafka/kafka.json:1-30).  No Kafka
client package is needed: the producer speaks the wire protocol itself,
Metadata (api_key 3, v0) to find the partition leader and Produce
(api_key 0, v0, acks=1) with CRC'd v0 message sets, so it works against
any broker that serves the v0 APIs and against a fake broker that checks
the frames byte by byte.

Scope: a producer for the request-logging lane, one request in flight a
connection, acks=1, no compression, no idempotence.
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple


def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    """Cursor over a response payload (big-endian, Kafka framing)."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def i8(self) -> int:
        (v,) = struct.unpack_from(">b", self.data, self.off)
        self.off += 1
        return v

    def i16(self) -> int:
        (v,) = struct.unpack_from(">h", self.data, self.off)
        self.off += 2
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.data, self.off)
        self.off += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.data, self.off)
        self.off += 8
        return v

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        v = self.data[self.off:self.off + n].decode()
        self.off += n
        return v


def encode_message_set(key: Optional[bytes], value: bytes) -> bytes:
    """One v0 message in a message set: offset(-1 on produce) + size +
    (crc, magic=0, attributes=0, key, value); crc32 covers magic..value
    — the field a broker verifies, so a wrong pair encoding cannot pass
    the contract test silently."""
    body = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
    return struct.pack(">q", 0) + struct.pack(">i", len(msg)) + msg


def decode_message_set(data: bytes) -> List[Tuple[Optional[bytes], bytes]]:
    """Inverse of :func:`encode_message_set` (used by the fake broker
    and anyone replaying recorded frames); verifies each CRC."""
    out = []
    off = 0
    while off + 12 <= len(data):
        (_offset, size) = struct.unpack_from(">qi", data, off)
        off += 12
        msg = data[off:off + size]
        off += size
        (crc,) = struct.unpack_from(">I", msg, 0)
        body = msg[4:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("message CRC mismatch")
        r = _Reader(body)
        magic, _attrs = r.i8(), r.i8()
        if magic != 0:
            raise ValueError(f"unsupported message magic {magic}")
        klen = r.i32()
        key = None
        if klen >= 0:
            key = r.data[r.off:r.off + klen]
            r.off += klen
        vlen = r.i32()
        value = r.data[r.off:r.off + vlen]
        out.append((key, value))
    return out


class MiniKafkaProducer:
    """Blocking acks=1 producer, one connection per partition leader.

    ``send()`` is thread-safe (one lock, one in-flight request per
    call — the request-logging lane runs it on a background drain
    thread, so the data plane never blocks on it).  A transport error
    drops the affected connection AND the metadata cache, so the next
    send reconnects and re-discovers leaders (a broker restart must
    not permanently kill the logging lane).
    """

    def __init__(self, bootstrap_servers: str, client_id: str = "seldon-tpu",
                 timeout_s: float = 5.0):
        # standard comma-separated bootstrap list: "b1:9092,b2:9092"
        self.bootstrap: List[Tuple[str, int]] = []
        for entry in bootstrap_servers.split(","):
            entry = entry.strip()
            if not entry:
                continue
            host, _, port = entry.partition(":")
            self.bootstrap.append((host, int(port or 9092)))
        if not self.bootstrap:
            raise ValueError(f"empty bootstrap list {bootstrap_servers!r}")
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._corr = 0
        self._lock = threading.Lock()
        # topic -> {partition id: (leader host, leader port)}
        self._meta: Dict[str, Dict[int, Tuple[str, int]]] = {}
        self._rr = 0

    # ------------------------------------------------------------ transport

    def _connect(self, addr) -> socket.socket:
        s = socket.create_connection(addr, timeout=self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _drop(self, addr) -> None:
        """Forget a connection (and leaders learned through it): after
        a send/recv fault the stream may hold stale response bytes, so
        reuse would fail every later request with a correlation
        mismatch."""
        sock = self._conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._meta.clear()

    def _request(self, addr: Tuple[str, int], api_key: int, body: bytes) -> _Reader:
        """One framed request/response round-trip (v0 header) on the
        connection to ``addr``."""
        sock = self._conns.get(addr)
        if sock is None:
            sock = self._connect(addr)
            self._conns[addr] = sock
        self._corr += 1
        corr_sent = self._corr
        header = struct.pack(">hhi", api_key, 0, corr_sent) + _str(self.client_id)
        frame = header + body
        try:
            sock.sendall(struct.pack(">i", len(frame)) + frame)
            raw = b""
            while len(raw) < 4:
                chunk = sock.recv(4 - len(raw))
                if not chunk:
                    raise ConnectionError("broker closed during response length")
                raw += chunk
            (size,) = struct.unpack(">i", raw)
            payload = b""
            while len(payload) < size:
                chunk = sock.recv(size - len(payload))
                if not chunk:
                    raise ConnectionError("broker closed mid-response")
                payload += chunk
        except (OSError, ConnectionError):
            self._drop(addr)
            raise
        r = _Reader(payload)
        corr = r.i32()
        if corr != corr_sent:
            self._drop(addr)
            raise ConnectionError(f"correlation mismatch {corr} != {corr_sent}")
        return r

    def _any_request(self, api_key: int, body: bytes) -> _Reader:
        """Try each bootstrap broker in order until one answers."""
        last: Optional[Exception] = None
        for addr in self.bootstrap:
            try:
                return self._request(addr, api_key, body)
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(f"no bootstrap broker reachable: {last}")

    # ------------------------------------------------------------- metadata

    def _metadata(self, topic: str) -> Dict[int, Tuple[str, int]]:
        cached = self._meta.get(topic)
        if cached is not None:
            return cached
        r = self._any_request(3, struct.pack(">i", 1) + _str(topic))
        brokers = {}
        for _ in range(r.i32()):
            node, host, port = r.i32(), r.string(), r.i32()
            brokers[node] = (host, port)
        leaders: Dict[int, Tuple[str, int]] = {}
        for _ in range(r.i32()):
            t_err, t_name = r.i16(), r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                p_err, p_id, leader = r.i16(), r.i32(), r.i32()
                for _ in range(r.i32()):  # replicas
                    r.i32()
                for _ in range(r.i32()):  # isr
                    r.i32()
                if t_name == topic and p_err == 0 and leader in brokers:
                    leaders[p_id] = brokers[leader]
            if t_name == topic and t_err != 0:
                raise ConnectionError(f"metadata error {t_err} for topic {topic!r}")
        if not leaders:
            raise ConnectionError(f"no leader for topic {topic!r}")
        self._meta[topic] = leaders
        return leaders

    # -------------------------------------------------------------- produce

    def send(self, topic: str, value: bytes, key: Optional[bytes] = None) -> int:
        """Produce one message (acks=1) to its partition's leader;
        returns the assigned offset."""
        with self._lock:
            leaders = self._metadata(topic)
            partitions = sorted(leaders)
            if key is not None:
                partition = partitions[zlib.crc32(key) % len(partitions)]
            else:
                partition = partitions[self._rr % len(partitions)]
                self._rr += 1
            mset = encode_message_set(key, value)
            body = (
                struct.pack(">hi", 1, int(self.timeout_s * 1000))  # acks, timeout
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1) + struct.pack(">i", partition)
                + struct.pack(">i", len(mset)) + mset
            )
            r = self._request(leaders[partition], 0, body)
            for _ in range(r.i32()):
                t_name = r.string()
                for _ in range(r.i32()):
                    p_id, err, offset = r.i32(), r.i16(), r.i64()
                    if t_name == topic and p_id == partition:
                        if err != 0:
                            # leadership may have moved: re-discover on
                            # the next send rather than failing forever
                            self._meta.pop(topic, None)
                            raise ConnectionError(
                                f"produce error {err} on {topic}[{partition}]"
                            )
                        return offset
            raise ConnectionError("produce response missing our partition")

    def close(self) -> None:
        with self._lock:
            for sock in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
