"""Minimal RFC 6455 WebSocket codec: server-side upgrade + both-side frame
I/O + a blocking client.

Role parity with the reference's socket.io transport
(`drivers/driver-base/src/documentDeltaConnection.ts`, alfred `io.ts`):
the live delta stream between clients and the front door rides websockets.
The reference pulls in socket.io/engine.io; here the framing layer is
~200 lines of stdlib because the delta protocol (JSON text frames, see
`server/alfred.py`) needs nothing beyond text messages + clean close.

Not implemented (not needed for the delta protocol): extensions
(permessage-deflate), subprotocol negotiation, fragmented continuation
frames spanning >2**63 bytes.

A port of fluidframework_tpu's server/websocket.py (standard library
only). The frames are the reference's byte for byte, so a client of
either package speaks to a server of either.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
from typing import Optional, Tuple

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketClosed(Exception):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WebSocketClosed("socket closed mid-frame")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Tuple[int, bytes]:
    """Read one frame; returns (opcode, payload). Handles masked payloads
    and 16/64-bit extended lengths. Fragmented messages are reassembled by
    WebSocketConnection.recv()."""
    header = _recv_exact(sock, 2)
    fin_op, mask_len = header[0], header[1]
    opcode = fin_op & 0x0F
    fin = bool(fin_op & 0x80)
    masked = bool(mask_len & 0x80)
    length = mask_len & 0x7F
    if length == 126:
        length = struct.unpack(">H", _recv_exact(sock, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    mask = _recv_exact(sock, 4) if masked else None
    payload = _recv_exact(sock, length) if length else b""
    if mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    # Encode fin in bit 4 of the returned opcode for the reassembly loop.
    return (opcode | (0x10 if fin else 0)), payload


def write_frame(sock: socket.socket, opcode: int, payload: bytes,
                mask: bool) -> None:
    header = bytearray([0x80 | opcode])
    length = len(payload)
    mask_bit = 0x80 if mask else 0
    if length < 126:
        header.append(mask_bit | length)
    elif length < (1 << 16):
        header.append(mask_bit | 126)
        header += struct.pack(">H", length)
    else:
        header.append(mask_bit | 127)
        header += struct.pack(">Q", length)
    if mask:
        key = os.urandom(4)
        header += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    sock.sendall(bytes(header) + payload)


class WebSocketConnection:
    """Framed text-message channel over an already-upgraded socket.
    Thread-safe sends (one writer lock); single reader expected."""

    def __init__(self, sock: socket.socket, is_client: bool):
        self.sock = sock
        self.is_client = is_client  # clients mask outgoing frames
        self._send_lock = threading.Lock()
        self._closed = False

    def send_text(self, text: str) -> None:
        if self._closed:
            raise WebSocketClosed("connection closed")
        with self._send_lock:
            write_frame(self.sock, OP_TEXT, text.encode(), self.is_client)

    def recv(self) -> str:
        """Block until a full text message arrives. Transparently answers
        pings; raises WebSocketClosed on close frame or dead socket."""
        fragments = []
        while True:
            try:
                op_fin, payload = read_frame(self.sock)
            except (OSError, WebSocketClosed):
                self._closed = True
                raise WebSocketClosed("connection closed")
            opcode, fin = op_fin & 0x0F, bool(op_fin & 0x10)
            if opcode == OP_CLOSE:
                self.close(reply=True)
                raise WebSocketClosed("close frame received")
            if opcode == OP_PING:
                with self._send_lock:
                    write_frame(self.sock, OP_PONG, payload, self.is_client)
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_BINARY, OP_CONT):
                fragments.append(payload)
                if fin:
                    return b"".join(fragments).decode()

    def close(self, reply: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            with self._send_lock:
                write_frame(self.sock, OP_CLOSE, b"", self.is_client)
        except OSError:
            pass
        if not reply:
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.sock.close()

    @property
    def closed(self) -> bool:
        return self._closed


def upgrade_server_socket(sock: socket.socket,
                          client_key: str) -> WebSocketConnection:
    """Complete the server side of the upgrade handshake. The HTTP request
    line/headers were already consumed by the HTTP server; this writes the
    101 response and hands back a framed connection."""
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(client_key)}\r\n"
        "\r\n"
    )
    sock.sendall(response.encode())
    return WebSocketConnection(sock, is_client=False)


def connect(host: str, port: int, path: str = "/",
            timeout: Optional[float] = None) -> WebSocketConnection:
    """Blocking client: TCP connect + upgrade handshake."""
    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    request = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n"
        "\r\n"
    )
    sock.sendall(request.encode())
    # Read the 101 response headers.
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketClosed("handshake failed: socket closed")
        buf += chunk
    status_line = buf.split(b"\r\n", 1)[0].decode()
    if " 101 " not in status_line + " ":
        raise WebSocketClosed(f"handshake rejected: {status_line}")
    headers = {}
    for line in buf.split(b"\r\n\r\n", 1)[0].split(b"\r\n")[1:]:
        name, _, value = line.decode().partition(":")
        headers[name.strip().lower()] = value.strip()
    if headers.get("sec-websocket-accept") != accept_key(key):
        raise WebSocketClosed("handshake failed: bad accept key")
    return WebSocketConnection(sock, is_client=True)
