"""Client for the embedding service's TCP front-end — the port of
``embeddings_tpu/runtime/client.py:TcpClient`` (v1 framing): int32 n_embd
greeting, then one raw text send per recv of n_embd float32s."""

from __future__ import annotations

import socket
import struct

import numpy as np


class TcpClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.n_embd = struct.unpack("<i", self._recv_exact(4))[0]

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def embed(self, text: str) -> np.ndarray:
        self.sock.sendall(text.encode("utf-8"))
        data = self._recv_exact(self.n_embd * 4)
        return np.frombuffer(data, np.float32).copy()

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
