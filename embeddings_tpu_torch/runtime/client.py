"""Clients for the embedding service — the port of
``embeddings_tpu/runtime/client.py`` (standard library and numpy only).

``TcpClient`` speaks the reference's protocol (examples/sample_client.py):
int32 n_embd greeting, then one raw text send per recv of n_embd float32s
(``framing="v1"``), or length-prefixed frames (``framing="v2"``).
``HttpClient`` talks to the JSON endpoint with urllib.
"""

from __future__ import annotations

import json
import socket
import struct
import urllib.request

import numpy as np


class TcpClient:
    """framing="v1" = raw reference protocol (one send per message);
    framing="v2" = length-prefixed frames (robust to TCP fragmentation and
    messages of any size), opted into by sending ``ETF2`` after the
    greeting (the server's ``_serve_v2``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 30.0, framing: str = "v1"):
        if framing not in ("v1", "v2"):
            raise ValueError(f"framing must be v1|v2, got {framing!r}")
        self.framing = framing
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.n_embd = struct.unpack("<i", self._recv_exact(4))[0]
        # v2: the magic goes out with the first frame, not at connect
        self._v2_greeting = b"ETF2" if framing == "v2" else b""

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def embed(self, text: str) -> np.ndarray:
        payload = text.encode("utf-8")
        if self.framing == "v2":
            self.sock.sendall(self._v2_greeting
                              + struct.pack("<I", len(payload)) + payload)
            self._v2_greeting = b""
        else:
            self.sock.sendall(payload)
        data = self._recv_exact(self.n_embd * 4)
        return np.frombuffer(data, np.float32).copy()

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HttpClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8081",
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def embed(self, texts: str | list[str]) -> np.ndarray:
        single = isinstance(texts, str)
        payload = json.dumps({"texts": [texts] if single else texts}).encode()
        req = urllib.request.Request(
            self.base_url + "/embed", data=payload,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = json.loads(resp.read())
        out = np.asarray(body["embeddings"], np.float32)
        return out[0] if single else out

    def healthz(self) -> dict:
        with urllib.request.urlopen(self.base_url + "/healthz",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())
