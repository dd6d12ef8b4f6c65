"""The Fiat-Shamir transcript of the Spartan argument, in Python over
``hashlib.blake2s``, and the wire encodings it absorbs.

    state <- blake2s(b"")                   at the start
    state <- blake2s(state || bytes)        on absorb(bytes); the stream restarts
    block_k = blake2s(state || LE64(k))     output stream, k = 0, 1, 2, ...

A challenge in Fr is arkworks' ``UniformRand``: 32 bytes of the stream as a
little-endian integer, the top bit cleared, redrawn while it is not below r.
"""

from __future__ import annotations

import hashlib
import struct

from portbench.reference.curve import R

_MASK255 = (1 << 255) - 1


def u64(x: int) -> bytes:
    return struct.pack("<Q", x)


def fr_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def fr_vec_bytes(xs) -> bytes:
    return u64(len(xs)) + b"".join(fr_bytes(x) for x in xs)


def matrix_bytes(rows, num_constraints: int) -> bytes:
    """Vec<Vec<(Fr, usize)>> as rows of (coeff, column), then the number of
    constraints as a u64."""
    cache = {}
    out = [u64(len(rows))]
    for row in rows:
        out.append(u64(len(row)))
        for coeff, col in row:
            key = (coeff, col)
            b = cache.get(key)
            if b is None:
                b = cache[key] = fr_bytes(coeff) + u64(col)
            out.append(b)
    out.append(u64(num_constraints))
    return b"".join(out)


class Transcript:
    def __init__(self, state: bytes = None):
        self.state = hashlib.blake2s(b"").digest() if state is None else state
        self._counter = 0
        self._buf = b""

    def absorb(self, data: bytes) -> None:
        self.state = hashlib.blake2s(self.state + data).digest()
        self._counter = 0
        self._buf = b""

    def _bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += hashlib.blake2s(self.state + u64(self._counter)).digest()
            self._counter += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def challenge(self) -> int:
        while True:
            x = int.from_bytes(self._bytes(32), "little") & _MASK255
            if x < R:
                return x

    def challenges(self, n: int):
        return [self.challenge() for _ in range(n)]
