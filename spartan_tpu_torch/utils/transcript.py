"""Fiat-Shamir transcript RNG (Blake2s, feedable), the port's copy of
``spartan_tpu/utils/transcript.py``.

  state <- blake2s(b"")                      at setup()
  state <- blake2s(state || bytes)           on feed(bytes); resets the counter
  block_k = blake2s(state || LE64(k))        output stream, k = 0, 1, 2, ...

Fr sampling is arkworks' ``UniformRand``: four LE u64 limbs, the top bit
masked to the 255-bit width, rejected and redrawn if >= r.

``get_state``/``set_state`` hand the chain state to the device-resident
transcript (``protocol/fused.py``) and take it back after a sumcheck phase,
and start a prove's transcript from the chain state after the matrices,
which the index keeps (``protocol/indexer.py``).

Every ``feed`` adds one to ``kernels.LANES[FS_ABSORB][(len(data),)]``, on
the native and the Python stream alike, so a traced run can tell how many
bytes the host transcript absorbed, and that no matrix was among them.
"""

from __future__ import annotations

import hashlib

from spartan_tpu_torch import kernels
from spartan_tpu_torch.host import field as hf

_FR_SHAVE_MASK = (1 << 255) - 1
FS_ABSORB = "fs_absorb"  # the counter of host feeds in kernels.LANES, keyed by (bytes,)


def _blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


class Blake2sRng:
    """Feedable Fiat-Shamir RNG on the host: the native stream where the host
    library is built (absorbing the serialized matrices, once an index, is
    O(nnz) bytes), else the same stream in Python."""

    def __init__(self):
        from spartan_tpu_torch.host import native

        lib = native.load()
        self._native = None if lib is None else native.NativeFsRng(lib)
        self._state = _blake2s(b"")
        self._counter = 0
        self._buffer = b""

    @classmethod
    def setup(cls) -> "Blake2sRng":
        return cls()

    def feed(self, data: bytes) -> None:
        """Absorb serialized bytes; counted under FS_ABSORB."""
        kernels.LANES[FS_ABSORB][(len(data),)] += 1
        if self._native is not None:
            self._native.feed(data)
            return
        self._state = _blake2s(self._state + data)
        self._counter = 0
        self._buffer = b""

    def get_state(self) -> bytes:
        """The 32-byte chain state. Only meaningful at a feed boundary (no
        output block partly consumed), the one place the prover hands the
        transcript to the device."""
        if self._native is not None:
            return self._native.get_state()
        return self._state

    def set_state(self, state: bytes) -> None:
        """Resume from a chain state the device advanced; resets the stream."""
        if len(state) != 32:
            raise ValueError(f"chain state is 32 bytes, got {len(state)}")
        if self._native is not None:
            self._native.set_state(state)
            return
        self._state = bytes(state)
        self._counter = 0
        self._buffer = b""

    def next_bytes(self, n: int) -> bytes:
        if self._native is not None:
            return self._native.next_bytes(n)
        while len(self._buffer) < n:
            self._buffer += _blake2s(self._state + self._counter.to_bytes(8, "little"))
            self._counter += 1
        out, self._buffer = self._buffer[:n], self._buffer[n:]
        return out

    def sample_fr(self) -> int:
        """arkworks-style rejection sampling of a uniform Fr element."""
        while True:
            val = int.from_bytes(self.next_bytes(32), "little") & _FR_SHAVE_MASK
            if val < hf.R:
                return val

    def sample_fr_vec(self, n: int):
        return [self.sample_fr() for _ in range(n)]
