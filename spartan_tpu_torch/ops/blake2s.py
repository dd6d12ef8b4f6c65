"""Blake2s-256 of word-aligned messages, for the device-resident transcript.

Counterpart of ``spartan_tpu/ops/blake2s.py`` (``blake2s_words`` :120).
Messages are 32-bit words, little-endian bytes within a word, held in
``int64`` tensors (torch.uint32 has no ``+`` or ``>>`` on every backend);
every transcript message of the protocol is word-aligned. The result equals
``hashlib.blake2s`` (digest 32 bytes, no key).

``blake2s_words`` is the plain PyTorch version: the tests and the CPU route
use it. On the card Blake2s runs only inside the sumcheck kernels'
transcript step (``csrc/blake2s.cuh``, called by ``csrc/fs.cuh``): one compression is
about 300 elementwise operations, which as PyTorch launches would cost more
host time than a whole sumcheck round. ``blake2s_batch`` hashes a batch of
messages in one launch of the kernel's Blake2s; only ``chip_smoke.py`` calls
it on the card, to hold the device Blake2s against ``hashlib``.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch import kernels

MASK32 = 0xFFFFFFFF
IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PARAM = 0x01010020  # digest length 32, fanout 1, depth 1: xored into h[0]
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _g(a, b, c, d, x, y):
    """The G mix on (4, ...) rows: four columns (or diagonals) at once."""
    a = (a + b + x) & MASK32
    d = _rotr(d ^ a, 16)
    c = (c + d) & MASK32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & MASK32
    d = _rotr(d ^ a, 8)
    c = (c + d) & MASK32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(h: torch.Tensor, m: torch.Tensor, t: int, last: bool) -> torch.Tensor:
    """One compression. h (8, ...), m (16, ...) words; t the byte count so
    far (messages below 4 GiB); ``last`` sets the final-block flag."""
    iv = torch.tensor(IV, dtype=torch.int64, device=h.device).reshape((8,) + (1,) * (h.dim() - 1))
    iv = iv.expand_as(h)
    lo = iv[4:].clone()
    lo[0] ^= t
    if last:
        lo[2] ^= MASK32
    a, b, c, d = h[0:4], h[4:8], iv[0:4], lo
    for s in SIGMA:
        ms = m[list(s)]
        a, b, c, d = _g(a, b, c, d, ms[0:8:2], ms[1:8:2])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)  # diagonals into columns
        a, b, c, d = _g(a, b, c, d, ms[8:16:2], ms[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def blake2s_words(msg: torch.Tensor) -> torch.Tensor:
    """Blake2s-256 of the word-aligned message ``msg`` (..., W): int64 words
    in [0, 2^32), byte length 4 W. Returns the (..., 8) digest words."""
    msg = msg.to(torch.int64)
    nwords = msg.shape[-1]
    m = msg.movedim(-1, 0)  # (W, ...)
    nblocks = max(1, (nwords + 15) // 16)
    pad = nblocks * 16 - nwords
    if pad:
        m = torch.cat([m, m.new_zeros((pad,) + m.shape[1:])])
    h = torch.tensor(IV, dtype=torch.int64, device=msg.device)
    h = h.reshape((8,) + (1,) * (m.dim() - 1)).expand((8,) + m.shape[1:]).clone()
    h[0] ^= PARAM
    for k in range(nblocks):
        last = k == nblocks - 1
        h = _compress(h, m[16 * k : 16 * (k + 1)], 4 * nwords if last else 64 * (k + 1), last)
    return h.movedim(0, -1)


def blake2s_batch(msgs: torch.Tensor) -> torch.Tensor:
    """Blake2s-256 of each row of ``msgs`` (count, W): int32 words (the bit
    patterns of uint32) -> (count, 8) int32 digest words. A CPU tensor takes
    ``blake2s_words``; a CUDA tensor one launch of ``spk_blake2s_batch``, a
    thread a message."""
    if msgs.dim() != 2 or msgs.dtype != torch.int32:
        raise ValueError(f"blake2s_batch: expected (count, W) int32 words, got {tuple(msgs.shape)} "
                         f"{msgs.dtype}")
    if msgs.device.type == "cpu":
        out = blake2s_words(msgs.to(torch.int64) & MASK32)
        return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
    msgs = msgs.contiguous()
    out = torch.empty((msgs.shape[0], 8), dtype=torch.int32, device=msgs.device)
    kernels.call("blake2s_batch", [msgs, out], [msgs.shape[0], msgs.shape[1]], key=msgs.shape)
    return out
