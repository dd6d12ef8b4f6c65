"""Fiat-Shamir transcript primitives on tensors, the device-resident
transcript's plain versions.

Counterpart of ``spartan_tpu/ops/fs_device.py``: the chain of the host
transcript (``utils/transcript.py``), on 32-bit words held in ``int64``:

  state <- blake2s(state || bytes)      feed (the output stream restarts)
  block_k = blake2s(state || LE64(k))   the output stream
  sample_fr: one 32-byte block, bit 255 masked, rejected and the next
             block drawn while the value is >= r

The sampler loops until it accepts, as the host does. (The JAX package draws
24 candidates at once because XLA cannot loop inside a scan; that cap stays
behind.) On the card these steps run inside the sumcheck kernels' transcript
step (``csrc/fs.cuh``); the functions here are what that step is held
against, and the route the CPU takes.

An Fr element serializes as 32 little-endian bytes (``utils/serialize``),
which in the port's layout, 8 canonical 32-bit limbs, least significant
first, are the limbs themselves: ``limbs_to_words`` only moves the limb axis
last. (The JAX package packs pairs of 16-bit limbs into each word.)
"""

from __future__ import annotations

import numpy as np
import torch

from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.ops.blake2s import MASK32, blake2s_words

R_WORDS = tuple((hf.R >> (32 * i)) & MASK32 for i in range(8))


def state_to_words(state: bytes, device="cpu") -> torch.Tensor:
    """A 32-byte chain state -> (8,) int64 words."""
    if len(state) != 32:
        raise ValueError(f"chain state is 32 bytes, got {len(state)}")
    return torch.from_numpy(np.frombuffer(state, dtype="<u4").astype(np.int64)).to(device)


def words_to_state(words) -> bytes:
    """(8,) words (int64 in [0, 2^32), or int32 bit patterns) -> 32 bytes."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    return (np.asarray(words).reshape(-1).astype(np.int64) & MASK32).astype("<u4").tobytes()


def as_words(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (limbs, words) -> int64 words in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def as_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical Fr limbs (8, ...) -> their serialization words (..., 8)."""
    return as_words(limbs).movedim(0, -1)


def ser_fr_vec_words(limbs: torch.Tensor) -> torch.Tensor:
    """The words of ``ser_fr_vec`` of a (8, n) canonical vector: the u64
    length prefix, then 32 bytes an element."""
    n = limbs.shape[1]
    prefix = torch.tensor([n, 0], dtype=torch.int64, device=limbs.device)
    return torch.cat([prefix, limbs_to_words(limbs).reshape(-1)])


def fs_feed(state: torch.Tensor, msg_words: torch.Tensor) -> torch.Tensor:
    """state (8,), message (W,) words -> the new state (8,)."""
    return blake2s_words(torch.cat([state, msg_words]))


def fs_block(state: torch.Tensor, counter: int) -> torch.Tensor:
    """Output block ``counter`` of the stream: (8,) words."""
    ctr = torch.tensor([counter & MASK32, counter >> 32], dtype=torch.int64, device=state.device)
    return blake2s_words(torch.cat([state, ctr]))


def below_r(words: torch.Tensor) -> bool:
    """A (8,) word value < r, compared from the most significant word."""
    for w, r in zip(reversed(words.tolist()), reversed(R_WORDS)):
        if w != r:
            return w < r
    return False


def fs_sample_fr(state: torch.Tensor, counter: int = 0):
    """One uniform Fr element from the stream of ``state``, starting at
    block ``counter``. Returns (canonical (8,) int64 words, next counter)."""
    while True:
        block = fs_block(state, counter)
        counter += 1
        block[7] &= 0x7FFFFFFF  # the 255-bit width
        if below_r(block):
            return block, counter
