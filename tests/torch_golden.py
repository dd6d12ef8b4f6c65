"""The golden instance of the port's CPU tests that prove it whole: 2^5,
circuit seed 3, key seed 7, whose proof is
tests/fixtures/proof_2e5_seed3.bin. The keys take seconds to make on the
CPU, so a process makes them once (``keys``) for every test file that
reads them; nothing mutates them. The openings' plain G2 MSMs are most of
a proof's time on the CPU, and every proof of the instance opens the same
polynomial at the same two points, so ``reuse_openings`` computes them
once a process."""

import functools
import pathlib
import random

from spartan_tpu_torch.commitment import scheme
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.transcript import Blake2sRng

GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "proof_2e5_seed3.bin"


class SeededFr:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def sample_fr(self):
        return self._r.randrange(hf.R)


def instance():
    """(index on the CPU, v, w) of the golden circuit."""
    cs, v, w = generate_circuit_with_random_input(
        num_public=4, num_private=28, pad_to_square=True, density=1, rng=random.Random(3))
    return MLArgumentForR1CS.index(*cs.to_matrices(), "cpu"), v, w


def transcript_from_matrices(pk, v):
    """A prove's transcript after the public input, absorbing the index's
    serialized A, B, C from a fresh stream (not from ``pk.fs_state``): a
    witness of the transcript independent of the state the index keeps."""
    fs = Blake2sRng.setup()
    for m in (pk.matrix_a, pk.matrix_b, pk.matrix_c):
        fs.feed(m.serialize())
    fs.feed(ser.ser_fr_vec(v))
    return fs


@functools.lru_cache(maxsize=1)
def keys():
    """(pp, vp) of key seed 7 on the CPU."""
    return MLArgumentForR1CS.setup(5, SeededFr(7), "cpu")


_OPENINGS = {}


def _content(t) -> tuple:
    return str(t.dtype), tuple(t.shape), t.contiguous().numpy().tobytes()


def reuse_openings(monkeypatch):
    """``scheme.banded_g2_msms`` returns its earlier result for inputs of
    equal content (bases, scalars and sizes) in this process, and computes
    any other input: keys that reload or a mesh that shards differently
    still open through the same function of the same values."""
    real = scheme.banded_g2_msms

    def reused(bases_list, scalars_list, sizes):
        key = (tuple(_content(b.data) for b in bases_list), tuple(_content(q) for q in scalars_list),
               tuple(sizes))
        if key not in _OPENINGS:
            _OPENINGS[key] = real(bases_list, scalars_list, sizes)
        return _OPENINGS[key]

    monkeypatch.setattr(scheme, "banded_g2_msms", reused)
