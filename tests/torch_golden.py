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
