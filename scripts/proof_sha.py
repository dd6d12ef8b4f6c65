"""Print the SHA-256 of the 2^16 proof that ``chip_smoke.py`` phase 4 makes
on the card (log_n = 16, density 0, 4 public inputs, circuit seed 0, key
seed 42), built by the checkout CHECKOUT (default: this one):

    python3 scripts/proof_sha.py [CHECKOUT]

The checkout's own ``chip_smoke.py`` supplies the circuit and the key
stream, so an older tree (a ``git archive`` unpacked into a directory that
``.gitignore`` lists) gives the proof its code made.
``tests/fixtures/proof_2e16_seed0.sha256`` holds the digest of a verified
run, and phase 4 holds every later proof against it. Needs one CUDA card.
"""

from __future__ import annotations

import hashlib
import os
import sys


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

    if not torch.cuda.is_available():
        raise SystemExit("proof_sha: torch.cuda.is_available() is False; this needs a CUDA card")
    log_n = 16
    a, b, c, v, w = chip_smoke._circuit(log_n, 2, 0, 0)
    pp, vp = MLArgumentForR1CS.setup(log_n, chip_smoke.SeededFr(42), "cuda")
    pk = MLArgumentForR1CS.index(a, b, c, "cuda")
    proof = MLArgumentForR1CS.prove(pk, v, w, pp)
    ok = MLArgumentForR1CS.verify(pk.vk(), v, proof, vp)
    data = proof.serialize()
    print(f"proof_sha: {checkout}: 2^{log_n} proof {len(data)} bytes, verify {'accepts' if ok else 'REJECTS'}, "
          f"sha256 {hashlib.sha256(data).hexdigest()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
