"""Host-side BLS12-381 optimal-ate pairing for the port's verifier.

The port's counterpart of ``spartan_tpu/host/pairing.py``'s ``pairing`` and
``product_of_pairings``. The pairing runs only in verification, 2 (nv + 1)
pairings per proof, so it stays on the host. The port has no Python tower:
it uses the native library, which computes the same values as the JAX
package's Python oracle (the cube of the standard pairing, which keeps every
equality check), and raises where that library is missing, as the
verifier's matrix evaluation does.
"""

from __future__ import annotations

from spartan_tpu_torch.host import native


def product_of_pairings(pairs):
    """prod_i e(P_i, Q_i) with one shared final exponentiation."""
    res = native.pairing_product_native(pairs)
    if res is None:
        raise RuntimeError("the native host library (g++ build) is needed for the pairing")
    return res


def pairing(p, q):
    """e(P, Q) for P in G1, Q in G2 (affine tuples, None = infinity)."""
    return product_of_pairings([(p, q)])
