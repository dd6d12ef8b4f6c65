"""ctypes loader for the port's native C++ host runtime
(``spartan_tpu_torch/native/``, a copy of the JAX package's ``native/``).

``load`` builds the library with ``g++`` at first use into
``spartan_tpu_torch/build/host/libspartan_host.so`` and rebuilds it when the
hash of the sources changes; the library is written under a temporary name
and renamed into place, so processes that build at once never load half a
file. Where ``g++`` is missing or the build fails, ``load`` returns None:
the transcript, matrix serialization and G1 linear combinations then take
their Python paths (bit-identical), while the pairing and the verifier's
matrix evaluation raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from spartan_tpu_torch.host.field import R

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "native"
_SRCS = [_SRC_DIR / "spartan_host.cpp", _SRC_DIR / "spartan_pairing.cpp"]
_HDRS = [_SRC_DIR / "pairing_constants.h"]
BUILD = _PKG / "build" / "host"
_SO = BUILD / "libspartan_host.so"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in _SRCS + _HDRS:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _build(digest: str) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"libspartan_host.so.tmp{os.getpid()}"
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), *[str(s) for s in _SRCS]],
                   check=True, capture_output=True)
    os.replace(tmp, _SO)
    stamp = BUILD / f"libspartan_host.so.sha256.tmp{os.getpid()}"
    stamp.write_text(digest)
    os.replace(stamp, BUILD / "libspartan_host.so.sha256")


def load():
    """Return the loaded ctypes library, building it if needed; None when it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        digest = _source_hash()
        stamp = BUILD / "libspartan_host.so.sha256"
        if not _SO.exists() or not stamp.exists() or stamp.read_text() != digest:
            _build(digest)
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError):
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.spartan_fs_new.restype = ctypes.c_void_p
    lib.spartan_fs_free.argtypes = [ctypes.c_void_p]
    lib.spartan_fs_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.spartan_fs_next_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.spartan_fs_get_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.spartan_fs_set_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.spartan_ser_matrix.restype = ctypes.c_uint64
    lib.spartan_ser_matrix.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_char_p,
    ]
    lib.spartan_pairing_product.argtypes = [u64p, u64p, ctypes.c_char_p, ctypes.c_uint64, u64p]
    lib.spartan_g1_lincomb.restype = ctypes.c_uint8
    lib.spartan_g1_lincomb.argtypes = [u64p, ctypes.c_char_p, u64p, ctypes.c_uint64, u64p]
    lib.spartan_matrix_eval3.restype = ctypes.c_int32
    lib.spartan_matrix_eval3.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    _lib = lib
    return _lib


class NativeFsRng:
    """Native Blake2s Fiat-Shamir stream; the API of ``utils.transcript``."""

    def __init__(self, lib):
        self._lib = lib
        self._ptr = lib.spartan_fs_new()

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.spartan_fs_free(self._ptr)
            self._ptr = None

    def feed(self, data: bytes) -> None:
        self._lib.spartan_fs_feed(self._ptr, data, len(data))

    def next_bytes(self, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.spartan_fs_next_bytes(self._ptr, out, n)
        return out.raw

    def get_state(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.spartan_fs_get_state(self._ptr, out)
        return out.raw

    def set_state(self, state: bytes) -> None:
        """Overwrite the chain state; resets the output stream."""
        if len(state) != 32:
            raise ValueError(f"chain state is 32 bytes, got {len(state)}")
        self._lib.spartan_fs_set_state(self._ptr, state)


def _fp_bytes(v: int, buf: bytearray, off: int) -> None:
    buf[off : off + 48] = int(v).to_bytes(48, "little")


def _u64p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint64))


def pairing_product_native(pairs):
    """prod_i e(P_i, Q_i), with one shared final exponentiation; None if the
    library is unavailable.

    pairs: [(g1_affine | None, g2_affine | None), ...] in the host tuple form
    of ``host/curve.py``. Returns Fp12 as nested tuples ((c0, c1, c2),
    (c3, c4, c5)) of Fp2 pairs, the layout of the JAX package's host tower."""
    lib = load()
    if lib is None:
        return None
    n = len(pairs)
    g1 = bytearray(96 * n)
    g2 = bytearray(192 * n)
    inf = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        if p is None or q is None:
            inf[i] = 1
            continue
        _fp_bytes(p[0], g1, 96 * i)
        _fp_bytes(p[1], g1, 96 * i + 48)
        (qx0, qx1), (qy0, qy1) = q
        for j, v in enumerate((qx0, qx1, qy0, qy1)):
            _fp_bytes(v, g2, 192 * i + 48 * j)
    out = (ctypes.c_uint64 * 72)()
    lib.spartan_pairing_product(_u64p(bytes(g1)), _u64p(bytes(g2)), bytes(inf), n, out)
    raw = bytes(out)
    fps = [int.from_bytes(raw[48 * i : 48 * (i + 1)], "little") for i in range(12)]
    return (tuple((fps[2 * j], fps[2 * j + 1]) for j in range(3)),
            tuple((fps[2 * j], fps[2 * j + 1]) for j in range(3, 6)))


INF_POINT = object()  # g1_lincomb_native's "point at infinity" result
# (distinct from None, which says the native library is unavailable)


def g1_lincomb_native(points, scalars):
    """sum_i s_i * P_i over G1 (affine host tuples); None if unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(points)
    pts = bytearray(96 * n)
    scal = bytearray(32 * n)
    inf = bytearray(n)
    for i, (p, s) in enumerate(zip(points, scalars)):
        if p is None or s % R == 0:
            inf[i] = 1
            continue
        _fp_bytes(p[0], pts, 96 * i)
        _fp_bytes(p[1], pts, 96 * i + 48)
        scal[32 * i : 32 * i + 32] = (s % R).to_bytes(32, "little")
    out = (ctypes.c_uint64 * 12)()
    if lib.spartan_g1_lincomb(_u64p(bytes(pts)), bytes(inf), _u64p(bytes(scal)), n, out):
        return INF_POINT
    raw = bytes(out)
    return (int.from_bytes(raw[:48], "little"), int.from_bytes(raw[48:96], "little"))


def matrix_eval3_native(ser_a: bytes, ser_b: bytes, ser_c: bytes, rx, ry, log_n: int):
    """(A, B, C)(rx, ry) for three matrices in ``ser_matrix`` wire layout, in
    one O(nnz) walk sharing the two eq tables; None if the library is
    unavailable. Returns three canonical Fr ints."""
    lib = load()
    if lib is None:
        return None
    rx_b = b"".join((int(x) % R).to_bytes(32, "little") for x in rx)
    ry_b = b"".join((int(y) % R).to_bytes(32, "little") for y in ry)
    out = ctypes.create_string_buffer(96)
    rc = lib.spartan_matrix_eval3(ser_a, len(ser_a), ser_b, len(ser_b), ser_c, len(ser_c),
                                  rx_b, ry_b, log_n, out)
    if rc != 0:
        raise ValueError(f"spartan_matrix_eval3: malformed input (rc={rc})")
    return tuple(int.from_bytes(out.raw[32 * i : 32 * (i + 1)], "little") for i in range(3))


def ser_matrix_native(rows):
    """``utils.serialize.ser_matrix`` in C++; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    counts = np.array([len(r) for r in rows], dtype=np.uint64)
    nnz = int(counts.sum())
    coeffs = bytearray(32 * nnz)
    cols = np.empty(nnz, dtype=np.uint64)
    e = 0
    for row in rows:
        for coeff, idx in row:
            coeffs[32 * e : 32 * e + 32] = (int(coeff) % R).to_bytes(32, "little")
            cols[e] = idx
            e += 1
    counts_p = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    size = lib.spartan_ser_matrix(counts_p, len(rows), None, None, nnz, None)
    out = ctypes.create_string_buffer(int(size))
    lib.spartan_ser_matrix(counts_p, len(rows), bytes(coeffs),
                           cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), nnz, out)
    return out.raw
