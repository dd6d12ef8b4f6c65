"""The CUDA sources of the port's kernels, compiled for the host with g++
behind ``tests/cuda_host_shim.h`` and run on CPU fibers, against the plain
PyTorch versions: the team point kernels (G1 and G2 add, mixed add and
2^k-fold double, at every team size, edge lanes included), the G1 mixed add
(one thread a point on the carry flag), the carry-flag Montgomery product
of fr_mul (and its Fp instantiation, the point kernels' product), both
versions of the Fp Fermat inversion, and the sumcheck-phase kernels: the
Blake2s of the transcript step against ``hashlib``, its sampler against the
host stream, the unreduced sums and their reduction against Python integers,
the round kernels K6 and K7 with their transcript step and the one-block
tails against their plain versions, on their batch axis: 2-D grids of 1 to
3 blocks (so the partials and the last block's ticket run) by 1 to 3
instances, the shim interleaving the instances' blocks; tails a block an
instance, at 1 and 2 instances. This holds the kernels' own arithmetic,
tables and edge rules on the CPU. Every ``.cu`` file,
entry points and launches included, also goes through ``g++
-fsyntax-only`` with the CUDA runtime stubbed, which finds a C++ error
before a build on the card; whether nvcc accepts them, and how fast they
run, only ``chip_smoke.py`` on the card can say.
"""

import ctypes
import hashlib
import pathlib
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spartan_tpu.host import curve as hc
from spartan_tpu.host import field as hf
from spartan_tpu_torch.ops import curve as tcv
from spartan_tpu_torch.ops import field as tf

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = ROOT.parent / "spartan_tpu_torch" / "csrc"
ENTRY = r"""
#include <algorithm>
#include "team.cuh"
#include "fp_inv.cuh"
#include "point.cuh"
#include "fr.cuh"
#include "fs.cuh"
#include "sumcheck.cuh"
#include "normalize.cuh"
#include "fr_tables.cuh"

// op: 0 double, 1 add, 2 mixed add (team::Op); T: team size
#define CASE(G, TT, OP) \
  if (T == TT && op == OP) { shim_launch(blocks, kBlock, [&] { team_kernel<G, TT, OP>(p, q, out, n, k); }); return 0; }
extern "C" int host_g1(int op, int T, const uint32_t* p, const uint32_t* q, uint32_t* out,
                       int64_t n, int k) {
  using namespace team;
  const unsigned blocks = (unsigned)((n + kBlock / T - 1) / (kBlock / T));
  CASE(G1, 2, 0) CASE(G1, 2, 1) CASE(G1, 4, 0) CASE(G1, 4, 1) CASE(G1, 8, 0) CASE(G1, 8, 1)
  CASE(G1, 2, 2) CASE(G1, 4, 2)
  return 1;
}

extern "C" int host_g1_madd(const uint32_t* p, const uint32_t* q, uint32_t* out,
                                      int64_t n) {
  shim_launch((unsigned)((n + 127) / 128), 128, [&] { pt_kernel<FpC, 0, 3>(p, q, out, n); });
  return 0;
}

// fr: 1 for Fr (fr_mul's kernel), 0 for Fp
extern "C" int host_mul_cc(int fr, const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n) {
  const unsigned blocks = (unsigned)((n + 127) / 128);
  if (fr)
    shim_launch(blocks, 128, [&] { fe_mul_cc_kernel<FrParams>(a, b, out, n); });
  else
    shim_launch(blocks, 128, [&] { fe_mul_cc_kernel<FpParams>(a, b, out, n); });
  return 0;
}

extern "C" int host_g2(int op, int T, const uint32_t* p, const uint32_t* q, uint32_t* out,
                       int64_t n, int k) {
  using namespace team;
  const unsigned blocks = (unsigned)((n + kBlock / T - 1) / (kBlock / T));
  CASE(G2, 4, 0) CASE(G2, 4, 1) CASE(G2, 4, 2) CASE(G2, 8, 0) CASE(G2, 8, 1) CASE(G2, 8, 2)
  CASE(G2, 16, 0) CASE(G2, 16, 1) CASE(G2, 16, 2)
  return 1;
}

extern "C" int host_blake2s_batch(const uint32_t* msgs, uint32_t* out, int64_t count, int nwords) {
  shim_launch((unsigned)((count + 31) / 32), 32, [&] { blake2s_batch_kernel(msgs, out, count, nwords); });
  return 0;
}

extern "C" uint32_t host_sample_fr(const uint32_t* state, uint32_t counter, uint32_t* out) {
  return b2s::sample_fr<FrParams>(state, counter, out);
}

// A round launch with its transcript step (K6 or K7 with K5) over a
// (blocks, B) grid, and a one-block tail a block an instance, at the entry
// point's block size: t the entry point's pointer arguments in order,
// instance 0's; blocks an instance's grid (round_blocks).
extern "C" int host_round(int sc1, void* const* t, int64_t pairs, int fold, int blocks, int D, int B,
                          int64_t s_stride, int64_t ist) {
  using U = uint32_t*;
  using W = unsigned long long*;
  using C = const uint32_t*;
  if (sc1)
    shim_launch2(blocks, B, sck::kThreads, [&] {
      sc1_round_kernel(C(t[0]), C(t[1]), C(t[2]), C(t[3]), C(t[4]), C(t[5]), C(t[6]), U(t[7]), U(t[8]), U(t[9]),
                       U(t[10]), U(t[11]), U(t[12]), U(t[13]), U(t[14]), U(t[15]), U(t[16]), W(t[17]), pairs, fold, D,
                       s_stride, ist);
    });
  else
    shim_launch2(blocks, B, sck::kThreads, [&] {
      prod2_round_kernel(C(t[0]), C(t[1]), U(t[2]), U(t[3]), U(t[4]), U(t[5]), U(t[6]), U(t[7]), U(t[8]),
                         W(t[9]), pairs, fold, ist);
    });
  return 0;
}

extern "C" int host_tail(int sc1, void* const* t, int64_t pairs0, int fold, int rounds, int D, int B,
                         int64_t s_stride, int64_t ist) {
  using U = uint32_t*;
  using C = const uint32_t*;
  const unsigned threads = (unsigned)std::min<int64_t>(sck::kTailThreads, std::max<int64_t>(32, 4 * pairs0));
  if (sc1)
    shim_launch(B, threads, [&] {
      sc1_tail_kernel(C(t[0]), C(t[1]), C(t[2]), C(t[3]), C(t[4]), C(t[5]), U(t[6]), C(t[7]), U(t[8]), U(t[9]),
                      U(t[10]), U(t[11]), U(t[12]), U(t[13]), pairs0, fold, rounds, D, s_stride, ist);
    });
  else
    shim_launch(B, threads, [&] {
      sc2_tail_kernel(C(t[0]), C(t[1]), U(t[2]), U(t[3]), U(t[4]), U(t[5]), pairs0, fold, rounds, ist);
    });
  return 0;
}

// The unreduced sum (fr_sum.cuh) of n canonical elements (rows of 8 words),
// a warp's lanes taking every 32nd and then summed across the warp, into
// acc (9 words), and its reduction into fr (8 words): acc_mul with y = R mod
// r (y R^-1 = 1) and y R = R^2 is the sum mod r.
Fr host_mod_r(const sck::Acc& s) {
  return sck::acc_mul(sck::fr_const(sck::SPK_FR_ONE_MONT), sck::fr_const(sck::SPK_FR_R2), s);
}

extern "C" int host_acc_sum(const uint32_t* terms, int64_t n, uint32_t* acc, uint32_t* fr) {
  shim_launch(1, 32, [&] {
    sck::Acc s = sck::acc_zero();
    for (int64_t i = threadIdx.x; i < n; i += 32) sck::acc_add(s, sck::load8(terms + 8 * i));
    s = sck::acc_warp_sum(s, 1);
    if (threadIdx.x == 0) {
      for (int i = 0; i < 9; ++i) acc[i] = s.v[i];
      sck::store8(fr, host_mod_r(s));
    }
  });
  return 0;
}

// The reduction of a given 9-word value (any value below 2^288).
extern "C" void host_mod_r9(const uint32_t* acc, uint32_t* fr) {
  sck::Acc s;
  for (int i = 0; i < 9; ++i) s.v[i] = acc[i];
  sck::store8(fr, host_mod_r(s));
}

// Jacobian -> affine (normalize.cuh): G1 (C = 3) or G2 (6), one warp or one
// thread a point.
extern "C" int host_normalize(int g2, int warp, const uint32_t* p, uint32_t* out, int64_t n) {
  using namespace aff;
  if (warp)
    shim_launch((unsigned)((n + kWarps - 1) / kWarps), 32 * kWarps, [&] {
      if (g2) normalize_warp_kernel<6>(p, out, n); else normalize_warp_kernel<3>(p, out, n);
    });
  else
    shim_launch((unsigned)((n + 127) / 128), 128, [&] {
      if (g2) normalize_thread_kernel<6>(p, out, n); else normalize_thread_kernel<3>(p, out, n);
    });
  return 0;
}

// The eq tables 0 .. tables - 1 of the (8, nv) point ts (fr_tables.cuh).
extern "C" int host_eq_tables(const uint32_t* ts, uint32_t* out, int nv, int tables) {
  const int64_t total = ((int64_t)2 << nv) - ((int64_t)1 << (nv + 1 - tables));
  shim_launch((unsigned)((total + frt::kEqThreads - 1) / frt::kEqThreads), frt::kEqThreads,
              [&] { frt::eq_tables_kernel(ts, out, nv, total); });
  return 0;
}

// The quotient ladder: level launches 0 .. level0 - 1 (remainders into rs,
// level k's at rs[k]), then the one-block tail at its entry point's size.
extern "C" int host_ladder(const uint32_t* poly, const uint32_t* point, uint32_t* qcat, uint32_t* ev,
                           uint32_t* const* rs, int nv, int level0) {
  const uint32_t* r = poly;
  for (int level = 0; level < level0; ++level) {
    const int64_t pairs = (int64_t)1 << (nv - 1 - level);
    shim_launch((unsigned)((pairs + frt::kLevelThreads - 1) / frt::kLevelThreads), frt::kLevelThreads,
                [&] { frt::quot_level_kernel(r, point, qcat, rs[level], nv, level); });
    r = rs[level];
  }
  const int64_t pairs0 = level0 < nv ? (int64_t)1 << (nv - 1 - level0) : 1;
  const unsigned threads = (unsigned)std::min<int64_t>(frt::kTailThreads, std::max<int64_t>(32, pairs0));
  shim_launch(1, threads, [&] { frt::quot_tail_kernel(r, point, qcat, ev, nv, level0); });
  return 0;
}

extern "C" int host_fp_inv(int warp, const uint32_t* a, uint32_t* out, int64_t n) {
  using namespace fpinv;
  if (warp)
    shim_launch((unsigned)((n + kWarps - 1) / kWarps), 32 * kWarps, [&] { inv_warp_kernel(a, out, n); });
  else
    shim_launch((unsigned)((n + 127) / 128), 128, [&] { inv_thread_kernel(a, out, n); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("csrc_host")
    for src in CSRC.glob("*.cu*"):
        text = src.read_text()
        dyn = "extern __shared__ uint4 smem[];"  # dynamic shared memory: a static buffer
        assert (dyn in text) == (src.name in ("team.cuh", "sumcheck.cuh")), src.name
        (d / src.name).write_text(text.replace(dyn, "static uint4 smem[16384];"))
    (d / "entry.cpp").write_text(ENTRY)
    so = d / "libcsrc_host.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-include", str(ROOT / "cuda_host_shim.h"), f"-I{d}", str(d / "entry.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_g1.argtypes = lib.host_g2.argtypes = [i32, i32, vp, vp, vp, i64, i32]
    lib.host_g1_madd.argtypes = [vp, vp, vp, i64]
    lib.host_mul_cc.argtypes = [i32, vp, vp, vp, i64]
    lib.host_fp_inv.argtypes = [i32, vp, vp, i64]
    lib.host_normalize.argtypes = [i32, i32, vp, vp, i64]
    lib.host_eq_tables.argtypes = [vp, vp, i32, i32]
    lib.host_ladder.argtypes = [vp, vp, vp, vp, vp, i32, i32]
    lib.host_blake2s_batch.argtypes = [vp, vp, i64, i32]
    lib.host_sample_fr.argtypes = [vp, ctypes.c_uint32, vp]
    lib.host_sample_fr.restype = ctypes.c_uint32
    lib.host_round.argtypes = lib.host_tail.argtypes = [i32, vp, i64, i32, i32, i32, i32, i64, i64]
    lib.host_acc_sum.argtypes = [vp, i64, vp, vp]
    lib.host_mod_r9.argtypes = [vp, vp]
    return lib


# The runtime calls of the launch code, stubbed for a host syntax check
RUNTIME_STUBS = r"""
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""


@pytest.fixture(scope="module")
def host_csrc(tmp_path_factory):
    """csrc/ as host C++: launch brackets removed (a launch parses as a
    call), dynamic shared memory a static buffer, an empty cuda_runtime.h."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("csrc_syntax")
    for src in CSRC.glob("*.cu*"):
        text = re.sub(r"<<<[^>]*>>>", "", src.read_text())
        (d / src.name).write_text(text.replace("extern __shared__ uint4 smem[];",
                                               "static uint4 smem[16384];"))
    (d / "cuda_runtime.h").write_text("")
    (d / "stubs.h").write_text(f'#include "{ROOT / "cuda_host_shim.h"}"\n{RUNTIME_STUBS}')
    return d


@pytest.mark.parametrize("src", sorted(p.name for p in CSRC.glob("*.cu")))
def test_kernel_source_parses_as_host_cpp(host_csrc, src):
    out = subprocess.run(["g++", "-x", "c++", "-std=c++20", "-fsyntax-only", "-D__CUDACC__",
                          "-include", str(host_csrc / "stubs.h"), f"-I{host_csrc}",
                          str(host_csrc / src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]


def test_kernel_sources_link_as_one_library(host_csrc, tmp_path):
    """Every .cu compiled as host C++ to an object of its own, as nvcc
    compiles each into the kernel library, and the objects linked into one
    shared library: a function with external linkage defined in a header
    that two entry-point files include fails this link as it fails the
    library's link on the card."""
    srcs = sorted(p.name for p in CSRC.glob("*.cu"))
    procs = [subprocess.Popen(["g++", "-x", "c++", "-std=c++20", "-O0", "-fPIC", "-c", "-D__CUDACC__",
                               "-include", str(host_csrc / "stubs.h"), f"-I{host_csrc}", str(host_csrc / s),
                               "-o", str(tmp_path / f"{s}.o")], stderr=subprocess.PIPE, text=True) for s in srcs]
    for s, proc in zip(srcs, procs):
        _out, err = proc.communicate()
        assert proc.returncode == 0, (s, err[-4000:])
    link = subprocess.run(["g++", "-shared", "-o", str(tmp_path / "libkernels.so"),
                           *[str(tmp_path / f"{s}.o") for s in srcs]], capture_output=True, text=True)
    assert link.returncode == 0, link.stderr[-4000:]


@pytest.fixture(scope="module")
def g2_lanes():
    """13 lanes of P (Jacobian, Z != 1; affine from lane 9 on, as the
    MSM's first bucket level has), Q affine for the mixed add and Q
    Jacobian for the add. Lanes 0-3 of both are P == Q, P == -Q, P = inf
    and Q = inf."""
    rng = random.Random(17)
    base = [hc.G2.mul(hf.G2_GEN, rng.randrange(1, hf.R)) for _ in range(6)]
    ps = [base[i % 6] for i in range(13)]
    qs = [base[(5 * i + 2) % 6] for i in range(13)]
    ps[2] = None
    qs[3] = None
    p = tcv.double(tcv.g2_encode(ps))
    p.data[..., 9:] = tcv.g2_encode(ps[9:]).data
    q_aff, q_jac = list(qs), list(qs)
    q_aff[0], q_jac[0] = hc.G2.double(ps[0]), ps[0]  # P == Q
    q_aff[1], q_jac[1] = hc.G2.neg(hc.G2.double(ps[1])), hc.G2.neg(ps[1])  # P == -Q
    q_aff[9] = ps[9]
    return p, tcv.g2_encode(q_aff), tcv.double(tcv.g2_encode(q_jac))


@pytest.mark.parametrize("team", [4, 8, 16])
@pytest.mark.parametrize("op", ["double", "add", "madd"])
def test_g2_team_kernel_source_matches_plain(lib, g2_lanes, op, team):
    p, q_aff, q_jac = g2_lanes
    q = q_jac if op == "add" else q_aff
    k = 3 if op == "double" else 0
    want = {"double": lambda: tcv.double_plain(p, k), "add": lambda: tcv.add_plain(p, q),
            "madd": lambda: tcv.add_mixed_plain(p, q)}[op]().data
    ins = [p.data.contiguous(), q.data.contiguous()]
    out = torch.zeros_like(ins[0])
    code = {"double": 0, "add": 1, "madd": 2}[op]
    assert lib.host_g2(code, team, ins[0].data_ptr(), ins[1].data_ptr(), out.data_ptr(), p.n, k) == 0
    assert torch.equal(out, want)


@pytest.fixture(scope="module")
def g1_lanes():
    """13 lanes of P and Q, both Jacobian (Z != 1). Lanes 0-3 are P == Q (Q
    affine there, so the two have different Z), P == -Q, P = inf and
    Q = inf."""
    rng = random.Random(19)
    base = [hc.G1.mul(hf.G1_GEN, rng.randrange(1, hf.R)) for _ in range(6)]
    ps = [base[i % 6] for i in range(13)]
    qs = [base[(5 * i + 2) % 6] for i in range(13)]
    ps[2] = None
    qs[3] = None
    qs[0], qs[1] = ps[0], hc.G1.neg(ps[1])
    p, q = tcv.double(tcv.g1_encode(ps)), tcv.double(tcv.g1_encode(qs))
    q.data[..., 0] = tcv.g1_encode([hc.G1.double(ps[0])]).data[..., 0]
    return p, q


@pytest.mark.parametrize("team", [2, 4, 8])
@pytest.mark.parametrize("op", ["double", "add"])
def test_g1_team_kernel_source_matches_plain(lib, g1_lanes, op, team):
    p, q = g1_lanes
    k = 3 if op == "double" else 0
    want = (tcv.double_plain(p, k) if op == "double" else tcv.add_plain(p, q)).data
    out = torch.zeros_like(p.data)
    code = {"double": 0, "add": 1}[op]
    assert lib.host_g1(code, team, p.data.data_ptr(), q.data.data_ptr(), out.data_ptr(), p.n, k) == 0
    assert torch.equal(out, want)


@pytest.fixture(scope="module")
def g1_madd_lanes():
    """13 lanes of P (Jacobian, Z != 1; affine from lane 9 on, as the
    MSM's first bucket level has) and Q affine-encoded. Lanes 0-3 are
    P == Q, P == -Q, P = inf and Q = inf."""
    rng = random.Random(23)
    base = [hc.G1.mul(hf.G1_GEN, rng.randrange(1, hf.R)) for _ in range(6)]
    ps = [base[i % 6] for i in range(13)]
    qs = [base[(5 * i + 2) % 6] for i in range(13)]
    ps[2] = None
    qs[3] = None
    p = tcv.double(tcv.g1_encode(ps))
    p.data[..., 9:] = tcv.g1_encode(ps[9:]).data
    qs[0] = hc.G1.double(ps[0])  # P == Q
    qs[1] = hc.G1.neg(hc.G1.double(ps[1]))  # P == -Q
    qs[9] = ps[9]  # P == Q, both affine
    return p, tcv.g1_encode(qs)


@pytest.mark.parametrize("version", ["entry", "team2", "team4"])
def test_g1_madd_kernel_source_matches_plain(lib, g1_madd_lanes, version):
    """The G1 mixed add (one thread a point on the carry flag) and its team
    program at each team size against add_mixed_plain, edge lanes
    included."""
    p, q = g1_madd_lanes
    want = tcv.add_mixed_plain(p, q).data
    out = torch.zeros_like(p.data)
    args = (p.data.data_ptr(), q.data.data_ptr(), out.data_ptr(), p.n)
    if version == "entry":
        assert lib.host_g1_madd(*args) == 0
    else:
        assert lib.host_g1(2, int(version[4:]), *args, 0) == 0
    assert torch.equal(out, want)
    assert tcv.g1_decode(tcv.PointBatch(out, "g1"))[:4] == [
        hc.G1.double(tcv.g1_decode(p)[0]), None, tcv.g1_decode(q)[2], tcv.g1_decode(p)[3]]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_mul_cc_kernel_source_matches_plain_and_jax(lib, name):
    """fp_cc.cuh's Montgomery product, the body of fr_mul's kernel (and, over
    Fp, the team kernels' product), against mont_mul_plain, the JAX
    package's mont_mul and Python integers: every pair of 0, 1, m - 1 and
    R mod m, then random pairs."""
    from spartan_tpu.ops import field as jf

    tspec, jspec = (tf.FR, jf.FR) if name == "fr" else (tf.FP, jf.FP)
    m = tspec.modulus
    rng = random.Random(29)
    edge = [0, 1, m - 1, (1 << (32 * tspec.nlimb)) % m]
    xs = [x for x in edge for _ in edge] + [rng.randrange(m) for _ in range(20)]
    ys = edge * len(edge) + [rng.randrange(m) for _ in range(20)]
    a, b = tf.encode_ints(tspec, xs), tf.encode_ints(tspec, ys)
    out = torch.zeros_like(a)
    assert lib.host_mul_cc(name == "fr", a.data_ptr(), b.data_ptr(), out.data_ptr(), len(xs)) == 0
    assert torch.equal(out, tf.mont_mul_plain(tspec, a, b))
    jax_out = jf.mont_mul(jspec, jf.encode_ints(jspec, xs), jf.encode_ints(jspec, ys))
    assert tf.decode_ints(tspec, out) == jf.decode_ints(jspec, jax_out)
    assert tf.decode_ints(tspec, out) == [x * y * tspec.r_inv % m for x, y in zip(xs, ys)]


@pytest.mark.parametrize("version", ["thread", "warp"])
def test_fp_inv_kernel_source_matches_plain_chain(lib, version):
    m = tf.FP.modulus
    xs = [0, m - 1, random.Random(3).randrange(m)]
    a = tf.encode_mont(tf.FP, xs)
    out = torch.zeros_like(a)
    lib.host_fp_inv(version == "warp", a.data_ptr(), out.data_ptr(), a.shape[1])
    assert torch.equal(out, tf.fermat_inv_plain(tf.FP, a))
    assert tf.decode_mont(tf.FP, out) == [pow(x, m - 2, m) for x in xs]


@pytest.fixture(scope="module")
def jacobian_lanes():
    """G1 and G2 batches of 5 Jacobian lanes (doubled affine points, so
    Z != 1), lane 1 the point at infinity."""
    out = {}
    for group, ops, gen, enc in (("g1", hc.G1, hf.G1_GEN, tcv.g1_encode), ("g2", hc.G2, hf.G2_GEN, tcv.g2_encode)):
        rng = random.Random(31)
        pts = [ops.mul(gen, rng.randrange(1, hf.R)) for _ in range(5)]
        pts[1] = None
        out[group] = tcv.double(enc(pts))
    return out


@pytest.mark.parametrize("path", ["warp", "thread"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_normalize_kernel_source_matches_plain(lib, jacobian_lanes, group, path):
    """normalize.cuh's Jacobian-to-affine kernels, one warp a point (4
    lanes: one block) and one thread a point (5
    lanes), against normalize_plain, the infinity lane included."""
    p = jacobian_lanes[group]
    if path == "warp":
        p = p.take(slice(0, 4))
    data = p.data.contiguous()
    out = torch.full_like(data, -1)
    assert lib.host_normalize(group == "g2", path == "warp", data.data_ptr(), out.data_ptr(), p.n) == 0
    assert torch.equal(out, tcv.normalize_plain(p).data)


@pytest.mark.parametrize("which", ["eq_table", "suffix"])
def test_eq_tables_kernel_source_matches_plain(lib, which):
    """fr_tables.cuh's eq kernel at nv = 9 (2 and 4 blocks of 256 lanes):
    eq_table alone, and the nv + 1 suffix tables in one buffer, each a
    contiguous (8, 2^(nv-j)) run, against the plain loops."""
    from spartan_tpu_torch.ops import mle as tmle

    nv = 9
    ts = _fr_table(random.Random(43), nv)
    want = [tmle.eq_table_plain(ts)] if which == "eq_table" else tmle.eq_suffix_tables_plain(ts)
    out = torch.full((8 * sum(w.shape[1] for w in want),), -1, dtype=torch.int32)
    assert lib.host_eq_tables(ts.data_ptr(), out.data_ptr(), nv, len(want)) == 0
    off = 0
    for w in want:
        assert torch.equal(out[off : off + w.numel()].view(8, -1), w)
        off += w.numel()


# (nv, level0): the tail alone from 16 pairs, three level launches and the
# tail from 4 pairs, and the prover's split at nv = 12 (one level launch of
# 2,048 pairs, the tail from 1,024, two pairs a thread in its first level)
LADDER_SHAPES = [(5, 0), (6, 3), (12, 1)]


@pytest.mark.parametrize("shape", LADDER_SHAPES, ids=lambda s: "nv{}-l{}".format(*s))
def test_ladder_kernel_sources_match_plain(lib, shape):
    """fr_tables.cuh's quotient ladder (level launches, then the one-block
    tail) against _quotients_and_eval_plain: every quotient at its offset of
    qcat and the evaluation."""
    from spartan_tpu_torch.commitment import scheme as tscheme

    nv, level0 = shape
    rng = random.Random(nv)
    poly, point = _fr_table(rng, 1 << nv), _fr_table(rng, nv)
    qcat = torch.full((8, (1 << nv) - 1), -1, dtype=torch.int32)
    ev = torch.full((8, 1), -1, dtype=torch.int32)
    rs = [_zeros(8, 1 << (nv - 1 - k)) for k in range(level0)]
    ptrs = (ctypes.c_void_p * max(1, level0))(*[r.data_ptr() for r in rs])
    assert lib.host_ladder(poly.data_ptr(), point.data_ptr(), qcat.data_ptr(), ev.data_ptr(), ptrs, nv, level0) == 0
    want_q, want_ev = tscheme._quotients_and_eval_plain(poly, point)
    assert torch.equal(qcat, want_q)
    assert torch.equal(ev, want_ev)


@pytest.mark.parametrize("nwords", [0, 1, 8, 10, 16, 17, 32, 162])
def test_blake2s_kernel_source_matches_hashlib(lib, nwords):
    """blake2s.cuh on 3 messages of `nwords` words: the lengths around the
    block edges, 32 words (round 4's two full blocks) and 162 (a sumcheck-1
    round's message at 2^16)."""
    rng = np.random.default_rng(nwords)
    msgs = rng.integers(0, 1 << 32, size=(3, nwords), dtype=np.uint64).astype(np.uint32)
    out = np.zeros((3, 8), dtype=np.uint32)
    m = np.ascontiguousarray(msgs)
    assert lib.host_blake2s_batch(m.ctypes.data, out.ctypes.data, 3, nwords) == 0
    for i in range(3):
        assert out[i].astype("<u4").tobytes() == hashlib.blake2s(m[i].astype("<u4").tobytes()).digest()


def test_sampler_kernel_source_matches_host_stream(lib):
    """blake2s.cuh's sample_fr on one running counter against the host
    transcript's sample_fr, over enough samples to reject some."""
    from spartan_tpu_torch.utils.transcript import Blake2sRng

    host = Blake2sRng.setup()
    host.feed(bytes(range(200)))
    state = np.frombuffer(host.get_state(), dtype="<u4").copy()
    want = host.sample_fr_vec(40)
    out = np.zeros(8, dtype=np.uint32)
    ctr, got = 0, []
    for _ in range(40):
        ctr = lib.host_sample_fr(state.ctypes.data, ctr, out.ctypes.data)
        got.append(int.from_bytes(out.astype("<u4").tobytes(), "little"))
    assert got == want
    assert ctr > 40  # some draws were rejected


def _fr_table(rng, n):
    return tf.encode_mont(tf.FR, [rng.randrange(hf.R) for _ in range(n)])


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _coef(rng, d):
    """A transcript step's coefficients (6, d, 8), as the round before hands
    them on: K canonical, then K R."""
    k = [rng.randrange(hf.R) for _ in range(3 * d)]
    return tf.encode_ints(tf.FR, k + [x * tf.FR.r_mod % hf.R for x in k]).t().reshape(6, d, 8).contiguous()


def _batch_args(kernel: str, pairs: int, fold: int, bsz: int, log_n: int, seed: int):
    """Seeded arguments of a batched round launch (pairs pairs) or tail
    (from pairs down) for bsz instances, as protocol.fused's phases lay them
    out: tables (B, 8, n); the weights (B, 8, pairs) at an instance stride
    of their own, wider than a table; every transcript array a view of one
    buffer with a copy an instance (instance stride ist). Returns (tables,
    the weights or None, the buffer, its views by name, D, rounds)."""
    from spartan_tpu_torch.protocol import fused

    rng = random.Random(seed)
    sc1, tail = kernel.startswith("sc1"), "tail" in kernel
    nt, d = (3, log_n + 3) if sc1 else (2, 3)
    rounds = pairs.bit_length() if tail else 1
    width = (4 if fold else 2) * pairs
    tabs = [torch.stack([_fr_table(rng, width) for _ in range(bsz)]) for _ in range(nt)]
    s = None
    if sc1:
        n_s = 8 * (2 * pairs - 1) if tail else 8 * pairs
        wide = torch.zeros((bsz, n_s + 24), dtype=torch.int32)
        for b in range(bsz):
            wide[b, :n_s] = torch.cat([_fr_table(rng, pairs >> k).reshape(-1) for k in range(rounds)])
        s = wide[:, :n_s] if tail else wide[:, :n_s].view(bsz, 8, pairs)
    parts = [("state", 1), ("evals", rounds * d), ("rs", rounds), ("r_mont", 1), ("ctr", 1),
             ("sums", fused.SUMS_ROWS)]
    if sc1:
        parts += [("tor", rounds + 1), ("pre", 1), ("coef", 6 * d), ("vabc", 3), ("rabc", 3)]
    buf = fused._Buffer(parts, bsz)
    for name in ("state", "r_mont") + (("tor", "pre") if sc1 else ()):
        count = buf.offsets[name][1]
        buf.set(name, np.stack([_fr_table(rng, count).t().numpy() for _ in range(bsz)]))
    if sc1:
        buf.set("coef", np.stack([_coef(rng, d).numpy() for _ in range(bsz)]))
    buf.upload(torch.device("cpu"))
    v = {name: buf.views(name) for name in buf.offsets}
    v["evals"] = v["evals"].view(bsz, rounds, d, 8)
    if sc1:
        v["coef"] = v["coef"].view(bsz, 6, d, 8)
    return tabs, s, buf, v, d, rounds


# (pairs, fold, B): round launches of 1 to 3 blocks an instance (32 pairs a
# block) over 1 to 3 instances, so each instance's partials, ticket and last
# block run, with other instances' blocks between them where B > 1
ROUND_SHAPES = [(16, 0, 1), (64, 1, 1), (96, 1, 1), (16, 0, 3), (64, 1, 2), (96, 1, 3)]


def _shape_id(shape) -> str:
    """p{pairs}-f{fold}, and -b{B} beyond one instance."""
    return "p{}-f{}".format(*shape[:2]) + ("" if shape[2] == 1 else f"-b{shape[2]}")


@pytest.mark.parametrize("shape", ROUND_SHAPES, ids=_shape_id)
@pytest.mark.parametrize("kernel", ["sc1_round", "prod2_round"])
def test_round_kernel_sources_match_plain(lib, kernel, shape):
    """K6 and K7 with their transcript step (sumcheck.cuh, fs.cuh) on a
    (blocks, B) grid, blocks of different instances interleaved by the shim,
    against protocol.fused's plain rounds on each instance: every
    instance's folded tables, evaluations, challenge canonical and
    Montgomery, pre, coefficients and chain state, and its ticket counter
    and sums back at 0: a counter or sums shared across instances would hand
    the transcript step to the wrong block."""
    from spartan_tpu_torch.protocol import fused

    pairs, fold, bsz = shape
    sc1 = kernel == "sc1_round"
    log_n = 5
    blocks = fused.round_blocks(pairs, bsz)
    assert blocks == (pairs + 31) // 32 and blocks * bsz <= fused.MAX_GRID_B
    tabs, s, kbuf, kv, d, _r = _batch_args(kernel, pairs, fold, bsz, log_n, pairs * 11 + fold)
    _t, _s, pbuf, pv, _d, _r = _batch_args(kernel, pairs, fold, bsz, log_n, pairs * 11 + fold)
    consts = fused.emit_consts(log_n + 2, "cpu")
    outs = [torch.zeros((bsz, 8, 2 * pairs), dtype=torch.int32) for _ in tabs] if fold else tabs
    st = [kv["state"][0], kv["evals"][0, 0], kv["rs"][0, 0], kv["r_mont"][0], kv["ctr"][0]]
    if sc1:
        ptrs = [*tabs, s[0], consts, kv["tor"][0, 0], kv["tor"][0, 1], kv["pre"][0], kv["coef"][0], *st, *outs,
                kv["sums"]]
    else:
        ptrs = [*tabs, *st, *outs, kv["sums"]]
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    s_stride = s.stride(0) if sc1 else 0
    assert lib.host_round(sc1, arr, pairs, fold, blocks, d, bsz, s_stride, kbuf.size) == 0
    if sc1:
        want = fused.sc1_round_plain(*tabs, s, bool(fold), consts, pv["tor"][:, 0], pv["tor"][:, 1], pv["pre"],
                                     pv["coef"], pv["state"], pv["evals"][:, 0], pv["rs"][:, 0], pv["r_mont"])
    else:
        want = fused.prod2_round_plain(*tabs, bool(fold), pv["state"], pv["evals"][:, 0], pv["rs"][:, 0],
                                       pv["r_mont"])
    assert torch.equal(kbuf.dev, pbuf.dev)  # every instance's transcript arrays; ctr and sums at 0
    assert not kv["ctr"].any() and not kv["sums"].any()
    if fold:
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


# (pairs0, fold): the tail from 4 pairs (warp 0 alone), from 16 without the
# fold (round 0 of a 2^5 phase) and from 32 (every warp, then warp 0)
TAIL_SHAPES = [(4, 1), (16, 0), (32, 1)]


@pytest.mark.parametrize("shape", [(*sh, bsz) for bsz in (1, 2) for sh in TAIL_SHAPES], ids=_shape_id)
@pytest.mark.parametrize("kernel", ["sc1_tail", "sc2_tail"])
def test_tail_kernel_sources_match_plain(lib, kernel, shape):
    """The one-block tails (sumcheck.cuh), a block an instance, against
    protocol.fused's plain tails on each instance: every round's
    evaluations and challenge, r_mont, pre, the chain state, and for
    sumcheck 1 round 4's va, vb, vc and r_a, r_b, r_c, of every instance."""
    from spartan_tpu_torch.protocol import fused

    pairs0, fold, bsz = shape
    log_n, sc1 = 6, kernel == "sc1_tail"
    tabs, s, kbuf, kv, d, rounds = _batch_args(kernel, pairs0, fold, bsz, log_n, pairs0 * 13 + fold)
    _t, _s, pbuf, pv, _d, _r = _batch_args(kernel, pairs0, fold, bsz, log_n, pairs0 * 13 + fold)
    consts = fused.emit_consts(log_n + 2, "cpu")
    if sc1:
        ptrs = [*tabs, s[0], consts, kv["tor"][0], kv["pre"][0], kv["coef"][0], kv["state"][0], kv["evals"][0],
                kv["rs"][0], kv["r_mont"][0], kv["vabc"][0], kv["rabc"][0]]
    else:
        ptrs = [*tabs, kv["state"][0], kv["evals"][0], kv["rs"][0], kv["r_mont"][0]]
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    assert lib.host_tail(sc1, arr, pairs0, fold, rounds, d, bsz, s.stride(0) if sc1 else 0, kbuf.size) == 0
    if sc1:
        fused.sc1_tail_plain(*tabs, s, bool(fold), consts, pv["tor"][:, :rounds], pv["pre"], pv["coef"],
                             pv["state"], pv["evals"], pv["rs"], pv["r_mont"], pv["vabc"], pv["rabc"])
    else:
        fused.sc2_tail_plain(*tabs, bool(fold), pv["state"], pv["evals"], pv["rs"], pv["r_mont"])
    assert torch.equal(kbuf.dev, pbuf.dev)


def _words_of(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=np.uint32)


def _int_of(words: np.ndarray) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


@pytest.mark.parametrize("case", ["r-1 x 1", "r-1 x 32", "r-1 x 1024", "random x 37"])
def test_unreduced_sum_matches_python_ints(lib, case):
    """fr_sum.cuh's 9-word sum on the carry flag, summed across a warp, and
    its reduction: the exact sum and the sum mod r of Python integers, with
    every term r - 1 (the largest canonical value) at 2^k terms."""
    what, n = case.split(" x ")
    n = int(n)
    rng = random.Random(n)
    xs = [hf.R - 1] * n if what == "r-1" else [rng.randrange(hf.R) for _ in range(n)]
    terms = np.ascontiguousarray(np.stack([_words_of(x, 8) for x in xs]))
    acc, fr = np.zeros(9, dtype=np.uint32), np.zeros(8, dtype=np.uint32)
    assert lib.host_acc_sum(terms.ctypes.data, n, acc.ctypes.data, fr.ctypes.data) == 0
    assert _int_of(acc) == sum(xs)
    assert _int_of(fr) == sum(xs) % hf.R


@pytest.mark.parametrize("value", ["0", "r-1", "r", "2^256-1", "2^288-1", "random"])
def test_unreduced_sum_reduction_at_the_edges(lib, value):
    """acc_mul's reduction (the low 256 bits less r at most twice, and the
    top word times 2^256 mod r) against Python's mod r, at the edges of 9
    words."""
    x = {"0": 0, "r-1": hf.R - 1, "r": hf.R, "2^256-1": (1 << 256) - 1, "2^288-1": (1 << 288) - 1,
         "random": random.Random(41).randrange(1 << 288)}[value]
    fr = np.zeros(8, dtype=np.uint32)
    lib.host_mod_r9(_words_of(x, 9).ctypes.data, fr.ctypes.data)
    assert _int_of(fr) == x % hf.R
