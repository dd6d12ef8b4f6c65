"""The CUDA sources of the port's kernels, compiled for the host with g++
behind ``tests/cuda_host_shim.h`` and run on CPU threads, against the plain
PyTorch versions: the team point kernels (G1 add and 2^k-fold double, G2
add, mixed add and 2^k-fold double, at every team size, edge lanes included)
and both versions of the Fp Fermat inversion. This holds the kernels' own arithmetic, tables and edge rules on
the CPU. Every ``.cu`` file, entry points and launches included, also goes
through ``g++ -fsyntax-only`` with the CUDA runtime stubbed, which finds a
C++ error before a build on the card; whether nvcc accepts them, and how
fast they run, only ``chip_smoke.py`` on the card can say.
"""

import ctypes
import pathlib
import random
import re
import shutil
import subprocess

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
#include "team.cuh"
#include "fp_inv.cuh"

// op: 0 double, 1 add, 2 mixed add (team::Op); T: team size
#define CASE(G, TT, OP) \
  if (T == TT && op == OP) { shim_launch(blocks, kBlock, [&] { team_kernel<G, TT, OP>(p, q, out, n, k); }); return 0; }
extern "C" int host_g1(int op, int T, const uint32_t* p, const uint32_t* q, uint32_t* out,
                       int64_t n, int k) {
  using namespace team;
  const unsigned blocks = (unsigned)((n + kBlock / T - 1) / (kBlock / T));
  CASE(G1, 2, 0) CASE(G1, 2, 1) CASE(G1, 4, 0) CASE(G1, 4, 1) CASE(G1, 8, 0) CASE(G1, 8, 1)
  return 1;
}

extern "C" int host_g2(int op, int T, const uint32_t* p, const uint32_t* q, uint32_t* out,
                       int64_t n, int k) {
  using namespace team;
  const unsigned blocks = (unsigned)((n + kBlock / T - 1) / (kBlock / T));
  CASE(G2, 4, 0) CASE(G2, 4, 1) CASE(G2, 4, 2) CASE(G2, 8, 0) CASE(G2, 8, 1) CASE(G2, 8, 2)
  CASE(G2, 16, 0) CASE(G2, 16, 1) CASE(G2, 16, 2)
  return 1;
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
        if src.name == "team.cuh":  # dynamic shared memory: a static buffer
            dyn = "extern __shared__ uint4 smem[];"
            assert dyn in text
            text = text.replace(dyn, "static uint4 smem[16384];")
        (d / src.name).write_text(text)
    (d / "entry.cpp").write_text(ENTRY)
    so = d / "libcsrc_host.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-include", str(ROOT / "cuda_host_shim.h"), f"-I{d}", str(d / "entry.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_g1.argtypes = lib.host_g2.argtypes = [i32, i32, vp, vp, vp, i64, i32]
    lib.host_fp_inv.argtypes = [i32, vp, vp, i64]
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


@pytest.mark.parametrize("version", ["thread", "warp"])
def test_fp_inv_kernel_source_matches_plain_chain(lib, version):
    m = tf.FP.modulus
    xs = [0, m - 1, random.Random(3).randrange(m)]
    a = tf.encode_mont(tf.FP, xs)
    out = torch.zeros_like(a)
    lib.host_fp_inv(version == "warp", a.data_ptr(), out.data_ptr(), a.shape[1])
    assert torch.equal(out, tf.fermat_inv_plain(tf.FP, a))
    assert tf.decode_mont(tf.FP, out) == [pow(x, m - 2, m) for x in xs]
