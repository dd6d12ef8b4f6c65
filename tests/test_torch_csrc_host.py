"""The CUDA sources of the port's kernels, compiled for the host with g++
behind ``tests/cuda_host_shim.h`` and run on CPU threads, against the plain
PyTorch versions: the team point kernels (G1 and G2 add, mixed add and
2^k-fold double, at every team size, edge lanes included), the G1 mixed add
(one thread a point on the carry flag), the carry-flag Montgomery product
of fr_mul (and its Fp instantiation, the point kernels' product), both
versions of the Fp Fermat inversion, and the sumcheck-phase kernels: the
Blake2s of the transcript kernels against ``hashlib``, their sampler against
the host stream, the round kernels K6 and K7 (over several blocks, so the
partial sums run) and the transcript kernels K5 against their plain
versions. This holds the kernels' own arithmetic, tables and edge rules on
the CPU. Every ``.cu`` file, entry points and launches included, also goes
through ``g++ -fsyntax-only`` with the CUDA runtime stubbed, which finds a
C++ error before a build on the card; whether nvcc accepts them, and how
fast they run, only ``chip_smoke.py`` on the card can say.
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
#include "team.cuh"
#include "fp_inv.cuh"
#include "point.cuh"
#include "fr.cuh"
#include "fs.cuh"
#include "sumcheck.cuh"

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

// The round kernels at any block size and grid (the card's are sck::kThreads
// and round_blocks); t: the tables' inputs then outputs, as the entry points.
extern "C" int host_round(int sc1, const uint32_t* const* t, uint32_t* partials, int64_t pairs, int fold,
                          int threads, int blocks) {
  if (sc1)
    shim_launch(blocks, threads, [&] {
      sc1_round_kernel(t[0], t[1], t[2], t[3], t[4], (uint32_t*)t[5], (uint32_t*)t[6], (uint32_t*)t[7],
                       partials, pairs, fold);
    });
  else
    shim_launch(blocks, threads, [&] {
      prod2_round_kernel(t[0], t[1], t[2], (uint32_t*)t[3], (uint32_t*)t[4], partials, pairs, fold);
    });
  return 0;
}

extern "C" int host_fs_sc1_emit(const uint32_t* partials, const uint32_t* tor_i, const uint32_t* consts,
                                uint32_t* pre, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                                uint32_t* r_mont, int64_t nblocks, int D) {
  shim_launch(1, fs::kThreads, [&] {
    fs_sc1_emit_kernel(partials, tor_i, consts, pre, state, evals, r_out, r_mont, nblocks, D);
  });
  return 0;
}

extern "C" int host_fs_sc1_final(const uint32_t* az, const uint32_t* bz, const uint32_t* cz,
                                 const uint32_t* r_mont, uint32_t* state, uint32_t* vabc, uint32_t* rabc) {
  shim_launch(1, 32, [&] { fs_sc1_final_kernel(az, bz, cz, r_mont, state, vabc, rabc); });
  return 0;
}

extern "C" int host_fs_sc2_emit(const uint32_t* partials, uint32_t* state, uint32_t* evals, uint32_t* r_out,
                                uint32_t* r_mont, int64_t nblocks) {
  shim_launch(1, fs::kThreads, [&] { fs_sc2_emit_kernel(partials, state, evals, r_out, r_mont, nblocks); });
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
    lib.host_g1_madd.argtypes = [vp, vp, vp, i64]
    lib.host_mul_cc.argtypes = [i32, vp, vp, vp, i64]
    lib.host_fp_inv.argtypes = [i32, vp, vp, i64]
    lib.host_blake2s_batch.argtypes = [vp, vp, i64, i32]
    lib.host_sample_fr.argtypes = [vp, ctypes.c_uint32, vp]
    lib.host_sample_fr.restype = ctypes.c_uint32
    lib.host_round.argtypes = [i32, vp, vp, i64, i32, i32, i32]
    lib.host_fs_sc1_emit.argtypes = [vp] * 8 + [i64, i32]
    lib.host_fs_sc1_final.argtypes = [vp] * 7
    lib.host_fs_sc2_emit.argtypes = [vp] * 5 + [i64]
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


def _ptr(t: torch.Tensor) -> int:
    assert t.is_contiguous()
    return t.data_ptr()


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


# (pairs, threads a block, blocks, fold): the grid loop, and partials over several blocks
ROUND_SHAPES = [(4, 32, 1, 0), (64, 32, 3, 1), (64, 64, 2, 1)]


@pytest.mark.parametrize("shape", ROUND_SHAPES, ids=lambda s: "p{}-t{}-b{}-f{}".format(*s))
@pytest.mark.parametrize("kernel", ["sc1_round", "prod2_round"])
def test_round_kernel_sources_match_plain(lib, kernel, shape):
    """K6 and K7 (sumcheck.cuh): the folded tables and the partials' sum mod r
    against the plain round (ops.sumcheck with PLAIN), at 4 and 64 pairs."""
    from spartan_tpu_torch.ops import sumcheck as tsc

    pairs, threads, blocks, fold = shape
    rng = random.Random(pairs * 7 + fold)
    width = (4 if fold else 2) * pairs
    nt = 3 if kernel == "sc1_round" else 2
    tabs = [_fr_table(rng, width) for _ in range(nt)]
    s_tab = _fr_table(rng, pairs)
    r = _fr_table(rng, 1)
    outs = [torch.zeros((8, 2 * pairs), dtype=torch.int32) for _ in range(nt)]
    partials = torch.zeros((3, blocks, 8), dtype=torch.int32)
    ins = tabs + ([s_tab] if nt == 3 else []) + [r.t().contiguous()]
    ptrs = (ctypes.c_void_p * (2 * nt + len(ins) - nt))(*[_ptr(t) for t in ins + outs])
    assert lib.host_round(nt == 3, ptrs, _ptr(partials), pairs, fold, threads, blocks) == 0
    if nt == 3:
        q, *want = tsc.sc1_round(*tabs, s_tab, bool(fold), r, tsc.PLAIN)
    else:
        q, *want = tsc.prod2_round(*tabs, bool(fold), r, tsc.PLAIN)
    assert torch.equal(tf.sum_mod(partials.permute(2, 0, 1))[..., 0], q)
    if fold:
        assert all(torch.equal(o, x) for o, x in zip(outs, want))


@pytest.mark.parametrize("step", ["sc1_emit", "sc1_final", "sc2_emit"])
def test_transcript_kernel_sources_match_plain(lib, step):
    """K5 (fs.cuh) against protocol.fused's plain versions: every buffer it
    writes (evaluations, challenge canonical and Montgomery, pre, the chain
    state; round 4's va, vb, vc and r_a, r_b, r_c), from 5 partials."""
    from spartan_tpu_torch.protocol import fused

    rng = random.Random(len(step))
    el = lambda: _fr_table(rng, 1).t().contiguous()  # noqa: E731
    state = torch.from_numpy(np.frombuffer(bytes(rng.randrange(256) for _ in range(32)), dtype="<i4").copy())
    partials = _fr_table(rng, 15).t().reshape(3, 5, 8).contiguous()
    if step == "sc1_emit":
        log_n = 5
        consts = fused.emit_consts(log_n + 2, "cpu")
        args = {"partials": partials, "tor_i": el().reshape(8), "consts": consts, "pre": el().reshape(8),
                "state": state, "evals": torch.zeros((log_n + 3, 8), dtype=torch.int32),
                "r_out": torch.zeros(8, dtype=torch.int32), "r_mont": torch.zeros(8, dtype=torch.int32)}
        run = lambda a: lib.host_fs_sc1_emit(*[_ptr(t) for t in a.values()], 5, log_n + 3)  # noqa: E731
    elif step == "sc1_final":
        args = {"az": _fr_table(rng, 2), "bz": _fr_table(rng, 2), "cz": _fr_table(rng, 2),
                "r_mont": el().reshape(8), "state": state, "vabc": torch.zeros((3, 8), dtype=torch.int32),
                "rabc": torch.zeros((3, 8), dtype=torch.int32)}
        run = lambda a: lib.host_fs_sc1_final(*[_ptr(t) for t in a.values()])  # noqa: E731
    else:
        args = {"partials": partials, "state": state, "evals": torch.zeros((3, 8), dtype=torch.int32),
                "r_out": torch.zeros(8, dtype=torch.int32), "r_mont": torch.zeros(8, dtype=torch.int32)}
        run = lambda a: lib.host_fs_sc2_emit(*[_ptr(t) for t in a.values()], 5)  # noqa: E731
    kern = {k: v.clone() for k, v in args.items()}
    assert run(kern) == 0
    getattr(fused, step + "_plain")(*args.values())
    for k in args:
        assert torch.equal(kern[k], args[k]), k
