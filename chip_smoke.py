"""Drive the PyTorch/CUDA port of the Spartan prover once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (for the kernel build) and ``g++`` (for the
host library the verifier uses). Phases, each a plain call, so any failure
exits non-zero:

1. build the Hopper kernels from ``spartan_tpu_torch/csrc`` and print the
   build time and the card's name and power limit;
2. every entry point of the kernels K1-K4 against its plain PyTorch
   version on the card, on seeded random inputs plus the edge lanes (0, 1,
   m - 1; P + inf, inf + P, P + P, P + (-P)): bit-exact, and timed at 2^16
   lanes beside its bound; the G1 add at every width the 2^16 prove
   launches it at (1 to 521,701 lanes) and the double at 1 to 2^16 lanes
   (k = 1, 8 at 1 and 32), the G2 add and double at their widths (8 to
   2^16 lanes; k = 1, 4, 8 at 8, 28,672 and 2^16) and the G2 mixed add at
   8, 4,096, 2^16 and 1,029,085 lanes, beside their one-thread versions and
   every team size; the G1 mixed add at 2,048, 2^16 and 1,043,405 lanes
   (the prove's one launch) beside its team program at every team size and
   PR 1's one-thread kernel; the Fp inversion at 1, 16 and 4,096 lanes
   beside its one-thread version and the fp_mul chain it replaced; the
   field kernels' device time (a CUDA graph of 20 launches
   replayed between CUDA events) at 2^16 lanes and at the prove's most
   launched shape, and fr_mul's at every width the prove launches it at
   beside its version before the carry flag; then the sumcheck-phase
   kernels: K5's Blake2s (the yardstick blake2s_batch) against hashlib,
   the round kernels K6 and K7 with their transcript step (K5) at every
   width the 2^16 prove launches them at, and the one-block tails at the
   prove's one shape, all on their batch axis: each bit-exact against its
   plain version at 1, 3 and 64 instances (every instance's outputs:
   tables, evaluations, challenges, pre, the coefficients, the chain state,
   round 4's values; the ticket counters and sums back at 0) and timed by
   device time (CUDA graphs) at 1, 8 and 64 instances beside its bound;
   then K1 and K2 where the prover runs them whole (FUSED_KERNELS), each
   bit-exact against its plain version and timed by device time beside its
   bound: g1_normalize and g2_normalize at 1, 16, 4,096 and 2^16 lanes with
   infinity lanes, by width and on each path (one warp, one thread a
   point), beside the composition of fp_mul, fp_add, fp_sub and fp_inv
   launches they replaced; eq_tables at nv = 16 (the suffix set and
   eq_table); the quotient ladder at nv = 16 (five quot_level launches and
   the tail) and nv = 5 (the tail alone); fp_mul beside field.cuh's product
   (fp_mul_sum64), as fr_mul; nvidia-smi's clocks.sm sampled;
3. the 2^5 golden proof (circuit seed 3, key seed 7), with setup and index
   called without a device (they default to the card), must equal
   ``tests/fixtures/proof_2e5_seed3.bin``; then both sumcheck phases on the
   card must equal the JAX package's fused phases at log_n = 3..10
   (``tests/fixtures/sumcheck_phases_jax.json``; from log_n = 9 their first
   rounds are round launches of 8 and 16 blocks);
4. the full-size run: log_n = 16, density 0, 4 public inputs, circuit seed
   0; setup -> index -> prove -> verify, each timed; verify must accept,
   and reject a proof with one opening byte changed and a wrong public
   input; every kernel entry point of the path must have launched during
   the run (K6 and K7 once a round up to the tail, each tail once, at
   most 20 launches in the two phases, printed by entry point), but those
   whose prove work the fused kernels took over (fp_mul, fp_add, fp_inv:
   none a prove; fr_sub: at most 2); K1's and K2's launches a prove by
   entry point, at most 40 together; the proof's SHA-256 must equal
   ``tests/fixtures/proof_2e16_seed0.sha256``; fr_mul's
   device time summed over the prove's shapes, from phase 2, and fp_sub's
   at each width the prove launched it at, beside the bound; then the same
   prove through the host loop (SPARTAN_DEVICE_FS=0) on the same keys must
   give the same bytes, with both routes' spans and launches printed;
5. for each route, warm proves, then one under torch.profiler (device time
   by kernel, the card's busy and idle share, the copies from the device
   to the host in the prove and inside each sumcheck span); each of the
   device route's two phases must hold exactly one copy, at its end.
6. batched proving (``protocol/batched.py``): prove_many of 64 distinct
   instances of phase 4's circuit (circuit seeds 0..63 at density 0: one
   set of matrices, their own v and w, built in a pool of processes) on
   phase 4's pk and pp; every proof must equal the sequential prove of its
   instance byte for byte, verify must accept two and reject a tampered
   one; the batched prove's launches by entry point are printed and
   asserted (18 sumcheck launches on the batch-axis kernels, one
   g1_normalize and one g2_normalize a stage, every kernel of the path at
   least once); the warm batched and sequential wall time and proofs/s
   beside the card's name and power limit; the batched spans, and one
   batched prove under torch.profiler as in 5.

7. the sharded prove (``parallel/sharded_prove.py``): phase 4's instance
   on its pk and pp at D = 2 and 4 shards on the card (all on cuda:0, or
   one card a shard where there are D); the proof's SHA-256 must equal
   ``tests/fixtures/proof_2e16_seed0.sha256``, verify must accept it and
   reject it with one opening byte changed, every kernel of the path must
   launch (printed by entry point); the spans "Prove 1 (sharded)" ..
   "Prove 6 (sharded)" and the warm wall time beside phase 4's two routes
   on the same keys; then ``save_keys`` of those keys into a temporary
   directory and ``load_keys`` onto the card (times and the file's size):
   a prove with the reloaded keys must give the same SHA-256.

The line before the last is a JSON object with one entry per kernel entry
point (those whose work moved into the fused kernels, launched in no step
of phase 4's run, carry ``"main_path": false``; the launches are phase
4's); the last line is the contract object with the device.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "fixtures", "proof_2e5_seed3.bin")
# SHA-256 of phase 4's 2^16 proof as the port made it before the fused kernels (scripts/proof_sha.py)
PROOF_SHA = os.path.join(REPO, "tests", "fixtures", "proof_2e16_seed0.sha256")
# spartan_tpu's fused sumcheck phases at log_n = 3..10 (scripts/make_sumcheck_fixture.py)
PHASES_FIXTURE = os.path.join(REPO, "tests", "fixtures", "sumcheck_phases_jax.json")
TIMED_LANES = 1 << 16  # the width of the 2^16 tables; see PERF.md


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class SeededFr:
    """sample_fr() from a seeded stdlib generator (the tests' key stream)."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def sample_fr(self) -> int:
        from spartan_tpu_torch.host import field as hf

        return self._r.randrange(hf.R)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def direct(name: str, out: torch.Tensor, *ins: torch.Tensor, args=()):
    """A call of entry point ``name`` through ctypes on fixed tensors, with
    none of the wrapper's checks: timing it measures the kernel, not the host
    (a few microseconds a call). It counts no launch."""
    from spartan_tpu_torch import kernels

    fn = getattr(kernels.load(), "spk_" + name)
    ptrs = [t.data_ptr() for t in ins] + [out.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    n = out.shape[-1]

    def call():
        rc = fn(*ptrs, n, *args, stream)
        check(rc == 0, f"{name}: cudaGetLastError() = {rc}")

    return call


def graph_ms(name: str, out: torch.Tensor, *ins: torch.Tensor, args=(), launches: int = 20) -> float:
    """Device milliseconds a launch of entry point ``name``: a CUDA graph of
    ``launches`` direct calls replayed between CUDA events, so that the
    host's issue rate is not in it. It counts no launch."""
    from spartan_tpu_torch import kernels

    fn = getattr(kernels.load(), "spk_" + name)
    ptrs = [t.data_ptr() for t in ins] + [out.data_ptr()]
    n = out.shape[-1]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        rcs = [fn(*ptrs, n, *args, stream) for _ in range(launches)]
    check(not any(rcs), f"{name}: cudaGetLastError() = {max(rcs)} while captured")
    return cuda_ms(graph.replay, 5) / launches


class Card:
    """Rates of an H100 SXM for the bounds: 3.35 TB/s of device memory, and 32-bit products at 64 IMADs per SM per
    clock, two per 32x32->64 product, at the card's top SM clock; other 32-bit integer instructions (Blake2s's adds,
    xors and rotates) at the dispatch limit, one warp instruction a scheduler a clock: 128 per SM per clock."""

    MEM_BYTES_PER_S = 3.35e12

    def __init__(self):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True)
        self.max_sm_mhz = float(out.stdout.split()[0])
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.products_per_s = self.sms * 32 * self.max_sm_mhz * 1e6
        self.int_ops_per_s = self.sms * 128 * self.max_sm_mhz * 1e6

    def bound(self, products: float, nbytes: float, int_ops: float = 0.0):
        """(bound_ms, bound_by) for work of `products` 32x32->64 products
        and `int_ops` other 32-bit integer instructions that must move
        `nbytes` bytes."""
        t_ops = (products / self.products_per_s + int_ops / self.int_ops_per_s) * 1e3
        t_mem = nbytes / self.MEM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


class ClockSampler:
    """clocks.sm read by nvidia-smi every 200 ms while a phase runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [tuple(float(x) for x in line.split(",")) for line in out.splitlines()
                        if line.count(",") == 1 and "N/A" not in line]
        return False

    def summary(self) -> str:
        if not self.samples:
            return "clocks.sm: no samples"
        mhz = sorted(c for c, _w in self.samples)
        watts = max(w for _c, w in self.samples)
        return (f"clocks.sm over {len(mhz)} samples: min {mhz[0]:.0f} median "
                f"{mhz[len(mhz) // 2]:.0f} max {mhz[-1]:.0f} MHz; power.draw max {watts:.1f} W")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# 32x32->64 products per lane: an Fr product is 2 * 8^2, an Fp product
# 2 * 12^2; Fp2 multiply 3 Fp products (Karatsuba), Fp2 square 2.
FP_MUL, FP2_MUL, FP2_SQR = 288, 864, 576
# The Fermat inversion's chain (csrc/fp_inv.cuh): 14 table products, 380
# squares and 91 table products over p - 2.
FP_INV_PRODUCTS = 485
PRODUCTS = {
    "fr_mul": 128, "fp_mul": FP_MUL,
    "g1_double": 7 * FP_MUL, "g1_add": 16 * FP_MUL, "g1_madd": 11 * FP_MUL,
    "g2_double": 2 * FP2_MUL + 5 * FP2_SQR, "g2_add": 12 * FP2_MUL + 4 * FP2_SQR,
    "g2_madd": 8 * FP2_MUL + 3 * FP2_SQR, "fp_inv": FP_INV_PRODUCTS * FP_MUL,
}
# bytes a lane reads and writes: inputs once, the output once
LANE_BYTES = {
    "fr_mul": 96, "fr_add": 96, "fr_sub": 96, "fp_mul": 144, "fp_add": 144, "fp_sub": 144,
    "fp_inv": 96,
    "g1_madd": 432, "g1_add": 432, "g1_double": 288, "g2_madd": 864, "g2_add": 864,
    "g2_double": 576,
}
# G1 add and double widths. The add: every width the 2^16 prove launches it
# at (phase 4 prints them): the commit MSM's Horner step (1 lane), its
# weighted reduce (32 windows up to 2,048 = 32 x 64 bucket pairs) and its
# bucket sums (2,047 to 521,701, the widest launch), and 2^16. The double:
# the prove's widths (1 lane with k = 8, 32 with k = 1), 2,048 and 2^16.
G1_ADD_WIDEST = 521_701
G1_WIDTHS = {"add": (1, 32, 64, 128, 256, 512, 1024, 2047, 2048, 4069, 8137, 16_305, 32_607,
                     65_220, 1 << 16, 130_410, 260_855, G1_ADD_WIDEST),
             "double": (1, 32, 2048, 1 << 16)}
G1_KS = {1: (1, 8), 32: (1, 8)}  # k = 1 elsewhere
# G2 add and double widths: the openings' Horner steps (7-9 lanes), the
# weighted reduce (224 = 7 levels x 32 windows up to 28,672 = x 128 buckets),
# 2^16, and between them the widths where g2_team.cu changes team size.
G2_WIDTHS = (8, 64, 224, 1024, 4096, 16_384, 28_672, 1 << 16)
G2_KS = {8: (1, 4, 8), 28_672: (1, 4, 8), 1 << 16: (1, 4, 8)}  # k = 1 elsewhere
# G2 mixed add widths: small, 4,096, 2^16 and the openings' first bucket
# level at 2^16 (the widest launch of the prove)
G2_MADD_WIDTHS = (8, 4096, 1 << 16, 1_029_085)
# G1 mixed add widths: the prove's one launch (the commit MSM's first bucket
# level), 2^16 and 2,048
G1_MADD_WIDTHS = (2048, 1 << 16, 1_043_405)
TEAMS = {"g1": (2, 4, 8), "g2": (4, 8, 16)}  # team sizes each group's kernels take
TEAMS_OF = {"g1_madd": (2, 4)}  # a kernel's own, where they differ from its group's
# the field kernels' most launched shape in the 2^16 prove (phase 4 prints them); for fp_mul, fp_add and
# fr_sub, whose prove work moved into the fused kernels below, the shape they were launched at most before
FIELD_SHAPES = {"fr_mul": 32_768, "fr_add": 1 << 16, "fr_sub": 1, "fp_mul": 48, "fp_add": 16,
                "fp_sub": 32}
# every width the 2^16 prove launches fr_mul at (phase 4 prints them)
FR_MUL_WIDTHS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
                 1536, 2048, 3072, 4096, 6144, 8192, 12_288, 16_384, 24_576, 32_768, 49_152,
                 65_532, 1 << 16, 98_304, 163_829, 196_596)
FP_INV_LANES = (1, 16, 4096)  # the prover inverts 1 lane at a time


def _random_field(spec, n: int, rng: np.random.Generator, dev) -> torch.Tensor:
    """Seeded canonical elements: 0, 1, m - 1 first, then random limbs with
    the top limb masked below m."""
    from spartan_tpu_torch.ops import field as fo

    limbs = rng.integers(0, 1 << 32, size=(spec.nlimb, n), dtype=np.uint64).astype(np.uint32)
    top_bits = spec.modulus.bit_length() - 32 * (spec.nlimb - 1) - 1
    limbs[-1] &= np.uint32((1 << top_bits) - 1)
    edge = fo.ints_to_limbs([0, 1, spec.modulus - 1], spec.nlimb).view(np.uint32)
    limbs[:, :3] = edge
    return torch.from_numpy(limbs.view(np.int32).copy()).to(dev)


def _jacobian(aff, rng: np.random.Generator):
    """Each lane of an affine-encoded batch rescaled by its own random
    lambda, (x l^2, y l^3, z l): a distinct Jacobian representation."""
    from spartan_tpu_torch.ops import curve as cv
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FP

    n = aff.n
    lam = _random_field(FP, n + 3, rng, aff.device)[:, 3:]  # not 0, 1, m - 1: no zero scale
    lam2 = fo.mont_mul_plain(FP, lam, lam)
    lam3 = fo.mont_mul_plain(FP, lam2, lam)
    d = aff.data
    if aff.group == "g1":
        return cv.PointBatch(torch.stack([fo.mont_mul_plain(FP, d[0], lam2),
                                          fo.mont_mul_plain(FP, d[1], lam3),
                                          fo.mont_mul_plain(FP, d[2], lam)]), "g1")
    v = d.permute(1, 0, 2)
    x = fo.mont_mul_plain(FP, v[:, 0:2], lam2[:, None])  # both components
    y = fo.mont_mul_plain(FP, v[:, 2:4], lam3[:, None])
    z = fo.mont_mul_plain(FP, v[:, 4:6], lam[:, None])
    return cv.PointBatch(torch.cat([x, y, z], dim=1).permute(1, 0, 2).contiguous(), "g2")


def _random_points(group: str, n: int, rng: np.random.Generator, dev):
    """n Jacobian points p of ``group`` on the card, q affine-encoded, and
    the host twins of their first 8 lanes. 64 host points and their
    negations, encoded once and gathered on the card. From 8 lanes up,
    lanes 0-3 of (p, q) are the edge lanes inf + P, P + inf, P + P and
    P + (-P); narrower batches hold generic lanes only."""
    from spartan_tpu_torch.host import curve as hc
    from spartan_tpu_torch.host import field as hf
    from spartan_tpu_torch.ops import curve as cv

    ops = hc.G1 if group == "g1" else hc.G2
    gen = hf.G1_GEN if group == "g1" else hf.G2_GEN
    enc = cv.g1_encode if group == "g1" else cv.g2_encode
    base = [ops.mul(gen, 1 + int(rng.integers(1, 1 << 62)))]
    for _ in range(63):
        base.append(ops.add(base[-1], base[0]))
    table = base + [ops.neg(b) for b in base] + [None]  # 64 + i: -base[i]; 128: inf
    lanes = np.arange(n)
    pi, qi = lanes % 64, (7 * lanes + 3) % 64
    if n >= 8:
        pi[0] = 128  # inf + P
        qi[1] = 128  # P + inf
        qi[2] = pi[2]  # P + P
        qi[3] = 64 + pi[3]  # P + (-P)
    enc_table = enc(table, dev)
    p, q = (enc_table.take(torch.from_numpy(i).to(dev)) for i in (pi, qi))
    return (_jacobian(p, rng), q, [table[i] for i in pi[:8]], [table[i] for i in qi[:8]])


def _add_products(op: str, p, q) -> int:
    """Products the inputs need: none on a lane where P or Q is infinity, a
    double where P == Q, the add's own count elsewhere."""
    from spartan_tpu_torch.ops import curve as cv

    inf = cv.is_infinity(p) | cv.is_infinity(q)
    same = (cv.normalize(p).data == cv.normalize(q).data).reshape(-1, p.n).all(0) & ~inf
    n_same, n_inf = int(same.sum()), int(inf.sum())
    dbl = PRODUCTS[f"{p.group}_double"]
    return n_same * dbl + (p.n - n_same - n_inf) * PRODUCTS[f"{p.group}_{op}"]


def phase_kernels(dev, card: Card, seed: int = 1234) -> list:
    """Every entry point vs its plain version at TIMED_LANES lanes, and the
    team point kernels at the main path's widths beside their one-thread
    versions and every team size (the measurements behind g1_team.cu's and
    g2_team.cu's team sizes)."""
    from spartan_tpu_torch import kernels
    from spartan_tpu_torch.host import curve as hc
    from spartan_tpu_torch.ops import curve as cv
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FP, FR

    rng = np.random.default_rng(seed)
    n = TIMED_LANES
    rows = []

    def record(name, got, want, kernel_fn, plain_fn, products, nbytes):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        check(torch.equal(got, want), f"{name}: kernel disagrees with its plain version")
        ms = cuda_ms(kernel_fn, 20)
        plain_ms = cuda_ms(plain_fn, 2)
        bound_ms, bound_by = card.bound(products, nbytes)
        _n_in, src, rep = kernels.KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": f"spartan_tpu_torch/csrc/{src}",
                     "replaces": rep, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"kernel {name:10s} lanes={n} bit-exact  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        return rows[-1]

    for spec in (FR, FP):
        a = _random_field(spec, n, rng, dev)
        b = _random_field(spec, n, rng, dev)
        b[:, :3] = torch.flip(a[:, :3], dims=[1])  # (0, m-1), (1, 1), (m-1, 0)
        for op, wrap, plain in (("mul", fo.mont_mul, fo.mont_mul_plain),
                                ("add", fo.add, fo.add_plain),
                                ("sub", fo.sub, fo.sub_plain)):
            name = f"{spec.name}_{op}"
            got = wrap(spec, a, b)
            want = plain(spec, a, b)
            ints = fo.decode_ints(spec, got[:, :8])
            xs, ys = fo.decode_ints(spec, a[:, :8]), fo.decode_ints(spec, b[:, :8])
            m = spec.modulus
            host = {"mul": [x * y * spec.r_inv % m for x, y in zip(xs, ys)],
                    "add": [(x + y) % m for x, y in zip(xs, ys)],
                    "sub": [(x - y) % m for x, y in zip(xs, ys)]}[op]
            check(ints == host, f"{name}: first lanes disagree with Python integers")
            row = record(name, got, want, direct(name, torch.empty_like(a), a, b),
                         lambda: plain(spec, a, b), PRODUCTS.get(name, 0) * n, LANE_BYTES[name] * n)
            _field_device(card, row, a, b)
            if name == "fr_mul":
                wa, wb = (_random_field(spec, max(FR_MUL_WIDTHS), rng, dev) for _ in range(2))
                row["widths"] = [_fr_mul_width(card, lanes, wa[:, :lanes].contiguous(),
                                               wb[:, :lanes].contiguous()) for lanes in FR_MUL_WIDTHS]

    for group in ("g1", "g2"):
        ops = hc.G1 if group == "g1" else hc.G2
        dec = cv.g1_decode if group == "g1" else cv.g2_decode
        p, q, p_host, q_host = _random_points(group, n, rng, dev)
        qj = _jacobian(q, rng)  # Q with its own Z, for the full add
        cases = (
            ("madd", cv.add_mixed, cv.add_mixed_plain, (p, q)),
            ("add", cv.add, cv.add_plain, (p, qj)),
            ("double", cv.double, cv.double_plain, (p,)),
        )
        for op, wrap, plain, args in cases:
            name = f"{group}_{op}"
            got = wrap(*args)
            want = plain(*args)
            oracle = [ops.double(p_host[i]) if op == "double" else ops.add(p_host[i], q_host[i])
                      for i in range(8)]
            check(dec(got.take(slice(0, 8))) == oracle,
                  f"{name}: edge and first lanes disagree with the host oracle")
            ins = [a.data for a in args]
            nbytes = LANE_BYTES[name] * n
            products = PRODUCTS[name] * n if op == "double" else _add_products(op, *args)
            extra = (1,) if op == "double" else ()
            record(name, got.data, want.data, direct(name, torch.empty_like(ins[0]), *ins, args=extra),
                   lambda: plain(*args), products, nbytes)

    by_name = {r["name"]: r for r in rows}

    def sweep(group, op, widths, ks):
        for lanes in widths:
            for k in ks.get(lanes, (1,)):
                by_name[f"{group}_{op}"].setdefault("widths", []).append(
                    _team_width(card, group, op, lanes, k, rng, dev))

    for op, widths in G1_WIDTHS.items():
        sweep("g1", op, widths, G1_KS if op == "double" else {})
    sweep("g2", "add", G2_WIDTHS, {})
    sweep("g2", "double", G2_WIDTHS, G2_KS)
    sweep("g2", "madd", G2_MADD_WIDTHS, {})
    sweep("g1", "madd", G1_MADD_WIDTHS, {})
    rows.append(_fp_inv_row(card, rng, dev))
    return rows


def _field_device(card: Card, row: dict, a: torch.Tensor, b: torch.Tensor) -> None:
    """A field kernel's device time at the row's 2^16 lanes and at the
    prove's most launched shape (the first lanes of a and b), beside the
    bound there; fr_mul's and fp_mul's also beside their version before the
    carry flag (field.cuh's product, the yardsticks *_sum64)."""
    name = row["name"]
    lanes = min(FIELD_SHAPES[name], a.shape[1])
    a1, b1 = a[:, :lanes].contiguous(), b[:, :lanes].contiguous()
    row["device_ms"] = graph_ms(name, torch.empty_like(a), a, b)
    row["shape"] = {"lanes": lanes, "device_ms": graph_ms(name, torch.empty_like(a1), a1, b1),
                    "bound_ms": card.bound(PRODUCTS.get(name, 0) * lanes, LANE_BYTES[name] * lanes)[0]}
    line = (f"field {name:7s} device ms (CUDA graph of 20): lanes={a.shape[1]} {row['device_ms']:.5f} "
            f"(bound {row['bound_ms']:.5f}, direct calls {row['ms']:.5f}); lanes={lanes} "
            f"{row['shape']['device_ms']:.5f} (bound {row['shape']['bound_ms']:.2e})")
    if name in ("fr_mul", "fp_mul"):
        row["sum64_device_ms"] = graph_ms(f"{name}_sum64", torch.empty_like(a), a, b)
        row["shape"]["sum64_device_ms"] = graph_ms(f"{name}_sum64", torch.empty_like(a1), a1, b1)
        line += (f"; before the carry flag {row['sum64_device_ms']:.5f} and "
                 f"{row['shape']['sum64_device_ms']:.5f}")
    print(line, flush=True)


def _fr_mul_width(card: Card, lanes: int, a: torch.Tensor, b: torch.Tensor) -> dict:
    """fr_mul at ``lanes`` lanes, the entry point and its version before the
    carry flag (field.cuh's product), each bit-exact against the plain
    version, by device time."""
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FR

    want = fo.mont_mul_plain(FR, a, b)
    row = {"lanes": lanes}
    for label, name in (("device_ms", "fr_mul"), ("sum64_device_ms", "fr_mul_sum64")):
        out = torch.zeros_like(a)
        direct(name, out, a, b)()
        check(torch.equal(out, want), f"fr_mul lanes={lanes} {name}: disagrees with the plain version")
        row[label] = graph_ms(name, out, a, b)
    row["bound_ms"], row["bound_by"] = card.bound(PRODUCTS["fr_mul"] * lanes, LANE_BYTES["fr_mul"] * lanes)
    print(f"fr_mul lanes={lanes} bit-exact, device ms: entry {row['device_ms']:.5f}  before the carry "
          f"flag {row['sum64_device_ms']:.5f}  bound {row['bound_ms']:.2e} ({row['bound_by']})", flush=True)
    return row


def _team_versions(name: str, ins, k: int, teams) -> list:
    """(label, call, result) for the entry point, every team size and the
    one-thread kernel of ``name`` on inputs ``ins``; a k-fold double's
    one-thread version is k launches, each doubling the last result."""
    double = name.endswith("_double")
    args = (k,) if double else ()
    new = lambda: torch.empty_like(ins[0])  # noqa: E731
    out = new()
    versions = [("entry", direct(name, out, *ins, args=args), out)]
    for team in teams:
        out = new()
        versions.append((f"team{team}", direct(f"{name}_team", out, *ins, args=args + (team,)), out))
    if not double:
        out = new()
        versions.append(("onethread", direct(f"{name}_onethread", out, *ins), out))
    else:
        a, b = new(), new()
        chain = [direct(f"{name}_onethread", a if i % 2 == 0 else b,
                        ins[0] if i == 0 else (b if i % 2 == 0 else a)) for i in range(k)]
        versions.append(("onethread", lambda: [c() for c in chain], a if k % 2 else b))
    return versions


def _team_width(card: Card, group: str, op: str, lanes: int, k: int, rng, dev) -> dict:
    """An add, mixed add (k = 1) or k-fold double of ``group`` at ``lanes``
    lanes: the entry point, every team size and the one-thread kernel, each
    bit-exact against the plain version, edge lanes included (a width under
    8 lanes is also checked at 8, where the edge lanes are), and timed
    beside the bound."""
    from spartan_tpu_torch.ops import curve as cv

    name = f"{group}_{op}"
    label = f"{name} lanes={lanes} k={k}"
    for n in (8, lanes) if lanes < 8 else (lanes,):
        p, q, _ph, _qh = _random_points(group, n, rng, dev)
        if op == "double":
            ins, got = (p.data,), cv.double(p, k).data
            plain_fn = lambda: cv.double_plain(p, k)  # noqa: E731
            products = PRODUCTS[name] * n * k
        else:  # the mixed add takes Q affine-encoded, the add with its own Z
            wrap, plain = (cv.add_mixed, cv.add_mixed_plain) if op == "madd" else (cv.add, cv.add_plain)
            q2 = q if op == "madd" else _jacobian(q, rng)
            ins, got = (p.data, q2.data), wrap(p, q2).data
            plain_fn = lambda: plain(p, q2)  # noqa: E731
            products = _add_products(op, p, q2)
        want = plain_fn().data
        check(torch.equal(got, want), f"{label}: kernel disagrees with its plain version ({n} lanes)")
        teams = TEAMS_OF.get(name, TEAMS[group])
        versions = _team_versions(name, ins, k, teams)
        for what, call, out in versions:
            out.zero_()
            call()
            check(torch.equal(out, want), f"{label} {what}: disagrees with the plain version ({n} lanes)")
    row = {"lanes": lanes, "k": k}
    for what, call, _out in versions:
        row["ms" if what == "entry" else f"{what}_ms"] = cuda_ms(call, 20)
    row["plain_ms"] = cuda_ms(plain_fn, 1 if lanes > 1 << 17 else 2 if lanes > 1024 else 5)
    row["bound_ms"], row["bound_by"] = card.bound(products, LANE_BYTES[name] * lanes)
    print(f"{label} bit-exact (entry, teams, one-thread): entry {row['ms']:.4f} ms  "
          + "  ".join(f"T={t} {row[f'team{t}_ms']:.4f}" for t in teams)
          + f"  one-thread {row['onethread_ms']:.4f}  plain {row['plain_ms']:.3f}  "
          f"bound {row['bound_ms']:.2e} ms ({row['bound_by']})", flush=True)
    return row


def _fp_inv_row(card: Card, rng, dev) -> dict:
    """fp_inv (one warp a lane) at FP_INV_LANES lanes beside its one-thread
    version and the chain of fp_mul launches it replaced (pow_const over the
    kernel wrapper, host time included), each bit-exact against the plain
    chain, whose first 16 lanes are held against Python integers. The row's
    own numbers are those at 1 lane, the prover's."""
    from spartan_tpu_torch import kernels
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FP

    m = FP.modulus
    pool = _random_field(FP, max(FP_INV_LANES) + 3, rng, dev)  # lanes 0-2: 0, 1, m - 1
    row, widths = None, []
    for lanes in FP_INV_LANES:
        a = pool[:, :lanes].contiguous() if lanes > 1 else pool[:, 3:4].contiguous()
        want = fo.fermat_inv_plain(FP, a)
        check(fo.decode_mont(FP, want[:, :16]) == [pow(x, m - 2, m) for x in fo.decode_mont(FP, a[:, :16])],
              f"fp_inv lanes={lanes}: the plain chain disagrees with Python integers")
        got = fo.fermat_inv(FP, a)
        check(torch.equal(got, want), f"fp_inv lanes={lanes}: kernel disagrees with its plain version")
        check(torch.equal(fo.pow_const(FP, a, m - 2), want),
              f"fp_inv lanes={lanes}: the fp_mul chain disagrees with the plain version")
        out = torch.empty_like(a)
        w = {"lanes": lanes, "ms": cuda_ms(direct("fp_inv", out, a), 20)}
        call = direct("fp_inv_thread", out, a)
        out.zero_()
        call()
        check(torch.equal(out, want), f"fp_inv_thread lanes={lanes}: disagrees with the plain version")
        w["thread_ms"] = cuda_ms(call, 20)
        w["fp_mul_chain_ms"] = cuda_ms(lambda: fo.pow_const(FP, a, m - 2), 3)
        w["plain_ms"] = cuda_ms(lambda: fo.fermat_inv_plain(FP, a), 1)
        w["bound_ms"], w["bound_by"] = card.bound(PRODUCTS["fp_inv"] * lanes, LANE_BYTES["fp_inv"] * lanes)
        print(f"fp_inv lanes={lanes} bit-exact (entry, one-thread, fp_mul chain): entry {w['ms']:.4f} ms  "
              f"one-thread {w['thread_ms']:.4f}  fp_mul chain "
              f"{w['fp_mul_chain_ms']:.4f} (609 launches, host included)  plain {w['plain_ms']:.1f}  "
              f"bound {w['bound_ms']:.2e} ms ({w['bound_by']})", flush=True)
        widths.append(w)
        if row is None:
            _n_in, src, rep = kernels.KERNELS["fp_inv"]
            row = {"name": "fp_inv", "route": "cuda", "source": f"spartan_tpu_torch/csrc/{src}",
                   "replaces": rep, "max_abs_err": 0, "ms": w["ms"], "plain_ms": w["plain_ms"],
                   "bound_ms": w["bound_ms"], "bound_by": w["bound_by"], "library_ms": None}
    row["widths"] = widths
    return row


# ---------------------------------------------------------------------------
# Phase 2, continued: the sumcheck-phase kernels K5-K7
# ---------------------------------------------------------------------------

FS_LOG_N = 16  # the full run's log_n: the rounds' widths and a round's evaluations
PHASE_PATH = ("sc1_round", "prod2_round", "sc1_tail", "sc2_tail")
FR_PRODUCT = 128  # 32x32->64 products of an Fr product
# 32-bit instructions a Blake2s compression needs at least: 10 rounds x 8 G x 12 (two three-input adds,
# two adds, four xors, four rotates), and 8 three-input xors to finish
B2S_OPS = 968
B2S_WORDS = (0, 1, 10, 16, 17, 32, 162)  # block edges, round 4's 32 words, a 2^16 sumcheck-1 round's 162
B2S_COUNT = 4096  # messages a width in the check against hashlib
B2S_TIMED = 1 << 16  # messages of 162 words in the timed launch


def _phase_call(name: str, tensors, ints):
    """A direct call of PHASE_KERNELS entry ``name`` on fixed tensors, with
    none of the wrapper's checks. It counts no launch."""
    from spartan_tpu_torch import kernels

    fn = getattr(kernels.load(), "spk_" + name)
    ptrs = [t.data_ptr() for t in tensors]

    def call():
        rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{name}: cudaGetLastError() = {rc}")

    return call


def _graph_ms_of(call, launches: int = 20) -> float:
    """Device milliseconds a call: a CUDA graph of ``launches`` calls replayed
    between CUDA events."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            call()
    return cuda_ms(graph.replay, 5) / launches


def _compressions(nwords: int) -> int:
    return max(1, -(-nwords // 16))


def _blake2s_yardstick(card: Card, rng, dev) -> None:
    """K5's Blake2s as blake2s_batch (a thread a message) against hashlib at
    B2S_WORDS words, every message of B2S_COUNT, and its device time for
    B2S_TIMED messages of a 2^16 sumcheck-1 round's 162 words."""
    import hashlib

    from spartan_tpu_torch.ops import blake2s as b2s

    for nwords in B2S_WORDS:
        msgs = rng.integers(0, 1 << 32, size=(B2S_COUNT, nwords), dtype=np.uint64).astype(np.uint32)
        got = b2s.blake2s_batch(torch.from_numpy(msgs.view(np.int32)).to(dev)).cpu().numpy().view(np.uint32)
        bad = [i for i in range(B2S_COUNT) if got[i].astype("<u4").tobytes()
               != hashlib.blake2s(msgs[i].astype("<u4").tobytes()).digest()]
        check(not bad, f"blake2s_batch nwords={nwords}: {len(bad)} of {B2S_COUNT} digests differ from hashlib")
    nwords = B2S_WORDS[-1]
    msgs = torch.from_numpy(rng.integers(0, 1 << 32, size=(B2S_TIMED, nwords), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    out = torch.empty((B2S_TIMED, 8), dtype=torch.int32, device=dev)
    ms = _graph_ms_of(_phase_call("blake2s_batch", [msgs, out], [B2S_TIMED, nwords]))
    bound, by = card.bound(0, B2S_TIMED * (nwords + 8) * 4, B2S_TIMED * _compressions(nwords) * B2S_OPS)
    print(f"blake2s_batch (yardstick) equals hashlib at {list(B2S_WORDS)} words, {B2S_COUNT} messages each; "
          f"{B2S_TIMED} messages of {nwords} words: device {ms:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)


def _fr_rows(n: int, rng, dev) -> torch.Tensor:
    """n seeded Montgomery elements, (8, n)."""
    from spartan_tpu_torch.ops.field import FR

    return _random_field(FR, n + 3, rng, dev)[:, 3:].contiguous()


def _phase_cost(name: str, pairs: int, fold: bool):
    """(Fr products, bytes) of one instance's launch of these arguments:
    each table read once, the folded tables and the transcript step's
    outputs written once. A tail is its rounds' sum."""
    sc1 = name.startswith("sc1")
    nt, d = (3, FS_LOG_N + 3) if sc1 else (2, 3)
    products = nbytes = 0
    rounds = [(pairs, fold)] if name.endswith("round") else [(pairs >> k, fold or k > 0)
                                                              for k in range(pairs.bit_length())]
    for p, f in rounds:
        # the pairs' folds and terms; the step's: sumcheck 1 six an evaluation, the next round's sixteen
        # (brackets and K), and five more; sumcheck 2 six and one
        products += p * ((2 * nt if f else 0) + (6 if sc1 else 3)) + (22 * d + 5 if sc1 else 7)
        nbytes += 32 * (nt * (4 if f else 2) * p + (p if sc1 else 0) + (5 * d if sc1 else 0) + d + 3)
        if name.endswith("round"):
            nbytes += 32 * nt * 2 * p * f
    return products, nbytes


def _draws(state: torch.Tensor, n: int = 1) -> int:
    """Blocks of the output stream that n samples from the chain state
    `state` took, rejected ones included."""
    from spartan_tpu_torch.ops import fs_device as fsd

    st, draws = fsd.as_words(state.cpu().reshape(-1)), 0
    for _ in range(n):
        _r, draws = fsd.fs_sample_fr(st, draws)
    return draws


BATCH_B = 64  # the batched phase's instances: BASELINE.json:11's 64 independent 2^16 instances
BATCH_CHECK_B = (1, 3, 64)  # instances a launch is held bit-exact at (1: the single prove)
BATCH_TIMED_B = (1, 8, 64)  # and timed at; the row's numbers are those at BATCH_B


def _phase_widths(name: str):
    """(pairs, fold) of every launch of `name` in a 2^16 prove, single or
    batched (protocol.fused's schedule: the rounds up to the tail, then the
    tail)."""
    from spartan_tpu_torch.protocol import fused

    i0 = fused.tail_start(FS_LOG_N)
    if "tail" in name:
        return [(1 << (FS_LOG_N - 1 - i0), i0 > 0)]
    return [(1 << (FS_LOG_N - 1 - i), i > 0) for i in range(i0)]


def _phase_args(name: str, pairs: int, fold: bool, bsz: int, seed: int, dev) -> dict:
    """Seeded arguments of a launch of `name` for bsz instances, laid out
    as protocol.fused's phases lay them out: tables (B, 8,
    n); the weights at an instance stride of their own, wider than a
    table's; the transcript arrays views of one fused._Buffer with a copy an
    instance. The same seed gives the same arguments."""
    from spartan_tpu_torch.protocol import fused

    rng = np.random.default_rng(seed)
    sc1, tail = name.startswith("sc1"), "tail" in name
    rounds, d = (pairs.bit_length() if tail else 1), (FS_LOG_N + 3 if sc1 else 3)
    width = (4 if fold else 2) * pairs

    def rows(n):  # (B, 8, n) seeded elements
        return _fr_rows(bsz * n, rng, dev).view(8, bsz, n).transpose(0, 1).contiguous()

    a = {"tabs": [rows(width) for _ in range(3 if sc1 else 2)], "fold": fold, "rounds": rounds, "d": d}
    if sc1:
        ws = torch.cat([rows(pairs >> k).reshape(bsz, -1) for k in range(rounds)], dim=1)
        wide = torch.zeros((bsz, ws.shape[1] + 64), dtype=torch.int32, device=dev)
        wide[:, : ws.shape[1]] = ws
        a["s"] = wide[:, : ws.shape[1]] if tail else wide[:, : ws.shape[1]].view(bsz, 8, pairs)
    parts = [("state", 1), ("evals", rounds * d), ("rs", rounds), ("r_mont", 1), ("ctr", 1),
             ("sums", fused.SUMS_ROWS)]
    if sc1:
        parts += [("tor", rounds + 1), ("pre", 1), ("coef", 6 * d), ("vabc", 3), ("rabc", 3)]
    buf = fused._Buffer(parts, bsz)
    buf.set("state", rng.integers(0, 1 << 32, size=(bsz, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    for name_ in ("r_mont",) + (("tor", "pre") if sc1 else ()):
        count = buf.offsets[name_][1]
        buf.set(name_, _fr_rows(bsz * count, rng, torch.device("cpu")).t().numpy())
    if sc1:
        buf.set("coef", np.stack([fused._words(fused.first_coef(int(rng.integers(1 << 62)), d - 1))
                                  for _ in range(bsz)]))
    buf.upload(dev)
    a["buf"] = buf
    return a


def _run(name: str, a: dict, plain: bool):
    """The wrapper (a launch, counted) or its plain version on `a`, in
    place; returns the tables a round hands on."""
    from spartan_tpu_torch.protocol import fused

    buf, rounds = a["buf"], a["rounds"]
    v = {k: buf.views(k) for k in buf.offsets}
    evals = v["evals"].view(buf.copies, rounds, a["d"], 8)
    consts = fused.emit_consts(FS_LOG_N + 2, a["tabs"][0].device)
    if name == "sc1_round":
        args = (*a["tabs"], a["s"], a["fold"], consts, v["tor"][:, 0], v["tor"][:, 1], v["pre"],
                v["coef"].view(buf.copies, 6, a["d"], 8), v["state"], evals[:, 0], v["rs"][:, 0], v["r_mont"])
    elif name == "prod2_round":
        args = (*a["tabs"], a["fold"], v["state"], evals[:, 0], v["rs"][:, 0], v["r_mont"])
    elif name == "sc1_tail":
        args = (*a["tabs"], a["s"], a["fold"], consts, v["tor"][:, :rounds], v["pre"],
                v["coef"].view(buf.copies, 6, a["d"], 8), v["state"], evals, v["rs"], v["r_mont"], v["vabc"],
                v["rabc"])
    else:
        args = (*a["tabs"], a["fold"], v["state"], evals, v["rs"], v["r_mont"])
    if plain:
        return getattr(fused, name + "_plain")(*args)
    if name.endswith("round"):
        return getattr(fused, name)(*args, v["ctr"], v["sums"])
    return getattr(fused, name)(*args)


def _phase_row(name: str, card: Card, dev, seed: int = 8642) -> dict:
    """A sumcheck-phase kernel against its plain version (each instance's
    plain round or tail) at B in BATCH_CHECK_B, at every width the 2^16
    prove launches it at: every instance's outputs
    bit-exact (tables, evaluations, challenges, pre, coefficients, chain
    state, round 4's values; the ticket counters and sums back at 0). Its
    device time (CUDA graph of 20 wrapper calls) at B in BATCH_TIMED_B,
    and the bound, each instance's work as the single rows count it; the
    row's numbers at BATCH_B and the first width."""
    from spartan_tpu_torch import kernels

    sc1 = name.startswith("sc1")
    row, widths = None, []
    for pairs, fold in _phase_widths(name):
        for bsz in sorted(set(BATCH_CHECK_B) | set(BATCH_TIMED_B)):
            wseed = seed + 131 * pairs + 7 * bsz + int(fold)
            mine = _phase_args(name, pairs, fold, bsz, wseed, dev)
            got = _run(name, mine, False)
            w = {"pairs": pairs, "fold": fold, "B": bsz}
            if bsz in BATCH_CHECK_B:
                ref = _phase_args(name, pairs, fold, bsz, wseed, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                want = _run(name, ref, True)
                torch.cuda.synchronize()
                w["plain_ms"] = (time.perf_counter() - t) * 1e3
                same = torch.equal(mine["buf"].dev, ref["buf"].dev)
                if name.endswith("round") and fold:
                    same = same and all(torch.equal(x, y) for x, y in zip(got, want))
                check(same, f"{name} pairs={pairs} fold={fold} B={bsz}: kernel disagrees with its plain version")
                ctr = mine["buf"].views("ctr")
                check(not ctr.any() and not mine["buf"].views("sums").any(),
                      f"{name} pairs={pairs} B={bsz}: ticket counters or sums not back at 0")
            if bsz in BATCH_TIMED_B:
                w["device_ms"] = _graph_ms_of(lambda: _run(name, mine, False))
                if bsz == BATCH_B:
                    w["ms"] = cuda_ms(lambda: _run(name, mine, False), 10)
            # each instance's work (_phase_cost) and compressions, its draws from its chain state
            states = mine["buf"].views("state").reshape(bsz, 8).cpu()
            n_rounds = 1 if name.endswith("round") else pairs.bit_length()
            msg_words = 10 + 8 * ((FS_LOG_N + 3) if sc1 else 3)
            compressions = bsz * n_rounds * _compressions(msg_words)
            for st in states:
                if name.endswith("round"):
                    compressions += _draws(st)
                else:
                    compressions += n_rounds + (_compressions(32) + _draws(st, 3) if sc1 else 0)
            products, nbytes = _phase_cost(name, pairs, fold)
            w["bound_ms"], w["bound_by"] = card.bound(bsz * products * FR_PRODUCT, bsz * nbytes,
                                                      compressions * B2S_OPS)
            print(f"{name} pairs={pairs} fold={int(fold)} B={bsz}"
                  + (" bit-exact" if bsz in BATCH_CHECK_B else "")
                  + (f": device {w['device_ms']:.5f} ms" if "device_ms" in w else "")
                  + (f", plain {w['plain_ms']:.1f} ms" if "plain_ms" in w else "")
                  + f", bound {w['bound_ms']:.5f} ms ({w['bound_by']})", flush=True)
            widths.append(w)
            if row is None and bsz == BATCH_B:
                src, rep, _nt, _ni = kernels.PHASE_KERNELS[name]
                row = {"name": name, "route": "cuda", "source": f"spartan_tpu_torch/csrc/{src}", "replaces": rep,
                       "max_abs_err": 0, "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
                       "bound_by": w["bound_by"], "library_ms": None, "device_ms": w["device_ms"], "B": bsz}
            del mine
    row["widths"] = widths
    for bsz in BATCH_TIMED_B:
        at = [x for x in widths if x["B"] == bsz]
        print(f"{name} B={bsz} over the 2^16 prove's {len(at)} launches by device time: "
              f"{sum(x['device_ms'] for x in at):.4f} ms, bound {sum(x['bound_ms'] for x in at):.5f} ms", flush=True)
    return row


def phase_fs_kernels(dev, card: Card, seed: int = 4321) -> list:
    """The sumcheck-phase kernels: K5's Blake2s against hashlib
    (blake2s_batch), then K6 and K7 with their transcript step and the
    tails at the 2^16 prove's widths, each bit-exact against its plain
    version on the card at 1, 3 and 64 instances."""
    _blake2s_yardstick(card, np.random.default_rng(seed), dev)
    return [_phase_row(name, card, dev) for name in PHASE_PATH]


# ---------------------------------------------------------------------------
# Phase 2, continued: K1 and K2 run whole where the prover calls them (FUSED_KERNELS)
# ---------------------------------------------------------------------------

# normalize's widths: the prove's (1 G1 point, 16 G2 points), and setup's from 4,096 (the thread path)
NORMALIZE_LANES = (1, 16, 4096, 1 << 16)
NORMALIZE_FIRST = {"g1": 1, "g2": 16}  # the width of the row's own numbers: the prove's
# Fp products a finite point: the Fermat chain, then G1 z^-2, z^-3, x, y; G2 the norm (2), z^-1 (2) and
# four Fp2 products (3 each)
NORMALIZE_PRODUCTS = {"g1": FP_INV_PRODUCTS + 4, "g2": FP_INV_PRODUCTS + 16}
EQ_NV = 16  # the prove's eq tables (rounds 3 and 5) and setup's suffix set
LADDER_NVS = (16, 5)  # an opening of the 2^16 prove (level launches and the tail) and a tail alone
FUSED_PATH = ("g1_normalize", "g2_normalize", "eq_tables", "quot_level", "quot_tail")
# K1's and K2's entry points, the fused ones included, and the most launches of them a 2^16 prove may take
K12 = {"K1": ("fr_mul", "fr_add", "fr_sub", "eq_tables", "quot_level", "quot_tail"),
       "K2": ("fp_mul", "fp_add", "fp_sub", "fp_inv", "g1_normalize", "g2_normalize")}
K12_MAX = 40
# entry points whose prove work the fused kernels took over, and the most launches a prove may still take
MOVED = {"fp_mul": 0, "fp_add": 0, "fp_inv": 0, "fr_sub": 2}


def _fp_kernel_ops():
    """The Fp operations normalize composed before its kernel: the wrappers
    of fp_add, fp_sub, fp_mul and fp_inv (each call a launch, counted)."""
    from functools import partial

    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops import fp2
    from spartan_tpu_torch.ops.field import FP

    return fp2.FpOps(partial(fo.add, FP), partial(fo.sub, FP), partial(fo.mont_mul, FP),
                     partial(fo.fermat_inv, FP))


def _fused_row(name: str, ms: float, plain_ms: float, bound, widths: list) -> dict:
    from spartan_tpu_torch import kernels

    src, rep, _nt, _ni = kernels.FUSED_KERNELS[name]
    return {"name": name, "route": "cuda", "source": f"spartan_tpu_torch/csrc/{src}", "replaces": rep,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None, "device_ms": widths[0]["device_ms"], "widths": widths}


def _normalize_points(group: str, n: int, rng, dev):
    """n Jacobian points of ``group`` on the card and the host twins of their
    first 8 lanes. One lane is a finite point; from 8 lanes lane 0 is
    infinity (z = 0), and from 4,096 lanes so is every 97th lane, its x and
    y left non-zero."""
    p, _q, p_host, _qh = _random_points(group, max(n, 8), rng, dev)
    if n == 1:
        return p.take(slice(4, 5)), p_host[4:5]
    p = p.take(slice(0, n))
    data = p.data.contiguous()
    if n >= 4096:
        data[2 if group == "g1" else 4:, :, ::97] = 0
    return type(p)(data, group), [None if i % 97 == 0 and n >= 4096 else h for i, h in enumerate(p_host)]


def _normalize_row(group: str, card: Card, rng, dev) -> dict:
    """g1_normalize or g2_normalize at NORMALIZE_LANES lanes: bit-exact
    against normalize_plain (the first lanes also against the host), the
    entry point and both its paths (one warp, one thread a point) by device
    time beside the bound, and the composition of Fp launches it replaced
    (host included)."""
    from spartan_tpu_torch.ops import curve as cv

    name = f"{group}_normalize"
    dec = cv.g1_decode if group == "g1" else cv.g2_decode
    widths = []
    for n in NORMALIZE_LANES:
        p, host = _normalize_points(group, n, rng, dev)
        want = cv.normalize_plain(p).data
        got = cv.normalize(p).data
        check(torch.equal(got, want), f"{name} lanes={n}: kernel disagrees with its plain version")
        check(dec(cv.PointBatch(got[..., :8], group)) == host[:8],
              f"{name} lanes={n}: first lanes disagree with the host points")
        src = p.data.contiguous()
        finite = int((~cv.is_infinity(p)).sum())
        w = {"lanes": n, "infinity": n - finite}
        for label, path in (("device_ms", 0), ("warp_ms", 1), ("thread_ms", 2)):
            out = torch.full_like(src, -1)
            call = _phase_call(name, [src, out], [n, path])
            call()
            check(torch.equal(out, want), f"{name} lanes={n} path={path}: disagrees with the plain version")
            w[label] = _graph_ms_of(call, 20 if n <= 4096 else 3)
        old = cv.normalize_plain(p, _fp_kernel_ops())
        check(torch.equal(old.data, want), f"{name} lanes={n}: the Fp launches' composition disagrees")
        w["fp_launches_ms"] = cuda_ms(lambda: cv.normalize_plain(p, _fp_kernel_ops()), 3)
        w["plain_ms"] = cuda_ms(lambda: cv.normalize_plain(p), 1)
        # every coordinate read and written once, 48 bytes an Fp
        w["bound_ms"], w["bound_by"] = card.bound(NORMALIZE_PRODUCTS[group] * FP_MUL * finite,
                                                  2 * 48 * src.shape[0] * n)
        print(f"{name} lanes={n} (infinity {w['infinity']}) bit-exact (entry, warp, thread, Fp launches): device ms "
              f"entry {w['device_ms']:.4f}  warp {w['warp_ms']:.4f}  thread {w['thread_ms']:.4f}  the Fp launches "
              f"it replaced {w['fp_launches_ms']:.4f} (host included)  plain {w['plain_ms']:.1f}  "
              f"bound {w['bound_ms']:.2e} ({w['bound_by']})", flush=True)
        widths.append(w)
        if n == NORMALIZE_FIRST[group]:
            first, ms = w, cuda_ms(_phase_call(name, [src, torch.empty_like(src)], [n, 0]), 20)
    return _fused_row(name, ms, first["plain_ms"], (first["bound_ms"], first["bound_by"]),
                      [first] + [x for x in widths if x is not first])


def _eq_row(card: Card, rng, dev) -> dict:
    """eq_tables at nv = EQ_NV: the suffix set (rounds 3, setup) and eq_table
    alone (round 5), bit-exact against the plain loops, by device time
    beside the bound (one Fr product an output lane, the least a table set
    needs, and its bytes)."""
    from spartan_tpu_torch.ops import mle

    ts = _fr_rows(EQ_NV, rng, dev).contiguous()
    widths = []
    for tables, wrap, plain in ((EQ_NV + 1, lambda t: [x[0] for x in mle.eq_suffix_tables_mont(t[None])],
                                 mle.eq_suffix_tables_plain),
                                (1, lambda t: [mle.eq_table(t[None])[0]], lambda t: [mle.eq_table_plain(t)])):
        got, want = wrap(ts), plain(ts)
        check(len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want)),
              f"eq_tables nv={EQ_NV} tables={tables}: kernel disagrees with its plain version")
        lanes = sum(x.shape[1] for x in want)
        buf = torch.empty(8 * lanes, dtype=torch.int32, device=dev)
        call = _phase_call("eq_tables", [ts, buf], [EQ_NV, tables])
        w = {"nv": EQ_NV, "tables": tables, "lanes": lanes, "device_ms": _graph_ms_of(call),
             "ms": cuda_ms(call, 20), "plain_ms": cuda_ms(lambda: plain(ts), 1)}
        w["bound_ms"], w["bound_by"] = card.bound(FR_PRODUCT * lanes, 32 * (lanes + EQ_NV))
        print(f"eq_tables nv={EQ_NV} tables={tables} ({lanes} lanes) bit-exact: device {w['device_ms']:.5f} ms  "
              f"plain {w['plain_ms']:.1f} ms  bound {w['bound_ms']:.5f} ms ({w['bound_by']})", flush=True)
        widths.append(w)
    w = widths[0]
    return _fused_row("eq_tables", w["ms"], w["plain_ms"], (w["bound_ms"], w["bound_by"]), widths)


def _ladder_calls(poly: torch.Tensor, pt: torch.Tensor):
    """The ladder's launches as direct calls on fixed buffers, as
    scheme._quotients_and_eval makes them: [(name, pairs, call)], qcat, ev."""
    from spartan_tpu_torch.commitment import scheme

    nv, dev = pt.shape[1], poly.device
    qcat = torch.full((8, (1 << nv) - 1), -1, dtype=torch.int32, device=dev)
    ev = torch.full((8, 1), -1, dtype=torch.int32, device=dev)
    level0 = max(0, nv - scheme.QUOT_TAIL_PAIRS.bit_length())
    calls, r = [], poly
    for level in range(level0):
        out = torch.empty((8, 1 << (nv - 1 - level)), dtype=torch.int32, device=dev)
        calls.append(("quot_level", out.shape[1], _phase_call("quot_level", [r, pt, qcat, out], [nv, level])))
        r = out
    calls.append(("quot_tail", r.shape[1] // 2, _phase_call("quot_tail", [r, pt, qcat, ev], [nv, level0])))
    return calls, qcat, ev


def _ladder_cost(name: str, pairs0: int):
    """(Fr products, bytes) of a ladder launch from `pairs0` pairs: a pair's
    from_mont(q) and q p_i; a level reads its two elements and writes q and
    r' once; the tail reads its first level's elements, writes every level's
    q and the evaluation (from_mont of the last r), and keeps r on chip."""
    if name == "quot_level":
        return 2 * pairs0, 128 * pairs0 + 32
    pairs = [pairs0 >> k for k in range(pairs0.bit_length())]
    return 2 * sum(pairs) + 1, 64 * pairs0 + 32 * sum(pairs) + 32 * (len(pairs) + 1)


def _ladder_rows(card: Card, rng, dev) -> list:
    """The quotient ladder at LADDER_NVS: the wrapper and the direct calls
    bit-exact against the plain loop (every quotient and the evaluation),
    each launch by device time beside its bound; the quot_level row's
    numbers are at the 2^16 opening's first level, quot_tail's at its tail."""
    from spartan_tpu_torch.commitment import scheme

    per = {"quot_level": [], "quot_tail": []}
    for nv in LADDER_NVS:
        poly, pt = _fr_rows(1 << nv, rng, dev), _fr_rows(nv, rng, dev).contiguous()
        want_q, want_ev = scheme._quotients_and_eval_plain(poly, pt)
        got_q, got_ev = scheme._quotients_and_eval(poly, pt)
        check(torch.equal(got_q, want_q) and torch.equal(got_ev, want_ev),
              f"quotient ladder nv={nv}: kernels disagree with the plain loop")
        calls, qcat, ev = _ladder_calls(poly, pt)
        for _name, _pairs, call in calls:
            call()
        check(torch.equal(qcat, want_q) and torch.equal(ev, want_ev),
              f"quotient ladder nv={nv}: the direct calls disagree with the plain loop")
        plain_ms = cuda_ms(lambda: scheme._quotients_and_eval_plain(poly, pt), 1)
        whole = _graph_ms_of(lambda: [c() for _n, _p, c in calls])
        for name, pairs, call in calls:
            products, nbytes = _ladder_cost(name, pairs)
            w = {"nv": nv, "pairs": pairs, "device_ms": _graph_ms_of(call), "ms": cuda_ms(call, 20)}
            w["bound_ms"], w["bound_by"] = card.bound(FR_PRODUCT * products, nbytes)
            print(f"{name} nv={nv} pairs={pairs} bit-exact: device {w['device_ms']:.5f} ms  "
                  f"bound {w['bound_ms']:.2e} ms ({w['bound_by']})", flush=True)
            per[name].append(w | {"plain_ms": plain_ms})
        print(f"quotient ladder nv={nv}: {len(calls)} launches, device {whole:.5f} ms together; plain loop "
              f"{plain_ms:.1f} ms", flush=True)
    rows = []
    for name, widths in per.items():
        w = widths[0]
        rows.append(_fused_row(name, w["ms"], w["plain_ms"], (w["bound_ms"], w["bound_by"]), widths))
    return rows


def phase_fused_kernels(dev, card: Card, seed: int = 2468) -> list:
    """The fused K1 and K2 entry points (FUSED_KERNELS), each bit-exact
    against its plain version at the prove's widths and wider, and timed."""
    rng = np.random.default_rng(seed)
    rows = [_normalize_row(group, card, rng, dev) for group in ("g1", "g2")]
    rows.append(_eq_row(card, rng, dev))
    return rows + _ladder_rows(card, rng, dev)


# ---------------------------------------------------------------------------
# Phases 3 and 4: the port's main path
# ---------------------------------------------------------------------------


def _circuit(log_n: int, log_v: int, density: int, seed: int):
    from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input

    cs, v, w = generate_circuit_with_random_input(
        num_public=1 << log_v, num_private=(1 << log_n) - (1 << log_v),
        pad_to_square=True, density=density, rng=random.Random(seed),
    )
    a, b, c = cs.to_matrices()
    return a, b, c, v, w


def host_loop(prove):
    """``prove`` run with SPARTAN_DEVICE_FS=0: the host-transcript route."""
    def run():
        old = os.environ.get("SPARTAN_DEVICE_FS")
        os.environ["SPARTAN_DEVICE_FS"] = "0"
        try:
            return prove()
        finally:
            if old is None:
                del os.environ["SPARTAN_DEVICE_FS"]
            else:
                os.environ["SPARTAN_DEVICE_FS"] = old

    return run


def phase_golden(dev) -> None:
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

    a, b, c, v, w = _circuit(5, 2, 1, 3)
    # no device named: setup and index default to the card
    pp, vp = MLArgumentForR1CS.setup(5, SeededFr(7))
    pk = MLArgumentForR1CS.index(a, b, c)
    check(pp.device == dev and pk.matrix_a.coo[2].device == dev,
          f"setup/index without a device built on {pp.device}, not on {dev}")
    proof = MLArgumentForR1CS.prove(pk, v, w, pp)
    with open(GOLDEN, "rb") as fh:
        want = fh.read()
    check(proof.serialize() == want, "2^5 proof differs from tests/fixtures/proof_2e5_seed3.bin")
    check(MLArgumentForR1CS.verify(pk.vk(), v, proof, vp), "2^5 proof rejected")
    print(f"golden: 2^5 proof ({len(want)} bytes) equals proof_2e5_seed3.bin; verify accepts",
          flush=True)


def _phase_inputs(log_n: int):
    """Tables Az, Bz, Cz, W, Z, tor and a chain state, drawn as
    scripts/make_sumcheck_fixture.py draws them for PHASES_FIXTURE."""
    from spartan_tpu_torch.host import field as hf

    rng = random.Random(1000 + log_n)
    n = 1 << log_n
    tabs = [[rng.randrange(hf.R) for _ in range(n)] for _ in range(5)]
    tor = [rng.randrange(hf.R) for _ in range(log_n)]
    state = bytes(rng.randrange(256) for _ in range(32))
    return tabs, tor, state


def phase_jax_phases(dev) -> None:
    """Both sumcheck phases on the card (round launches and tails) against
    the JAX package's fused phases on the same inputs, at every log_n of
    PHASES_FIXTURE (3..10): every message, challenge, round 4's values and
    the chain states. From log_n = 9 the first rounds are round launches of
    several blocks (16 at log_n = 10), so the ticket and the last block's
    transcript step are held against spartan_tpu's bytes."""
    from spartan_tpu_torch import kernels
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops import mle
    from spartan_tpu_torch.ops.field import FR
    from spartan_tpu_torch.protocol import fused

    with open(PHASES_FIXTURE) as fh:
        fixture = json.load(fh)
    ints = lambda xs: [int(x, 16) for x in xs]  # noqa: E731
    before = {k: dict(kernels.LANES[k]) for k in PHASE_PATH}
    for key, want in fixture.items():
        log_n = int(key)
        tabs, tor, state = _phase_inputs(log_n)
        mont = [fo.encode_mont(FR, t, dev) for t in tabs]
        suffix = [t[None] for t in mle.eq_suffix_tables(tor, dev)]
        (r1,) = fused.sc1_phase(*(t[None] for t in mont[:3]), suffix, [tor], [state])  # B = 1, as the prove
        (r2,) = fused.sc2_phase(mont[3][None], mont[4][None], [state])
        check(r1.evals == [ints(e) for e in want["sc1"]["evals"]] and r1.rs == ints(want["sc1"]["rs"])
              and r1.vabc == ints(want["sc1"]["vabc"]) and r1.rabc == ints(want["sc1"]["rabc"])
              and r1.state.hex() == want["sc1"]["state"], f"sumcheck 1 at log_n={log_n} differs from spartan_tpu's")
        check(r2.evals == [ints(e) for e in want["sc2"]["evals"]] and r2.rs == ints(want["sc2"]["rs"])
              and r2.state.hex() == want["sc2"]["state"], f"sumcheck 2 at log_n={log_n} differs from spartan_tpu's")
    launched = {k: sorted((list(key), m - before[k].get(key, 0)) for key, m in kernels.LANES[k].items()
                          if m > before[k].get(key, 0)) for k in PHASE_PATH}
    blocks = sorted({fused.round_blocks(p, b) for p, _f, b in (key for key, _m in launched["sc1_round"])})
    print(f"jax phases: both sumcheck phases on the card equal spartan_tpu's at log_n = {', '.join(fixture)} "
          f"({os.path.basename(PHASES_FIXTURE)}); launches [[pairs, fold, B], n] {json.dumps(launched)}; "
          f"round launches of {blocks} blocks", flush=True)


def _rejects(fn) -> str:
    """Run a verification expected to fail; return how it failed."""
    from spartan_tpu_torch.utils.errors import SpartanError

    try:
        ok = fn()
    except (SpartanError, ValueError) as e:
        return f"raised {type(e).__name__}: {e}"
    check(not ok, "verify accepted a proof it must reject")
    return "returned False"


def phase_full(dev, card: Card, log_n: int = 16):
    from spartan_tpu_torch import kernels, timers
    from spartan_tpu_torch.protocol import fused
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
    from spartan_tpu_torch.protocol.proof import Proof

    t0 = time.perf_counter()
    a, b, c, v, w = _circuit(log_n, 2, 0, 0)
    nnz = sum(len(r) for m in (a, b, c) for r in m)
    print(f"full: circuit 2^{log_n} density 0 nnz={nnz} built in {time.perf_counter() - t0:.1f} s "
          "(host)", flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    timers.reset()
    kernels.reset_counts()
    (pp, vp), setup_s = timed(lambda: MLArgumentForR1CS.setup(log_n, SeededFr(42), dev))
    pk, index_s = timed(lambda: MLArgumentForR1CS.index(a, b, c, dev))
    before = (dict(kernels.LAUNCHES), dict(kernels.DOUBLINGS),
              {k: dict(c) for k, c in kernels.LANES.items()})
    proof, prove_s = timed(lambda: MLArgumentForR1CS.prove(pk, v, w, pp))
    device_spans = dict(timers.SPANS)
    path = (*kernels.KERNELS, *PHASE_PATH, *FUSED_PATH)
    prove_counts = {k: kernels.LAUNCHES[k] - before[0].get(k, 0) for k in path}
    prove_doublings = {k: d - before[1].get(k, 0) for k, d in kernels.DOUBLINGS.items()}
    prove_widths = {}  # kernel -> its three most launched (lanes, k) in the prove
    for k, counts in kernels.LANES.items():
        diff = {key: m - before[2].get(k, {}).get(key, 0) for key, m in counts.items()}
        top = sorted(((m, key) for key, m in diff.items() if m), reverse=True)[:3]
        prove_widths[k] = [[list(key), m] for m, key in top]
    ok, verify_s = timed(lambda: MLArgumentForR1CS.verify(pk.vk(), v, proof, vp))
    launches = {k: kernels.LAUNCHES[k] for k in path}
    check(ok is True, "verify rejected the honest 2^16 proof")
    data = proof.serialize()
    with open(PROOF_SHA) as fh:
        want_sha = fh.read().split()[0]
    sha = hashlib.sha256(data).hexdigest()
    check(sha == want_sha, f"the 2^16 proof's SHA-256 {sha} differs from {os.path.basename(PROOF_SHA)}")
    print(f"full: the 2^16 proof's SHA-256 {sha} equals {os.path.basename(PROOF_SHA)}", flush=True)
    print(f"full: setup {setup_s:.3f} s  index {index_s:.3f} s  prove {prove_s:.3f} s  "
          f"verify {verify_s:.3f} s  proof {len(data)} bytes", flush=True)
    print("full: spans " + json.dumps({k: round(s, 4) for k, s in timers.SPANS.items()}), flush=True)
    print("full: prove launches " + json.dumps(prove_counts), flush=True)
    print("full: prove doublings " + json.dumps(prove_doublings), flush=True)
    print("full: prove [[lanes, (k)], launches], most launched first " + json.dumps(prove_widths),
          flush=True)
    shapes = {}  # every shape the prove launched them at, widest first
    for k in ("g1_add", "g1_double", "fr_mul", "fp_sub"):
        diff = {key: m - before[2].get(k, {}).get(key, 0) for key, m in kernels.LANES[k].items()}
        shapes[k] = sorted(([list(key), m] for key, m in diff.items() if m), reverse=True)
        print(f"full: prove {k} [[lanes, (k)], launches], all, widest first " + json.dumps(shapes[k]),
              flush=True)
    bounds = {}  # the bound of one launch at the most launched shape; every lane counted
    for k, top in prove_widths.items():
        if k not in LANE_BYTES:  # the sumcheck-phase kernels: phase 2 prints theirs
            continue
        (lanes, *reps), _m = top[0]
        nbytes = lanes * LANE_BYTES[k]
        bounds[k] = card.bound(PRODUCTS.get(k, 0) * lanes * (reps[0] if reps else 1), nbytes)
    print("full: prove, bound at the most launched shape [ms, by] " + json.dumps(bounds),
          flush=True)
    for k in prove_counts:
        if k in MOVED:
            check(prove_counts[k] <= MOVED[k], f"{k}: {prove_counts[k]} launches a prove, more than {MOVED[k]}")
        else:
            check(prove_counts[k] > 0, f"kernel {k} never launched during prove")
    k12 = {f: {k: prove_counts[k] for k in K12[f]} for f in K12}
    total = sum(sum(c.values()) for c in k12.values())
    print(f"full: K1 and K2 launches a prove by entry point, the fused ones included: {total} "
          + json.dumps(k12), flush=True)
    check(total <= K12_MAX, f"K1 and K2 launched {total} times in the prove, more than {K12_MAX}")
    i0 = fused.tail_start(log_n)
    for k in PHASE_PATH:
        want = 1 if k.endswith("tail") else i0
        check(prove_counts[k] == want, f"{k}: {prove_counts[k]} launches, not {want}")
    phase_launches = sum(prove_counts[k] for k in PHASE_PATH)
    check(phase_launches <= 20, f"the sumcheck phases launched {phase_launches} kernels, more than 20")
    print(f"full: the sumcheck phases' launches a prove: {phase_launches} "
          + json.dumps({k: prove_counts[k] for k in PHASE_PATH}), flush=True)
    check(any("(fused)" in k for k in device_spans), "the prove did not take the device-resident transcript")

    # the host loop on the same pk and pp: the same bytes
    counts0 = dict(kernels.LAUNCHES)
    timers.reset()
    host_proof, host_s = timed(host_loop(lambda: MLArgumentForR1CS.prove(pk, v, w, pp)))
    host_counts = {k: kernels.LAUNCHES[k] - counts0.get(k, 0) for k in prove_counts}
    check(host_proof.serialize() == data, "the host loop's 2^16 proof differs from the device route's")
    check(not any("(fused)" in k for k in timers.SPANS), "SPARTAN_DEVICE_FS=0 did not take the host loop")
    print(f"full: the host loop's proof (SPARTAN_DEVICE_FS=0, same pk and pp) equals the device route's; "
          f"prove wall: device route (the first prove) {prove_s:.3f} s, host loop {host_s:.3f} s", flush=True)
    print("full: launches a prove, device route " + json.dumps({k: m for k, m in prove_counts.items() if m})
          + "; host loop " + json.dumps({k: m for k, m in host_counts.items() if m}), flush=True)
    print("full: spans, host loop " + json.dumps({k: round(x, 4) for k, x in timers.SPANS.items()}),
          flush=True)

    # one byte of the last opening proof changed: a low x byte of its first
    # G2 point (usually no longer on the curve), or the byte holding the
    # y-sign flag (decodes to the negated point, so the pairing must fail)
    first_pt = len(data) - log_n * 96
    for label, off, bit in (("x byte", first_pt + 5, 0x01), ("y-sign byte", first_pt + 95, 0x80)):
        bad = bytearray(data)
        bad[off] ^= bit
        how = _rejects(lambda: MLArgumentForR1CS.verify(pk.vk(), v, Proof.deserialize(bytes(bad)), vp))
        print(f"full: tampered opening {label} -> {how}", flush=True)
    wrong_v = list(v)
    wrong_v[0] = (wrong_v[0] + 1)
    how = _rejects(lambda: MLArgumentForR1CS.verify(pk.vk(), wrong_v, proof, vp))
    print(f"full: wrong public input -> {how}", flush=True)
    return launches, shapes, lambda: MLArgumentForR1CS.prove(pk, v, w, pp), (pk, pp, vp), (v, w)


def _witness(job):
    """(digest of the matrices, v, w) of the density-0 circuit of circuit seed
    `seed` at 2^log_n: a task of phase 6's pool of processes."""
    log_n, seed = job
    a, b, c, v, w = _circuit(log_n, 2, 0, seed)
    return hashlib.sha256(repr((a, b, c)).encode()).hexdigest(), v, w


BATCH_SPANS = ("Batch Prove 0: encode z", "Batch Prove 1: commits", "Batch Prove 2: opens z(r_v,0..)", "Batch Prove 3: sparse mat-vec",
               "Batch Prove SC1 (fused)", "Batch Prove 5: eval_on_x + combine", "Batch Prove SC2 (fused)",
               "Batch Prove 6: opens z(r_y)")


def phase_batched(dev, card: Card, keys, log_n: int = 16, bsz: int = BATCH_B) -> None:
    """prove_many of bsz distinct instances of phase 4's circuit (circuit
    seeds 0 .. bsz - 1 at density 0 give one set of matrices and their own v
    and w; built in a pool of processes) on phase 4's pk and pp. Every
    batched proof must equal the sequential prove of its instance; verify
    must accept two and reject a tampered one; the batched prove's launches
    by entry point (18 sumcheck launches; one g1_normalize and one
    g2_normalize a stage) are asserted. Prints the warm batched and the
    sequential wall time and proofs/s, the batched spans, and (phase_profile)
    device time by entry point."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from spartan_tpu_torch import kernels, timers
    from spartan_tpu_torch.protocol import fused
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
    from spartan_tpu_torch.protocol.batched import prove_many, verify_batch
    from spartan_tpu_torch.protocol.proof import Proof

    pk, pp, vp = keys
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        made = list(pool.map(_witness, [(log_n, seed) for seed in range(bsz)]))
    check(len({d for d, _v, _w in made}) == 1, "circuit seeds at density 0 gave different matrices")
    instances = [(v, w) for _d, v, w in made]
    check(len({tuple(w) for _v, w in instances}) == bsz, "the batch's witnesses are not distinct")
    print(f"batched: {bsz} instances (circuit seeds 0..{bsz - 1}, density 0, one set of matrices) built in "
          f"{time.perf_counter() - t0:.1f} s (host, a pool of processes)", flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # the batched path: every count set to 0 just before it and read just after
    timers.reset()
    kernels.reset_counts()
    proofs, cold_s = timed(lambda: prove_many(pk, instances, pp))
    launches = dict(kernels.LAUNCHES)
    widths = {k: sorted([list(key), m] for key, m in kernels.LANES[k].items()) for k in PHASE_PATH}
    print("batched: launches by entry point " + json.dumps({k: m for k, m in sorted(launches.items()) if m}),
          flush=True)
    print("batched: the sumcheck kernels' launches [[pairs, fold, B], n] " + json.dumps(widths), flush=True)
    i0 = fused.tail_start(log_n)
    for k in PHASE_PATH:
        want = 1 if "tail" in k else i0
        check(launches.get(k, 0) == want, f"{k}: {launches.get(k, 0)} launches in the batched prove, not {want}")
    sumcheck = sum(launches.get(k, 0) for k in PHASE_PATH)
    check(sumcheck == 18, f"the batched prove launched {sumcheck} sumcheck kernels, not 18")
    for k, stages in (("g1_normalize", 1), ("g2_normalize", 2)):
        check(launches.get(k, 0) == stages, f"{k}: {launches.get(k, 0)} launches, not one a stage ({stages})")
    for k in (*kernels.KERNELS, *PHASE_PATH, *FUSED_PATH):
        if k not in MOVED:
            check(launches.get(k, 0) > 0, f"kernel {k} never launched in the batched prove")
    print(f"batched: sumcheck launches {sumcheck} (B = {bsz}); g1_normalize {launches['g1_normalize']}, "
          f"g2_normalize {launches['g2_normalize']}; eq_tables {launches['eq_tables']}, quot_level "
          f"{launches['quot_level']}, quot_tail {launches['quot_tail']}", flush=True)
    print("batched: spans of the first prove_many " + json.dumps({k: round(x, 4) for k, x in timers.SPANS.items()}),
          flush=True)

    seq, seq_s = timed(lambda: [MLArgumentForR1CS.prove(pk, v, w, pp) for v, w in instances])
    data = [p.serialize() for p in proofs]
    bad = [b for b in range(bsz) if data[b] != seq[b].serialize()]
    check(not bad, f"batched proofs of instances {bad} differ from their sequential proofs")
    check(len(set(data)) == bsz, "the batch's proofs are not distinct")
    pair = [0, bsz - 1]
    check(verify_batch(pk.vk(), [instances[b] for b in pair], [proofs[b] for b in pair], vp) == [True, True],
          "verify rejected a batched proof")
    bad_bytes = bytearray(data[1])
    bad_bytes[len(bad_bytes) - log_n * 96 + 95] ^= 0x80  # the y-sign flag of the last opening's first point
    how = _rejects(lambda: MLArgumentForR1CS.verify(pk.vk(), instances[1][0], Proof.deserialize(bytes(bad_bytes)),
                                                    vp))
    print(f"batched: all {bsz} proofs equal the sequential proofs byte for byte; verify accepts instances {pair}; "
          f"tampered opening of instance 1 -> {how}", flush=True)

    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        timers.reset()
        _p, wall = timed(lambda: prove_many(pk, instances, pp))
        walls.append(wall)
    warm = min(walls)
    print(f"batched: peak device memory of the warm prove_many {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated, pk and pp included)", flush=True)
    print(card_line(), flush=True)
    print(f"batched: B = {bsz} at 2^{log_n}: prove_many cold {cold_s:.3f} s, warm {', '.join(f'{x:.3f}' for x in walls)} s "
          f"-> {bsz / warm:.3f} proofs/s; the sequential loop (warm) {seq_s:.3f} s -> {bsz / seq_s:.3f} proofs/s; "
          f"{seq_s / warm:.2f} x", flush=True)
    print("batched: spans of the last warm prove_many " + json.dumps({k: round(x, 4) for k, x in timers.SPANS.items()}),
          flush=True)
    inside = phase_profile(lambda: prove_many(pk, instances, pp), f"prove_many B={bsz}", warm=1)
    for label in BATCH_SPANS[4:7:2]:
        check(inside.get(label) == 1, f"{label}: {inside.get(label)} copies to the host, not the one at the end "
              "of the phase")


SHARDED_D = (2, 4)  # shards of phase 7's sharded proves
SHARDED_SPANS = ("Prove 1 (sharded)", "Prove 2 (sharded)", "Prove 3 (sharded)", "Prove Sumcheck 1 (sharded)",
                 "Prove 4 (sharded)", "Prove 5 (sharded)", "Prove Sumcheck 2 (sharded)", "Prove 6 (sharded)")


def phase_sharded(dev, keys, instance, prove, log_n: int = 16) -> None:
    """The sharded prove (``parallel/sharded_prove.py``) of phase 4's
    instance on its pk and pp at D = 2 and 4 shards, on the card
    (``make_mesh(devices=[dev] * D)``, or one card a shard where there are
    D): the proof's SHA-256 must equal PROOF_SHA, verify must accept it and
    reject it with one opening byte changed; every kernel of the path must
    launch (counts set to 0 just before the first prove of each D and read
    just after). Prints the launches by entry point, the spans and the warm
    wall time beside phase 4's routes on the same keys. Then key
    persistence: save_keys of phase 4's keys into a temporary directory,
    load_keys onto the card, a prove with the reloaded keys must give the
    same SHA-256; prints the save and load times and the file's size."""
    import tempfile

    from spartan_tpu_torch import kernels, timers
    from spartan_tpu_torch.commitment import persist
    from spartan_tpu_torch.parallel import sharded
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
    from spartan_tpu_torch.protocol.proof import Proof

    t_phase = time.perf_counter()
    pk, pp, vp = keys
    v, w = instance
    with open(PROOF_SHA) as fh:
        want_sha = fh.read().split()[0]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def warm(fn, runs: int = 3):
        walls = []
        for _ in range(runs):
            timers.reset()
            walls.append(timed(fn)[1])
        return walls

    base = {"device route": warm(prove), "host loop": warm(host_loop(prove))}
    print(card_line(), flush=True)
    print("sharded: phase 4's prove on the same keys, warm wall s "
          + json.dumps({k: [round(x, 4) for x in ws] for k, ws in base.items()}), flush=True)
    path = [k for k in (*kernels.KERNELS, *FUSED_PATH) if k not in MOVED]
    for d in SHARDED_D:
        devices = [f"cuda:{i}" for i in range(d)] if torch.cuda.device_count() >= d else [dev] * d
        mesh = sharded.make_mesh(devices=devices)
        run = lambda: MLArgumentForR1CS.prove(pk, v, w, pp, mesh=mesh)  # noqa: E731
        timers.reset()
        kernels.reset_counts()
        proof, cold_s = timed(run)
        launches = {k: m for k, m in sorted(kernels.LAUNCHES.items()) if m}
        cold_spans = dict(timers.SPANS)
        data = proof.serialize()
        sha = hashlib.sha256(data).hexdigest()
        check(sha == want_sha, f"the sharded (D = {d}) 2^16 proof's SHA-256 {sha} differs from "
              f"{os.path.basename(PROOF_SHA)}")
        check(MLArgumentForR1CS.verify(pk.vk(), v, proof, vp) is True, f"verify rejected the sharded (D = {d}) proof")
        bad = bytearray(data)
        bad[len(bad) - log_n * 96 + 95] ^= 0x80  # the y-sign flag of the last opening's first point
        how = _rejects(lambda: MLArgumentForR1CS.verify(pk.vk(), v, Proof.deserialize(bytes(bad)), vp))
        missing = [k for k in path if not launches.get(k)]
        check(not missing, f"kernels {missing} never launched in the sharded (D = {d}) prove")
        check(not any(launches.get(k) for k in PHASE_PATH), "the sharded prove launched the device transcript's kernels")
        check(all(k in cold_spans for k in SHARDED_SPANS), f"the sharded prove's spans are missing: {list(cold_spans)}")
        walls = warm(run)
        print(f"sharded: D = {d} on {[str(x) for x in mesh.devices]}: SHA-256 {sha} equals "
              f"{os.path.basename(PROOF_SHA)}; verify accepts; tampered opening -> {how}", flush=True)
        print(f"sharded: D = {d} launches by entry point " + json.dumps(launches), flush=True)
        print(f"sharded: D = {d} prove wall cold {cold_s:.4f} s, warm " + json.dumps([round(x, 4) for x in walls])
              + f" s; phase 4's warm min: device route {min(base['device route']):.4f} s, host loop "
              f"{min(base['host loop']):.4f} s", flush=True)
        print(f"sharded: D = {d} spans of the last warm prove "
              + json.dumps({k: round(x, 4) for k, x in timers.SPANS.items()}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        file = os.path.join(tmp, "keys.npz")
        _none, save_s = timed(lambda: persist.save_keys(file, pp, vp))
        size = os.path.getsize(file)
        (pp2, vp2), load_s = timed(lambda: persist.load_keys(file))
    check(pp2.device == dev and vp2 == vp, "load_keys did not put the keys on the card unchanged")
    tables = lambda q: [pb.data for pb in q.powers_of_g + q.powers_of_h + q.powers_of_h_comb]  # noqa: E731
    check(all(torch.equal(a, b) for a, b in zip(tables(pp2), tables(pp))), "reloaded keys differ from the saved ones")
    proof, prove_s = timed(lambda: MLArgumentForR1CS.prove(pk, v, w, pp2))
    sha = hashlib.sha256(proof.serialize()).hexdigest()
    check(sha == want_sha, f"the prove with reloaded keys gave SHA-256 {sha}, not {os.path.basename(PROOF_SHA)}'s")
    print(f"persist: save_keys {save_s:.3f} s, file {size} bytes ({size / 2**20:.1f} MiB), load_keys onto the card "
          f"{load_s:.3f} s; the prove with the reloaded keys ({prove_s:.3f} s) gives SHA-256 {sha}, equal", flush=True)
    print(f"sharded: phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)


SUMCHECK_SPANS = ("Prove Sumcheck 1 (fused)", "Prove Sumcheck 2 (fused)", "Prove Sumcheck 1", "Prove 4",
                  "Prove Sumcheck 2")


def phase_profile(prove, route: str, warm: int = 5) -> dict:
    """Warm proves on the host clock, then one under torch.profiler: device
    time by kernel, the share of the prove's wall time the card was busy
    (the union of its kernel and copy intervals), and the copies from the
    device to the host in the prove and inside each sumcheck span. Returns
    those counts by span."""
    from torch.profiler import ProfilerActivity, profile

    from spartan_tpu_torch import timers

    tag = f"profile [{route}]:"
    walls = []
    for _ in range(warm):
        timers.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    print(f"{tag} warm prove wall s " + json.dumps([round(x, 4) for x in walls])
          + f" median {sorted(walls)[len(walls) // 2]:.4f}", flush=True)
    print(f"{tag} spans of the last warm prove " +
          json.dumps({k: round(s, 4) for k, s in timers.SPANS.items()}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name, ranges, copies = [], {}, {}, []
    labels = set(timers.SPANS)  # the spans' record_function ranges, on the device timeline too
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in SUMCHECK_SPANS + BATCH_SPANS[4:7:2]:
                ranges[e.name] = (e.time_range.start, e.time_range.end)
            continue
        if getattr(e, "is_user_annotation", False) or e.name in labels:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (b - a), cnt + 1)
        if "DtoH" in e.name:
            copies.append(a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    check(bool(spans), f"{tag} the profiler recorded no device activity")
    busy_s = busy / 1e6
    print(f"{tag} prove under the profiler {wall:.4f} s, card busy {busy_s:.4f} s "
          f"({100 * busy_s / wall:.1f} %), idle {100 * (1 - busy_s / wall):.1f} %", flush=True)
    inside = {k: sum(a <= t <= b for t in copies) for k, (a, b) in ranges.items()}
    print(f"{tag} copies device to host: {len(copies)} in the prove; inside the sumcheck spans "
          + json.dumps(inside) + "; span lengths under the profiler ms "
          + json.dumps({k: round((b - a) / 1e3, 3) for k, (a, b) in ranges.items()}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:24]
    for name, (tot, cnt) in top:
        print(f"{tag} {tot / 1e3:9.3f} ms {cnt:6d} x  {100 * tot / busy:5.1f} %  {name[:90]}",
              flush=True)
    entries = {}
    for name, (tot, cnt) in by_name.items():
        entry = _entry_point(name)
        if entry is not None:
            ms, n = entries.get(entry, (0.0, 0))
            entries[entry] = (ms + tot / 1e3, n + cnt)
    print(f"{tag} device time by entry point [ms, launches] " + json.dumps(entries), flush=True)
    return inside


def _entry_point(kernel: str):
    """The entry point of csrc/ that launches the device kernel named
    ``kernel`` (as the profiler names it), or None for PyTorch's own."""
    m = re.search(r"team_kernel<(?:\w+::)?(G[12]), \d+, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("double", "add", "madd")[int(m.group(2))]
    if re.search(r"inv_(warp|thread)_kernel", kernel):
        return "fp_inv"
    m = re.search(r"pt_kernel<(Fe<FpParams>|FpC|Fp2), (\d)", kernel)
    if m:
        return ("g2_" if m.group(1) == "Fp2" else "g1_") + ("madd", "add", "double")[int(m.group(2))]
    m = re.search(r"\b(sc1_round|prod2_round|sc1_tail|sc2_tail|blake2s_batch)(_b)?_kernel", kernel)
    if m:
        return m.group(1) + (m.group(2) or "")
    m = re.search(r"normalize_(?:warp|thread)_kernel<(\d)>", kernel)
    if m:
        return "g1_normalize" if m.group(1) == "3" else "g2_normalize"
    m = re.search(r"\b(eq_tables|quot_level|quot_tail)_kernel", kernel)
    if m:
        return m.group(1)
    m = re.search(r"fe_mul_cc_kernel<(Fr|Fp)Params>", kernel)
    if m:
        return m.group(1).lower() + "_mul"
    m = re.search(r"fe_binary_kernel<(Fr|Fp)Params, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("mul", "add", "sub")[int(m.group(2))]
    return None


def _fr_mul_in_prove(rows: list, shapes: list) -> None:
    """fr_mul's device time in the prove, summed over its shapes (lanes,
    launches) from phase 2's table, for fr_mul and its version before the
    carry flag, beside the sum of the bounds."""
    table = {w["lanes"]: w for w in next(r for r in rows if r["name"] == "fr_mul")["widths"]}
    hit = [(lanes, m) for (lanes,), m in shapes if lanes in table]
    total = {k: sum(m * table[lanes][k] for lanes, m in hit)
             for k in ("device_ms", "sum64_device_ms", "bound_ms")}
    print(f"full: fr_mul in the prove by phase 2's device times, {sum(m for _l, m in hit)} of "
          f"{sum(m for _s, m in shapes)} launches at timed widths: {total['device_ms']:.4f} ms, "
          f"before the carry flag {total['sum64_device_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms",
          flush=True)


def _fp_sub_in_prove(card: Card, shapes: list, dev, seed: int = 97) -> None:
    """fp_sub at every width the prove launched it at (ops/msm.py's _neg_y:
    the y coordinates of an MSM's gathered bases), bit-exact against the
    plain version and by device time beside the bound: whether it reaches
    half of its bound is measured, not reckoned."""
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FP

    rng = np.random.default_rng(seed)
    total = {"device_ms": 0.0, "bound_ms": 0.0}
    for (lanes,), m in shapes:
        a, b = (_random_field(FP, lanes, rng, dev) for _ in range(2))
        out = torch.empty_like(a)
        direct("fp_sub", out, a, b)()
        check(torch.equal(out, fo.sub_plain(FP, a, b)), f"fp_sub lanes={lanes}: disagrees with the plain version")
        ms = graph_ms("fp_sub", out, a, b)
        bound = card.bound(0, LANE_BYTES["fp_sub"] * lanes)[0]
        total["device_ms"] += m * ms
        total["bound_ms"] += m * bound
        print(f"full: fp_sub in the prove, lanes={lanes} x {m}: device {ms:.5f} ms, bound {bound:.5f} ms (bytes), "
              f"{100 * bound / ms:.0f} % of it", flush=True)
        del a, b, out
    print(f"full: fp_sub over the prove's {sum(m for _s, m in shapes)} launches: device {total['device_ms']:.4f} ms, "
          f"bound {total['bound_ms']:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    dev = torch.device("cuda", 0)
    from spartan_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    build_s = kernels.build_seconds if kernels.build_seconds is not None else 0.0
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s (nvcc {build_s:.1f} s)",
          flush=True)
    print(card_line(), flush=True)  # name, power limit: as nvidia-smi gives them
    entry = ""  # the kernel ptxas reports on, as its mangled name
    for line in kernels.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print(f"ptxas: {entry[:72]}: {line.strip()}", flush=True)

    card = Card()
    with ClockSampler() as clocks:
        rows = phase_kernels(dev, card)
        rows += phase_fs_kernels(dev, card)
        rows += phase_fused_kernels(dev, card)
    print(f"phase 2: {clocks.summary()}; bounds at clocks.max.sm {card.max_sm_mhz:.0f} MHz, "
          f"{card.sms} SMs", flush=True)
    phase_golden(dev)
    phase_jax_phases(dev)
    launches, shapes, prove, keys, instance = phase_full(dev, card)
    _fr_mul_in_prove(rows, shapes["fr_mul"])
    _fp_sub_in_prove(card, shapes["fp_sub"], dev)
    inside = phase_profile(prove, "device route")
    for label in SUMCHECK_SPANS[:2]:
        check(inside.get(label) == 1, f"{label}: {inside.get(label)} copies to the host, not the one "
              "at the end of the phase")
    phase_profile(host_loop(prove), "host loop", warm=3)
    phase_batched(dev, card, keys)
    phase_sharded(dev, keys, instance, prove)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["main_path"] = row["name"] not in MOVED or row["launches"] > 0
        check(row["launches"] > 0 or not row["main_path"], f"kernel {row['name']} never launched in the main path")
    print("main path: entry points whose work the fused kernels took over, launched none in its run: "
          + json.dumps(sorted(r["name"] for r in rows if not r["main_path"])), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
