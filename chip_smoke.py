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
   every team size; the Fp inversion at 1, 16 and 4,096 lanes beside its
   one-thread version and the fp_mul chain it replaced; nvidia-smi's
   clocks.sm sampled;
3. the 2^5 golden proof (circuit seed 3, key seed 7), with setup and index
   called without a device (they default to the card), must equal
   ``tests/fixtures/proof_2e5_seed3.bin``;
4. the full-size run: log_n = 16, density 0, 4 public inputs, circuit seed
   0; setup -> index -> prove -> verify, each timed; verify must accept,
   and reject a proof with one opening byte changed and a wrong public
   input; every kernel entry point must have launched during the run;
5. five warm proves, then one under torch.profiler (device time by
   kernel, the card's busy and idle share).

The line before the last is a JSON object with one entry per kernel entry
point; the last line is the contract object with the device.
"""

from __future__ import annotations

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


class Card:
    """Rates of an H100 SXM for the bounds: 3.35 TB/s of device memory, and 32-bit products at 64 IMADs per SM per
    clock, two per 32x32->64 product, at the card's top SM clock."""

    MEM_BYTES_PER_S = 3.35e12

    def __init__(self):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True)
        self.max_sm_mhz = float(out.stdout.split()[0])
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.products_per_s = self.sms * 32 * self.max_sm_mhz * 1e6

    def bound(self, products: float, nbytes: float):
        """(bound_ms, bound_by) for work of `products` 32x32->64 products
        that must move `nbytes` bytes."""
        t_ops = products / self.products_per_s * 1e3
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
TEAMS = {"g1": (2, 4, 8), "g2": (4, 8, 16)}  # team sizes each group's kernels take
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
            record(name, got, want, direct(name, torch.empty_like(a), a, b),
                   lambda: plain(spec, a, b), PRODUCTS.get(name, 0) * n, LANE_BYTES[name] * n)

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
    rows.append(_fp_inv_row(card, rng, dev))
    return rows


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
        versions = _team_versions(name, ins, k, TEAMS[group])
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
          + "  ".join(f"T={t} {row[f'team{t}_ms']:.4f}" for t in TEAMS[group])
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
    prove_counts = {k: kernels.LAUNCHES[k] - before[0].get(k, 0) for k in kernels.KERNELS}
    prove_doublings = {k: d - before[1].get(k, 0) for k, d in kernels.DOUBLINGS.items()}
    prove_widths = {}  # kernel -> its three most launched (lanes, k) in the prove
    for k, counts in kernels.LANES.items():
        diff = {key: m - before[2].get(k, {}).get(key, 0) for key, m in counts.items()}
        top = sorted(((m, key) for key, m in diff.items() if m), reverse=True)[:3]
        prove_widths[k] = [[list(key), m] for m, key in top]
    ok, verify_s = timed(lambda: MLArgumentForR1CS.verify(pk.vk(), v, proof, vp))
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNELS}
    check(ok is True, "verify rejected the honest 2^16 proof")
    data = proof.serialize()
    print(f"full: setup {setup_s:.3f} s  index {index_s:.3f} s  prove {prove_s:.3f} s  "
          f"verify {verify_s:.3f} s  proof {len(data)} bytes", flush=True)
    print("full: spans " + json.dumps({k: round(s, 4) for k, s in timers.SPANS.items()}), flush=True)
    print("full: prove launches " + json.dumps(prove_counts), flush=True)
    print("full: prove doublings " + json.dumps(prove_doublings), flush=True)
    print("full: prove [[lanes, (k)], launches], most launched first " + json.dumps(prove_widths),
          flush=True)
    for k in ("g1_add", "g1_double"):  # every shape the prove launched them at, widest first
        diff = {key: m - before[2].get(k, {}).get(key, 0) for key, m in kernels.LANES[k].items()}
        print(f"full: prove {k} [[lanes, (k)], launches], all, widest first "
              + json.dumps(sorted(([list(key), m] for key, m in diff.items() if m), reverse=True)),
              flush=True)
    bounds = {}  # the bound of one launch at the most launched shape; every lane counted
    for k, top in prove_widths.items():
        (lanes, *reps), _m = top[0]
        nbytes = lanes * LANE_BYTES[k]
        bounds[k] = card.bound(PRODUCTS.get(k, 0) * lanes * (reps[0] if reps else 1), nbytes)
    print("full: prove, bound at the most launched shape [ms, by] " + json.dumps(bounds),
          flush=True)
    for k in kernels.KERNELS:
        check(prove_counts[k] > 0, f"kernel {k} never launched during prove")

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
    return launches, lambda: MLArgumentForR1CS.prove(pk, v, w, pp)


def phase_profile(prove, warm: int = 5) -> None:
    """Warm proves on the host clock, then one under torch.profiler: device
    time by kernel, and the share of the prove's wall time the card was busy
    (the union of its kernel and copy intervals)."""
    from torch.profiler import ProfilerActivity, profile

    from spartan_tpu_torch import timers

    walls = []
    for _ in range(warm):
        timers.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    print("profile: warm prove wall s " + json.dumps([round(x, 4) for x in walls])
          + f" median {sorted(walls)[len(walls) // 2]:.4f}", flush=True)
    print("profile: spans of the last warm prove " +
          json.dumps({k: round(s, 4) for k, s in timers.SPANS.items()}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (b - a), cnt + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if not spans:
        print("profile: the profiler recorded no device activity; device time not measured",
              flush=True)
        return
    busy_s = busy / 1e6
    print(f"profile: prove under the profiler {wall:.4f} s, card busy {busy_s:.4f} s "
          f"({100 * busy_s / wall:.1f} %), idle {100 * (1 - busy_s / wall):.1f} %", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:24]
    for name, (tot, cnt) in top:
        print(f"profile: {tot / 1e3:9.3f} ms {cnt:6d} x  {100 * tot / busy:5.1f} %  {name[:90]}",
              flush=True)
    entries = {}
    for name, (tot, cnt) in by_name.items():
        entry = _entry_point(name)
        if entry is not None:
            ms, n = entries.get(entry, (0.0, 0))
            entries[entry] = (ms + tot / 1e3, n + cnt)
    print("profile: device time by entry point [ms, launches] " + json.dumps(entries), flush=True)


def _entry_point(kernel: str):
    """The entry point of csrc/ that launches the device kernel named
    ``kernel`` (as the profiler names it), or None for PyTorch's own."""
    m = re.search(r"team_kernel<(?:\w+::)?(G[12]), \d+, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("double", "add", "madd")[int(m.group(2))]
    if re.search(r"inv_(warp|thread)_kernel", kernel):
        return "fp_inv"
    m = re.search(r"pt_kernel<(Fe<FpParams>|Fp2), (\d)>", kernel)
    if m:
        return ("g1_" if m.group(1).startswith("Fe") else "g2_") + ("madd", "add", "double")[int(m.group(2))]
    m = re.search(r"fe_binary_kernel<(Fr|Fp)Params, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("mul", "add", "sub")[int(m.group(2))]
    return None


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
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"ptxas: {line.strip()}", flush=True)

    card = Card()
    with ClockSampler() as clocks:
        rows = phase_kernels(dev, card)
    print(f"phase 2: {clocks.summary()}; bounds at clocks.max.sm {card.max_sm_mhz:.0f} MHz, "
          f"{card.sms} SMs", flush=True)
    phase_golden(dev)
    launches, prove = phase_full(dev, card)
    phase_profile(prove)
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"kernel {row['name']} never launched in the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
