"""Stage programs of the team point kernels (``csrc/team.cuh``), written at
the level of Fp operations: K3's G1 add and 2^k-fold double, and K4's G2
add, mixed add and 2^k-fold double.

A team of T threads computes one point. The formulas of ``ops/curve.py``
(dbl-2009-l, add-2007-bl, madd-2007-bl with a = 0) are written here as
stages: every operation of a stage reads only values that earlier stages
wrote, so the team's threads share out a stage's operations and meet at one
``__syncwarp`` after it. Over Fp2, Karatsuba gives three independent Fp
products per multiply and the complex square two. The chain of dependent
Fp products is 3 deep for a double (G1 7 products, G2 16) and 5 deep for
an add (G1 16, G2 44) and the G2 mixed add (30).

An operation is a Montgomery product ``d = a * b`` or a linear combination
``d = s * (sum of +-terms)``, a term repeated to give it a coefficient and
``s`` a small integer scale. Every value lives in a slot of the team's
shared memory, 12 limbs each. The inputs are P in the first slots (G1: x,
y, z; G2: x.c0, x.c1, y.c0, y.c1, z.c0, z.c1) and, for the adds, Q in the
next ones; the result overwrites P's slots. ``allocate`` gives every other
value the lowest slot free over its lifetime and checks that no stage
reads a slot that it also writes, which makes the order of a stage's
operations free.

``emit_header`` writes ``csrc/team_prog.cuh``, the tables the kernels run
(``G1T_*`` and ``G2T_*``); ``python -m spartan_tpu_torch.ops.team``
regenerates it. ``run`` executes a program on Python integers modulo p,
which the CPU tests hold against the plain point formulas.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

MAX_TERMS = 12  # terms of one linear operation (the table's op record)

# dbl-2009-l as curve._double_coords computes it: A = X^2, B = Y^2, C = B^2,
# D = 2((X + B)^2 - A - C), E = 3A, X3 = E^2 - 2D, Y3 = E(D - X3) - 8C,
# Z3 = 2YZ. Written with (X + B)^2 - A - C = 2XB and E^2 = 9A^2, so that the
# second product stage reads the first one's products directly: D = 4XB,
# W = D - X3 = 3(4XB - 3A^2), E W = 3 A W, X3 = D - W. 7 products in 3
# stages and two linear stages.
G1_DOUBLE = [
    ["a = PX * PX", "b = PY * PY", "yz = PY * PZ"],
    ["c = b * b", "xb = PX * b", "g = a * a"],
    ["W = 3*(4*xb - 3*g)", "C8 = 8*(c)", "PZ = 2*(yz)"],
    ["aw = a * W"],
    ["PY = 3*aw - C8", "PX = 4*xb - W"],
]

# add-2007-bl as curve.add_plain computes it: Z1Z1 = Z1^2, Z2Z2 = Z2^2,
# U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, H = U2 - U1,
# R = S2 - S1, X3 = R^2 - H^3 - 2 U1 H^2, Y3 = R (U1 H^2 - X3) - S1 H^3,
# Z3 = Z1 Z2 H. 16 products in 5 dependent stages.
G1_ADD = [
    ["zz1 = PZ * PZ", "zz2 = QZ * QZ", "a = PY * QZ", "b = QY * PZ", "m = PZ * QZ"],
    ["U1 = PX * zz2", "U2 = QX * zz1", "S1 = a * zz2", "S2 = b * zz1"],
    ["H = U2 - U1", "R = S2 - S1"],
    ["h2 = H * H", "r2 = R * R", "PZ = m * H"],
    ["h3 = H * h2", "uh = U1 * h2"],
    ["PX = r2 - h3 - 2*uh", "W = 3*uh - r2 + h3"],
    ["e = R * W", "f = S1 * h3"],
    ["PY = e - f"],
]

# dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C), E = 3A,
# X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ. A name ending in m is the
# product c0 * c1 of a complex square, whose c1 is twice it.
G2_DOUBLE = [
    ["xs = PX0 + PX1", "xd = PX0 - PX1", "ys = PY0 + PY1", "yd = PY0 - PY1", "zs = PZ0 + PZ1"],
    ["a0 = xs * xd", "am = PX0 * PX1", "b0 = ys * yd", "bm = PY0 * PY1",
     "k0 = PY0 * PZ0", "k1 = PY1 * PZ1", "k2 = ys * zs"],
    ["PZ0 = 2*(k0 - k1)", "PZ1 = 2*(k2 - k0 - k1)", "B1 = 2*bm",
     "cs = b0 + 2*bm", "cd = b0 - 2*bm", "T0 = PX0 + b0", "T1 = PX1 + 2*bm",
     "ts = PX0 + b0 + PX1 + 2*bm", "td = PX0 + b0 - PX1 - 2*bm",
     "E0 = 3*(a0)", "E1 = 6*(am)", "es = 3*(a0 + 2*am)", "ed = 3*(a0 - 2*am)"],
    ["c0 = cs * cd", "cm = b0 * B1", "u0 = ts * td", "um = T0 * T1", "f0 = es * ed",
     "fm = E0 * E1"],
    ["D0 = 2*(u0 - a0 - c0)", "D1 = 4*(um - am - cm)", "C0 = 8*(c0)", "C1 = 16*(cm)"],
    ["PX0 = f0 - 2*D0", "PX1 = 2*(fm - D1)", "W0 = 3*D0 - f0", "W1 = 3*D1 - 2*fm",
     "Ws = 3*D0 + 3*D1 - f0 - 2*fm"],
    ["e0 = E0 * W0", "e1 = E1 * W1", "e2 = es * Ws"],
    ["PY0 = e0 - e1 - C0", "PY1 = e2 - e0 - e1 - C1"],
]

# add-2007-bl as in curve.add_plain: Z1Z1 = Z1^2, Z2Z2 = Z2^2,
# U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, H = U2 - U1,
# R = S2 - S1, X3 = R^2 - H^3 - 2 U1 H^2, Y3 = R (U1 H^2 - X3) - S1 H^3,
# Z3 = Z1 Z2 H. A name ending in s (d) holds c0 + c1 (c0 - c1) of an Fp2
# value, the operand of a Karatsuba (complex-square) product.
G2_ADD = [
    ["z1s = PZ0 + PZ1", "z1d = PZ0 - PZ1", "z2s = QZ0 + QZ1", "z2d = QZ0 - QZ1",
     "y1s = PY0 + PY1", "y2s = QY0 + QY1", "x1s = PX0 + PX1", "x2s = QX0 + QX1"],
    ["p0 = z1s * z1d", "pm = PZ0 * PZ1", "q0 = z2s * z2d", "qm = QZ0 * QZ1",
     "a0 = PY0 * QZ0", "a1 = PY1 * QZ1", "a2 = y1s * z2s",
     "b0 = QY0 * PZ0", "b1 = QY1 * PZ1", "b2 = y2s * z1s"],
    ["zz1 = 2*pm", "zz2 = 2*qm", "zz1s = p0 + 2*pm", "zz2s = q0 + 2*qm",
     "t10 = a0 - a1", "t11 = a2 - a0 - a1", "t1s = a2 - 2*a1",
     "t20 = b0 - b1", "t21 = b2 - b0 - b1", "t2s = b2 - 2*b1"],
    ["u0 = PX0 * q0", "u1 = PX1 * zz2", "u2 = x1s * zz2s",
     "v0 = QX0 * p0", "v1 = QX1 * zz1", "v2 = x2s * zz1s",
     "s0 = t10 * q0", "s1 = t11 * zz2", "s2 = t1s * zz2s",
     "w0 = t20 * p0", "w1 = t21 * zz1", "w2 = t2s * zz1s",
     "m0 = PZ0 * QZ0", "m1 = PZ1 * QZ1", "m2 = z1s * z2s"],
    ["U10 = u0 - u1", "U11 = u2 - u0 - u1", "U1s = u2 - 2*u1",
     "S10 = s0 - s1", "S11 = s2 - s0 - s1", "S1s = s2 - 2*s1",
     "H0 = v0 - v1 - u0 + u1", "H1 = v2 - v0 - v1 - u2 + u0 + u1",
     "Hs = v2 - 2*v1 - u2 + 2*u1", "Hd = 2*v0 - v2 - 2*u0 + u2",
     "R0 = w0 - w1 - s0 + s1", "R1 = w2 - w0 - w1 - s2 + s0 + s1",
     "Rs = w2 - 2*w1 - s2 + 2*s1", "Rd = 2*w0 - w2 - 2*s0 + s2",
     "ZZ0 = m0 - m1", "ZZ1 = m2 - m0 - m1", "ZZs = m2 - 2*m1"],
    ["h0 = Hs * Hd", "hm = H0 * H1", "r0 = Rs * Rd", "rm = R0 * R1",
     "z0 = ZZ0 * H0", "z1 = ZZ1 * H1", "z2 = ZZs * Hs"],
    ["H21 = 2*hm", "H2s = h0 + 2*hm", "PZ0 = z0 - z1", "PZ1 = z2 - z0 - z1"],
    ["c0 = H0 * h0", "c1 = H1 * H21", "c2 = Hs * H2s",
     "d0 = U10 * h0", "d1 = U11 * H21", "d2 = U1s * H2s"],
    ["H30 = c0 - c1", "H31 = c2 - c0 - c1", "H3s = c2 - 2*c1",
     "UH0 = d0 - d1", "UH1 = d2 - d0 - d1", "R21 = 2*rm"],
    ["PX0 = r0 - H30 - 2*UH0", "PX1 = R21 - H31 - 2*UH1"],
    ["W0 = UH0 - PX0", "W1 = UH1 - PX1", "Ws = UH0 + UH1 - PX0 - PX1"],
    ["e0 = R0 * W0", "e1 = R1 * W1", "e2 = Rs * Ws",
     "f0 = S10 * H30", "f1 = S11 * H31", "f2 = S1s * H3s"],
    ["PY0 = e0 - e1 - f0 + f1", "PY1 = e2 - e0 - e1 - f2 + f0 + f1"],
]

# madd-2007-bl as in curve.add_mixed_plain, Q affine (Z2 = 1): Z1Z1 = Z1^2,
# U2 = X2 Z1Z1, S2 = Y2 Z1 Z1Z1, H = U2 - X1, R = S2 - Y1,
# X3 = R^2 - H^3 - 2 X1 H^2, Y3 = R (X1 H^2 - X3) - Y1 H^3, Z3 = Z1 H.
# 30 Fp products in 5 dependent stages; Q's Z slots are read only by the
# kernel's Q = inf test.
G2_MADD = [
    ["z1s = PZ0 + PZ1", "z1d = PZ0 - PZ1", "y2s = QY0 + QY1", "x2s = QX0 + QX1",
     "x1s = PX0 + PX1", "y1s = PY0 + PY1"],
    ["p0 = z1s * z1d", "pm = PZ0 * PZ1", "b0 = QY0 * PZ0", "b1 = QY1 * PZ1", "b2 = y2s * z1s"],
    ["zz1 = 2*pm", "zz1s = p0 + 2*pm", "t20 = b0 - b1", "t21 = b2 - b0 - b1", "t2s = b2 - 2*b1"],
    ["v0 = QX0 * p0", "v1 = QX1 * zz1", "v2 = x2s * zz1s",
     "w0 = t20 * p0", "w1 = t21 * zz1", "w2 = t2s * zz1s"],
    ["H0 = v0 - v1 - PX0", "H1 = v2 - v0 - v1 - PX1",
     "Hs = v2 - 2*v1 - PX0 - PX1", "Hd = 2*v0 - v2 - PX0 + PX1",
     "R0 = w0 - w1 - PY0", "R1 = w2 - w0 - w1 - PY1",
     "Rs = w2 - 2*w1 - PY0 - PY1", "Rd = 2*w0 - w2 - PY0 + PY1"],
    ["h0 = Hs * Hd", "hm = H0 * H1", "r0 = Rs * Rd", "rm = R0 * R1",
     "z0 = PZ0 * H0", "z1 = PZ1 * H1", "z2 = z1s * Hs"],
    ["H21 = 2*hm", "H2s = h0 + 2*hm", "PZ0 = z0 - z1", "PZ1 = z2 - z0 - z1"],
    ["c0 = H0 * h0", "c1 = H1 * H21", "c2 = Hs * H2s",
     "d0 = PX0 * h0", "d1 = PX1 * H21", "d2 = x1s * H2s"],
    ["H30 = c0 - c1", "H31 = c2 - c0 - c1", "H3s = c2 - 2*c1",
     "UH0 = d0 - d1", "UH1 = d2 - d0 - d1", "R21 = 2*rm"],
    ["PX0 = r0 - H30 - 2*UH0", "PX1 = R21 - H31 - 2*UH1",
     "W0 = 3*UH0 - r0 + H30", "W1 = 3*UH1 - R21 + H31",
     "Ws = 3*UH0 + 3*UH1 - r0 - R21 + H30 + H31"],
    ["e0 = R0 * W0", "e1 = R1 * W1", "e2 = Rs * Ws",
     "f0 = PY0 * H30", "f1 = PY1 * H31", "f2 = y1s * H3s"],
    ["PY0 = e0 - e1 - f0 + f1", "PY1 = e2 - e0 - e1 - f2 + f0 + f1"],
]


@dataclass
class Op:
    dst: str
    mul: bool
    terms: List[Tuple[int, str]]  # (+1 | -1, name); a product's two factors
    scale: int = 1


def parse(stmt: str) -> Op:
    dst, rhs = (s.strip() for s in stmt.split("="))
    m = re.fullmatch(r"(\w+)\s*\*\s*(\w+)", rhs)
    if m and not m.group(1).isdigit():
        return Op(dst, True, [(1, m.group(1)), (1, m.group(2))])
    scale = 1
    m = re.fullmatch(r"(\d+)\*\((.*)\)", rhs)
    if m:
        scale, rhs = int(m.group(1)), m.group(2)
    terms = []
    for sign, coef, name in re.findall(r"([+-]?)\s*(?:(\d+)\*)?([A-Za-z_]\w*)", rhs):
        terms += [(-1 if sign == "-" else 1, name)] * int(coef or 1)
    return Op(dst, False, terms, scale)


@dataclass
class Program:
    stages: List[List[Op]]
    slot: Dict[str, int]  # name -> slot; a name written twice is an input slot
    nslots: int


def allocate(stages_src, inputs: List[str], outputs: List[str]) -> Program:
    """Parse and place every value in the lowest slot free over its life
    (from the stage that writes it to the last stage that reads it). Of the
    inputs, only ``outputs`` (P's slots) may be written."""
    stages = [[parse(s) for s in st] for st in stages_src]
    slot = {name: i for i, name in enumerate(inputs)}
    born, last = {}, {}
    for si, st in enumerate(stages):
        for op in st:
            for _s, name in op.terms:
                if name not in slot and name not in born:
                    raise ValueError(f"stage {si}: {name} read before it is written")
                last[name] = si
            if op.dst in slot:
                if op.dst not in outputs:
                    raise ValueError(f"stage {si}: {op.dst} overwrites an input")
            elif op.dst in born:
                raise ValueError(f"stage {si}: {op.dst} written twice")
            else:
                born[op.dst] = si
    busy: List[int] = [len(stages)] * len(inputs)  # input slots stay reserved
    for name, b in sorted(born.items(), key=lambda kv: kv[1]):
        free = [i for i, until in enumerate(busy) if until < b]
        end = last.get(name, len(stages))
        if free:
            slot[name] = free[0]
            busy[free[0]] = end
        else:
            slot[name] = len(busy)
            busy.append(end)
    prog = Program(stages, slot, len(busy))
    for si, st in enumerate(stages):
        writes = [slot[op.dst] for op in st]
        reads = {slot[n] for op in st for _s, n in op.terms}
        if len(set(writes)) != len(writes) or reads & set(writes):
            raise ValueError(f"stage {si}: a slot is read and written in one stage")
        for op in st:
            if not op.mul and len(op.terms) > MAX_TERMS:
                raise ValueError(f"{op.dst}: more than {MAX_TERMS} terms")
    return prog


@dataclass
class Group:
    """A group's programs and the kernel's edge rules over them: the adds
    test H = R = 0 (P == Q) on the ``check`` values after stage
    ``check_stage`` and fall to the double there."""

    prefix: str  # of the header's names
    p_slots: List[str]
    programs: Dict[str, Program]  # "DBL", then the adds
    check_stage: int
    check: List[str]

    @property
    def ncoord(self) -> int:
        return len(self.p_slots)


def _group(prefix, p_slots, q_slots, double, adds, check_stage, check) -> Group:
    programs = {"DBL": allocate(double, p_slots, p_slots)}
    for name, src in adds.items():
        # P == Q falls to the double on P's slots, so the adds keep them
        # until the test
        assert all(op.dst not in p_slots for st in src[: check_stage + 1] for op in map(parse, st))
        programs[name] = allocate(src, p_slots + q_slots, p_slots)
    return Group(prefix, p_slots, programs, check_stage, check)


GROUPS = {
    "g1": _group("G1T", ["PX", "PY", "PZ"], ["QX", "QY", "QZ"], G1_DOUBLE, {"ADD": G1_ADD},
                 2, ["H", "R"]),
    "g2": _group("G2T", ["PX0", "PX1", "PY0", "PY1", "PZ0", "PZ1"],
                 ["QX0", "QX1", "QY0", "QY1", "QZ0", "QZ1"], G2_DOUBLE,
                 {"ADD": G2_ADD, "MADD": G2_MADD}, 4, ["H0", "H1", "R0", "R1"]),
}


def _of(coords: List[int]) -> Group:
    """The group whose points have len(coords) Fp coordinates."""
    return {g.ncoord: g for g in GROUPS.values()}[len(coords)]


def run(prog: Program, slots: List[int], p: int, stages=None) -> List[int]:
    """Execute stages (all by default) on Python ints mod p, in place: every
    operation of a stage reads the slots as they were when the stage began."""
    for st in prog.stages if stages is None else prog.stages[stages]:
        out = []
        for op in st:
            vals = [s * slots[prog.slot[n]] for s, n in op.terms]
            v = vals[0] * vals[1] if op.mul else op.scale * sum(vals)
            out.append((prog.slot[op.dst], v % p))
        for i, v in out:
            slots[i] = v
    return slots


def team_double(coords: List[int], k: int, p: int) -> List[int]:
    """2^k P as the double kernel computes it: coords are P's Fp values (G1
    x, y, z; G2 x.c0 .. z.c1) as ints mod p; returns the result's."""
    g = _of(coords)
    prog = g.programs["DBL"]
    slots = list(coords) + [0] * (prog.nslots - g.ncoord)
    for _ in range(k):
        run(prog, slots, p)
    return slots[: g.ncoord]


def team_add(pc: List[int], qc: List[int], p: int, name: str = "ADD") -> List[int]:
    """P + Q as the add (``name`` "ADD") or G2 mixed add ("MADD", Q affine)
    kernel computes it, edge rules in the kernel's order: P = inf -> Q;
    Q = inf -> P; H = R = 0 -> double(P)."""
    g = _of(pc)
    z = slice(2 * g.ncoord // 3, None)  # Z's coordinates
    if not any(pc[z]):
        return list(qc)
    if not any(qc[z]):
        return list(pc)
    prog = g.programs[name]
    slots = list(pc) + list(qc) + [0] * (prog.nslots - 2 * g.ncoord)
    run(prog, slots, p, slice(0, g.check_stage + 1))
    if all(slots[prog.slot[n]] == 0 for n in g.check):
        return team_double(slots[: g.ncoord], 1, p)
    run(prog, slots, p, slice(g.check_stage + 1, None))
    return slots[: g.ncoord]


def _records(prog: Program) -> List[str]:
    rows = []
    for si, st in enumerate(prog.stages):
        for op in st:
            terms = [prog.slot[n] | (0x80 if s < 0 else 0) for s, n in op.terms]
            kind = 1 if op.mul else 0
            body = ", ".join(str(t) for t in terms + [0] * (MAX_TERMS - len(terms)))
            text = " ".join(("- " if s < 0 else "+ ") + n for s, n in op.terms)[2:]
            if op.mul:
                text = " * ".join(n for _s, n in op.terms)
            elif op.scale != 1:
                text = f"{op.scale} * ({text})"
            rows.append(f"    {{{prog.slot[op.dst]}, {op.scale}, {len(terms)}, {kind}, {{{body}}}}},"
                        f"  // s{si}: {op.dst} = {text}")
    return rows


def emit_header() -> str:
    lines = [
        "// Generated by spartan_tpu_torch/ops/team.py (python -m spartan_tpu_torch.ops.team);",
        "// do not edit. The stage programs of the team point kernels (team.cuh).",
        "#pragma once",
    ]
    for g in GROUPS.values():
        dbl = g.programs["DBL"]
        lines += ["", f"// {g.prefix[:2]}: P in slots 0-{g.ncoord - 1}, Q in slots "
                  f"{g.ncoord}-{2 * g.ncoord - 1}",
                  f"#define {g.prefix}_DBL_SLOTS {dbl.nslots}"]
        for name, prog in g.programs.items():
            if name != "DBL":  # an add may fall to the double
                lines.append(f"#define {g.prefix}_{name}_SLOTS {max(dbl.nslots, prog.nslots)}")
        for name, prog in g.programs.items():
            ends, n = [], 0
            for st in prog.stages:
                n += len(st)
                ends.append(n)
            lines += [
                f"#define {g.prefix}_{name}_NSTAGE {len(prog.stages)}",
                f"static __constant__ uint8_t {g.prefix}_{name}_END[{len(ends)}] = "
                f"{{{', '.join(map(str, ends))}}};",
                f"static __constant__ TeamOp {g.prefix}_{name}_OPS[{n}] = {{",
                *_records(prog),
                "};",
            ]
        lines += [f"#define {g.prefix}_CHECK_STAGE {g.check_stage}  // the adds test H = R = 0 after it",
                  f"#define {g.prefix}_NCHECK {len(g.check)}"]
        for name, prog in g.programs.items():
            if name != "DBL":
                lines.append(f"static __constant__ uint8_t {g.prefix}_{name}_CHECK[{len(g.check)}] = {{"
                             + ", ".join(str(prog.slot[n]) for n in g.check) + "};")
    lines.append("")
    return "\n".join(lines)


HEADER = Path(__file__).resolve().parent.parent / "csrc" / "team_prog.cuh"

if __name__ == "__main__":
    HEADER.write_text(emit_header())
    print(f"wrote {HEADER}")
