"""Stage programs of the team G2 kernels (K4 ``g2_add``, ``g2_madd`` and
``g2_double``, ``csrc/g2_team.cuh``), written at the level of Fp operations.

A team of T threads computes one G2 point. The formulas of ``ops/curve.py``
(dbl-2009-l, add-2007-bl, madd-2007-bl with a = 0) are written here as
stages: every operation of a stage reads only values that earlier stages
wrote, so the team's threads share out a stage's operations and meet at one
``__syncwarp`` after it. Karatsuba gives three independent Fp products per
Fp2 multiply and the complex square two, so the chain of dependent Fp
products is 3 deep for a double (16 products) and 5 deep for an add (44)
and a mixed add (30).

An operation is a Montgomery product ``d = a * b`` or a linear combination
``d = s * (sum of +-terms)``, a term repeated to give it a coefficient and
``s`` a small integer scale. Every value lives in a slot of the team's
shared memory, 12 limbs each. The inputs are P in slots 0-5 (x.c0, x.c1,
y.c0, y.c1, z.c0, z.c1) and, for the adds, Q in slots 6-11; the result
overwrites P's slots. ``allocate`` gives every other value the lowest slot
free over its lifetime and checks that no stage reads a slot that it also
writes, which makes the order of a stage's operations free.

``emit_header`` writes ``csrc/g2_team_prog.cuh``, the tables the kernels
run; ``python -m spartan_tpu_torch.ops.g2_team`` regenerates it. ``run``
executes a program on Python integers modulo p, which the CPU tests hold
against the plain point formulas.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

P_SLOTS = ["PX0", "PX1", "PY0", "PY1", "PZ0", "PZ1"]
Q_SLOTS = ["QX0", "QX1", "QY0", "QY1", "QZ0", "QZ1"]
MAX_TERMS = 12  # terms of one linear operation (the table's op record)

# dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C), E = 3A,
# X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ. A name ending in m is the
# product c0 * c1 of a complex square, whose c1 is twice it.
DOUBLE = [
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
ADD = [
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
ADD_CHECK_STAGE = 4  # after this stage the add kernels test H = R = 0 (P == Q)
ADD_CHECK = ["H0", "H1", "R0", "R1"]

# madd-2007-bl as in curve.add_mixed_plain, Q affine (Z2 = 1): Z1Z1 = Z1^2,
# U2 = X2 Z1Z1, S2 = Y2 Z1 Z1Z1, H = U2 - X1, R = S2 - Y1,
# X3 = R^2 - H^3 - 2 X1 H^2, Y3 = R (X1 H^2 - X3) - Y1 H^3, Z3 = Z1 H.
# 30 Fp products in 5 dependent stages; Q's Z slots are read only by the
# kernel's Q = inf test.
MADD = [
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


def allocate(stages_src, inputs: List[str]) -> Program:
    """Parse and place every value in the lowest slot free over its life
    (from the stage that writes it to the last stage that reads it)."""
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
                if op.dst not in P_SLOTS:
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


PROGRAMS = {"DBL": allocate(DOUBLE, P_SLOTS), "ADD": allocate(ADD, P_SLOTS + Q_SLOTS),
            "MADD": allocate(MADD, P_SLOTS + Q_SLOTS)}
# P == Q falls to the double on P's slots, so the adds keep them until then
assert all(op.dst not in P_SLOTS for src in (ADD, MADD)
           for st in src[: ADD_CHECK_STAGE + 1] for op in map(parse, st))


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
    """2^k P as the double kernel computes it: coords are P's six Fp values
    (x.c0 .. z.c1) as ints mod p; returns the result's six."""
    prog = PROGRAMS["DBL"]
    slots = list(coords) + [0] * (prog.nslots - 6)
    for _ in range(k):
        run(prog, slots, p)
    return slots[:6]


def team_add(pc: List[int], qc: List[int], p: int, name: str = "ADD") -> List[int]:
    """P + Q as the add (``name`` "ADD") or mixed add ("MADD", Q affine)
    kernel computes it, edge rules in the kernel's order: P = inf -> Q;
    Q = inf -> P; H = R = 0 -> double(P)."""
    if pc[4] == pc[5] == 0:
        return list(qc)
    if qc[4] == qc[5] == 0:
        return list(pc)
    prog = PROGRAMS[name]
    slots = list(pc) + list(qc) + [0] * (prog.nslots - 12)
    run(prog, slots, p, slice(0, ADD_CHECK_STAGE + 1))
    if all(slots[prog.slot[n]] == 0 for n in ADD_CHECK):
        return team_double(slots[:6], 1, p)
    run(prog, slots, p, slice(ADD_CHECK_STAGE + 1, None))
    return slots[:6]


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
    dbl, add, madd = PROGRAMS["DBL"], PROGRAMS["ADD"], PROGRAMS["MADD"]
    lines = [
        "// Generated by spartan_tpu_torch/ops/g2_team.py (python -m spartan_tpu_torch.ops.g2_team);",
        "// do not edit. The stage programs of the team G2 kernels (g2_team.cuh).",
        "#pragma once",
        "",
        f"#define G2T_DBL_SLOTS {dbl.nslots}",
        f"#define G2T_ADD_SLOTS {max(dbl.nslots, add.nslots)}  // the add may fall to the double",
        f"#define G2T_MADD_SLOTS {max(dbl.nslots, madd.nslots)}",
    ]
    for name, prog in PROGRAMS.items():
        ends, n = [], 0
        for st in prog.stages:
            n += len(st)
            ends.append(n)
        lines += [
            f"#define G2T_{name}_NSTAGE {len(prog.stages)}",
            f"static __constant__ uint8_t G2T_{name}_END[{len(ends)}] = {{{', '.join(map(str, ends))}}};",
            f"static __constant__ TeamOp G2T_{name}_OPS[{n}] = {{",
            *_records(prog),
            "};",
        ]
    lines.append(f"#define G2T_ADD_CHECK_STAGE {ADD_CHECK_STAGE}  // both adds")
    for name, prog in (("ADD", add), ("MADD", madd)):
        lines.append(f"static __constant__ uint8_t G2T_{name}_CHECK[4] = {{"
                     + ", ".join(str(prog.slot[n]) for n in ADD_CHECK) + "};")
    lines.append("")
    return "\n".join(lines)


HEADER = Path(__file__).resolve().parent.parent / "csrc" / "g2_team_prog.cuh"

if __name__ == "__main__":
    HEADER.write_text(emit_header())
    print(f"wrote {HEADER}")
