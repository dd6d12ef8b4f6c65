// spartan_pairing — native BLS12-381 pairing + small-G1 host ops.
//
// TPU-native equivalent of the reference's use of `E::pairing` /
// `E::product_of_pairings` (reference: src/commitment/verify.rs:15,41) and
// the handful of host-side G1 scalar-muls in PC verification
// (verify.rs:14,21-24). The pairing appears only in verification — 2*(nv+1)
// pairings per proof — so it belongs on the host CPU, but the pure-Python
// tower (spartan_tpu/host/{field,pairing}.py) costs ~40ms per pairing;
// this native port of the SAME formulas runs them ~20x faster, taking the
// verifier's pairing wall off the critical path. Bit-identical to the
// Python oracle (cross-checked in tests/test_native.py).
//
// Representation: Fp = 6x64-bit Montgomery (R = 2^384); Fp2/Fp6/Fp12 towers
// use exactly the Karatsuba/xi formulas of host/field.py so every value is
// reproducible against the oracle. Constants come from
// scripts/gen_pairing_constants.py (pairing_constants.h).
//
// Build: compiled into libspartan_host.so together with spartan_host.cpp
// (see spartan_tpu_torch/host/native.py). A copy of the JAX package's
// native/spartan_pairing.cpp.

#include <cstdint>
#include <cstring>

#include "pairing_constants.h"

namespace {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fp: 6x64 Montgomery
// ---------------------------------------------------------------------------

struct Fp {
  uint64_t l[6];
};

static const Fp FP_ZERO = {{0, 0, 0, 0, 0, 0}};

static inline bool fp_is_zero(const Fp& a) {
  uint64_t acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.l[i];
  return acc == 0;
}

static inline bool fp_eq(const Fp& a, const Fp& b) {
  uint64_t acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.l[i] ^ b.l[i];
  return acc == 0;
}

static inline bool fp_geq_p(const Fp& a) {
  for (int i = 5; i >= 0; i--) {
    if (a.l[i] > FP_P[i]) return true;
    if (a.l[i] < FP_P[i]) return false;
  }
  return true;  // equal
}

static inline void fp_sub_p(Fp& a) {
  uint64_t borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.l[i] - FP_P[i] - borrow;
    a.l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
}

static inline Fp fp_add(const Fp& a, const Fp& b) {
  Fp r;
  uint64_t carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)a.l[i] + b.l[i] + carry;
    r.l[i] = (uint64_t)s;
    carry = (uint64_t)(s >> 64);
  }
  if (carry || fp_geq_p(r)) fp_sub_p(r);
  return r;
}

static inline Fp fp_sub(const Fp& a, const Fp& b) {
  Fp r;
  uint64_t borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    r.l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 s = (u128)r.l[i] + FP_P[i] + carry;
      r.l[i] = (uint64_t)s;
      carry = (uint64_t)(s >> 64);
    }
  }
  return r;
}

static inline Fp fp_neg(const Fp& a) {
  if (fp_is_zero(a)) return a;
  Fp r;
  uint64_t borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)FP_P[i] - a.l[i] - borrow;
    r.l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  return r;
}

// CIOS Montgomery multiplication (Koc/Acar): r = a*b*R^{-1} mod p
static Fp fp_mul(const Fp& a, const Fp& b) {
  uint64_t t[8] = {0};
  for (int i = 0; i < 6; i++) {
    uint64_t carry = 0;
    for (int j = 0; j < 6; j++) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
      t[j] = (uint64_t)s;
      carry = (uint64_t)(s >> 64);
    }
    u128 s = (u128)t[6] + carry;
    t[6] = (uint64_t)s;
    t[7] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * FP_INV;
    u128 c = (u128)t[0] + (u128)m * FP_P[0];
    carry = (uint64_t)(c >> 64);
    for (int j = 1; j < 6; j++) {
      c = (u128)t[j] + (u128)m * FP_P[j] + carry;
      t[j - 1] = (uint64_t)c;
      carry = (uint64_t)(c >> 64);
    }
    c = (u128)t[6] + carry;
    t[5] = (uint64_t)c;
    t[6] = t[7] + (uint64_t)(c >> 64);
    t[7] = 0;
  }
  Fp r;
  memcpy(r.l, t, 48);
  if (t[6] || fp_geq_p(r)) fp_sub_p(r);
  return r;
}

static inline Fp fp_sq(const Fp& a) { return fp_mul(a, a); }

static Fp fp_from_canonical(const uint64_t* limbs) {
  Fp a;
  memcpy(a.l, limbs, 48);
  Fp r2;
  memcpy(r2.l, FP_R2, 48);
  return fp_mul(a, r2);
}

static void fp_to_canonical(const Fp& a, uint64_t* out) {
  // multiply by 1 (not Montgomery one) to divide by R
  Fp one = {{1, 0, 0, 0, 0, 0}};
  Fp c = fp_mul(a, one);
  memcpy(out, c.l, 48);
}

static Fp fp_one() {
  Fp r;
  memcpy(r.l, FP_ONE_MONT, 48);
  return r;
}

// a^(p-2) via square-and-multiply (host verifier path; timing is not secret)
static Fp fp_inv(const Fp& a) {
  // exponent p-2, little-endian limbs
  uint64_t e[6];
  memcpy(e, FP_P, 48);
  uint64_t borrow = 2;
  for (int i = 0; i < 6 && borrow; i++) {
    uint64_t v = e[i];
    e[i] = v - borrow;
    borrow = v < borrow ? 1 : 0;
  }
  Fp result = fp_one();
  Fp base = a;
  for (int limb = 0; limb < 6; limb++) {
    uint64_t bits = e[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1) result = fp_mul(result, base);
      base = fp_sq(base);
      bits >>= 1;
    }
  }
  return result;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)   (formulas mirror host/field.py fp2_*)
// ---------------------------------------------------------------------------

struct Fp2 {
  Fp c0, c1;
};

static inline Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
static inline Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
static inline Fp2 fp2_neg(const Fp2& a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
static inline Fp2 fp2_conj(const Fp2& a) { return {a.c0, fp_neg(a.c1)}; }

static Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  Fp t0 = fp_mul(a.c0, b.c0);
  Fp t1 = fp_mul(a.c1, b.c1);
  Fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
}

static Fp2 fp2_sq(const Fp2& a) {
  Fp t0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
  Fp t1 = fp_mul(a.c0, a.c1);
  return {t0, fp_add(t1, t1)};
}

static Fp2 fp2_inv(const Fp2& a) {
  Fp norm = fp_add(fp_sq(a.c0), fp_sq(a.c1));
  Fp ninv = fp_inv(norm);
  return {fp_mul(a.c0, ninv), fp_neg(fp_mul(a.c1, ninv))};
}

static inline Fp2 fp2_mul_by_xi(const Fp2& a) {
  // xi = 1 + u: (a0 - a1) + (a0 + a1) u
  return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

static inline bool fp2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fp6 {
  Fp2 c0, c1, c2;
};

static inline Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  return {fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1), fp2_add(a.c2, b.c2)};
}
static inline Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  return {fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1), fp2_sub(a.c2, b.c2)};
}
static inline Fp6 fp6_neg(const Fp6& a) {
  return {fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2)};
}

static Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  Fp2 t0 = fp2_mul(a.c0, b.c0);
  Fp2 t1 = fp2_mul(a.c1, b.c1);
  Fp2 t2 = fp2_mul(a.c2, b.c2);
  Fp2 c0 = fp2_add(
      t0, fp2_mul_by_xi(fp2_sub(
              fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2)),
              fp2_add(t1, t2))));
  Fp2 c1 = fp2_add(
      fp2_sub(fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1)),
              fp2_add(t0, t1)),
      fp2_mul_by_xi(t2));
  Fp2 c2 = fp2_add(
      fp2_sub(fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2)),
              fp2_add(t0, t2)),
      t1);
  return {c0, c1, c2};
}

static inline Fp6 fp6_sq(const Fp6& a) { return fp6_mul(a, a); }

static inline Fp6 fp6_mul_by_v(const Fp6& a) {
  return {fp2_mul_by_xi(a.c2), a.c0, a.c1};
}

static Fp6 fp6_inv(const Fp6& a) {
  Fp2 c0 = fp2_sub(fp2_sq(a.c0), fp2_mul_by_xi(fp2_mul(a.c1, a.c2)));
  Fp2 c1 = fp2_sub(fp2_mul_by_xi(fp2_sq(a.c2)), fp2_mul(a.c0, a.c1));
  Fp2 c2 = fp2_sub(fp2_sq(a.c1), fp2_mul(a.c0, a.c2));
  Fp2 t = fp2_add(
      fp2_mul_by_xi(fp2_add(fp2_mul(a.c2, c1), fp2_mul(a.c1, c2))),
      fp2_mul(a.c0, c0));
  Fp2 tinv = fp2_inv(t);
  return {fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv)};
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp12 {
  Fp6 c0, c1;
};

static Fp12 fp12_one() {
  Fp12 r;
  memset(&r, 0, sizeof(r));
  r.c0.c0.c0 = fp_one();
  return r;
}

static Fp12 fp12_mul(const Fp12& a, const Fp12& b) {
  Fp6 t0 = fp6_mul(a.c0, b.c0);
  Fp6 t1 = fp6_mul(a.c1, b.c1);
  Fp6 c0 = fp6_add(t0, fp6_mul_by_v(t1));
  Fp6 c1 = fp6_sub(fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1)),
                   fp6_add(t0, t1));
  return {c0, c1};
}

static Fp12 fp12_sq(const Fp12& a) {
  Fp6 t0 = fp6_mul(a.c0, a.c1);
  Fp6 c0 = fp6_add(
      fp6_mul(fp6_add(a.c0, a.c1), fp6_add(a.c0, fp6_mul_by_v(a.c1))),
      fp6_neg(fp6_add(t0, fp6_mul_by_v(t0))));
  return {c0, fp6_add(t0, t0)};
}

static inline Fp12 fp12_conj(const Fp12& a) { return {a.c0, fp6_neg(a.c1)}; }

static Fp12 fp12_inv(const Fp12& a) {
  Fp6 t = fp6_sub(fp6_sq(a.c0), fp6_mul_by_v(fp6_sq(a.c1)));
  Fp6 tinv = fp6_inv(t);
  return {fp6_mul(a.c0, tinv), fp6_neg(fp6_mul(a.c1, tinv))};
}

// x^(p^i) with i in 0..11
static Fp12 fp12_frob(const Fp12& a, int i) {
  i = ((i % 12) + 12) % 12;
  auto fp2_frob = [&](const Fp2& x) { return (i % 2 == 0) ? x : fp2_conj(x); };
  auto load2 = [](const uint64_t* base, int idx) {
    Fp2 r;
    memcpy(r.c0.l, base + 12 * idx, 48);
    memcpy(r.c1.l, base + 12 * idx + 6, 48);
    return r;
  };
  Fp2 g = load2(FROB_GAMMA_12, i);
  Fp2 f1 = load2(FROB_C1_6, i % 6);
  Fp2 f2 = load2(FROB_C2_6, i % 6);
  Fp6 c0 = {fp2_frob(a.c0.c0), fp2_mul(fp2_frob(a.c0.c1), f1),
            fp2_mul(fp2_frob(a.c0.c2), f2)};
  Fp6 c1 = {fp2_frob(a.c1.c0), fp2_mul(fp2_frob(a.c1.c1), f1),
            fp2_mul(fp2_frob(a.c1.c2), f2)};
  c1 = {fp2_mul(c1.c0, g), fp2_mul(c1.c1, g), fp2_mul(c1.c2, g)};
  return {c0, c1};
}

// a^e for a 64-bit exponent (square-and-multiply, MSB first)
static Fp12 fp12_pow_u64(const Fp12& a, uint64_t e) {
  Fp12 result = fp12_one();
  Fp12 base = a;
  while (e) {
    if (e & 1) result = fp12_mul(result, base);
    base = fp12_sq(base);
    e >>= 1;
  }
  return result;
}

static inline Fp2 fp2_scale_fp(const Fp2& a, const Fp& s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

// (a0 + a1 v + a2 v^2)(b0 + b1 v) with v^3 = xi  — sparse Fp6 mul
static Fp6 fp6_mul_by_01(const Fp6& a, const Fp2& b0, const Fp2& b1) {
  Fp2 a0b0 = fp2_mul(a.c0, b0);
  Fp2 a1b1 = fp2_mul(a.c1, b1);
  Fp2 a2b1 = fp2_mul(a.c2, b1);
  Fp2 a0b1 = fp2_mul(a.c0, b1);
  Fp2 a1b0 = fp2_mul(a.c1, b0);
  Fp2 a2b0 = fp2_mul(a.c2, b0);
  return {fp2_add(a0b0, fp2_mul_by_xi(a2b1)), fp2_add(a0b1, a1b0),
          fp2_add(a1b1, a2b0)};
}

// (a0 + a1 v + a2 v^2)(b1 v) with v^3 = xi  — sparse Fp6 mul by a v-multiple
static Fp6 fp6_mul_by_1(const Fp6& a, const Fp2& b1) {
  return {fp2_mul_by_xi(fp2_mul(a.c2, b1)), fp2_mul(a.c0, b1),
          fp2_mul(a.c1, b1)};
}

// f * ((c0 + c1 v) + c4 v w)  — the M-twist sparse line-element product
static Fp12 fp12_mul_by_014(const Fp12& f, const Fp2& c0, const Fp2& c1,
                            const Fp2& c4) {
  Fp6 a = fp6_mul_by_01(f.c0, c0, c1);
  Fp6 b = fp6_mul_by_1(f.c1, c4);
  Fp2 c1p4 = fp2_add(c1, c4);
  Fp6 e = fp6_mul_by_01(fp6_add(f.c0, f.c1), c0, c1p4);
  Fp6 ab = fp6_add(a, b);
  return {fp6_add(a, fp6_mul_by_v(b)), fp6_sub(e, ab)};
}

// ---------------------------------------------------------------------------
// Miller loop — homogeneous projective accumulator on the twist E'(Fp2)
// with sparse line evaluation (standard BLS12 D-twist step formulas; no
// field inversions in the loop). The discarded line normalization factors
// live in Fp2 and are killed by the final exponentiation's easy part, so
// pairing results are bit-identical to the affine/untwist Python oracle
// (host/pairing.py) — asserted in tests/test_native.py.
// ---------------------------------------------------------------------------

struct G2Proj {  // homogeneous projective point on the twist
  Fp2 x, y, z;
};

struct TwistConsts {
  Fp two_inv;
  Fp2 b3;  // 3 * b' = 3 * 4(1+u) = (12, 12)
  TwistConsts() {
    Fp one = fp_one();
    two_inv = fp_inv(fp_add(one, one));
    Fp twelve = FP_ZERO;
    for (int i = 0; i < 12; i++) twelve = fp_add(twelve, one);
    b3 = {twelve, twelve};
  }
};
static const TwistConsts TWIST;

// Doubling step: T <- 2T, returns line coefficients (c0, c1, c2) in the
// M-twist 014-sparse layout (BLS12-381's twist b' = 4(1+u) = b*xi is M-type).
static void doubling_step(G2Proj& r, Fp2* l0, Fp2* l1, Fp2* l2) {
  Fp2 a = fp2_mul(r.x, r.y);
  a = fp2_scale_fp(a, TWIST.two_inv);
  Fp2 b = fp2_sq(r.y);
  Fp2 c = fp2_sq(r.z);
  Fp2 e = fp2_mul(TWIST.b3, c);
  Fp2 f = fp2_add(fp2_add(e, e), e);
  Fp2 g = fp2_scale_fp(fp2_add(b, f), TWIST.two_inv);
  Fp2 h = fp2_sub(fp2_sq(fp2_add(r.y, r.z)), fp2_add(b, c));
  Fp2 i = fp2_sub(e, b);
  Fp2 j = fp2_sq(r.x);
  Fp2 e2 = fp2_sq(e);
  r.x = fp2_mul(a, fp2_sub(b, f));
  r.y = fp2_sub(fp2_sq(g), fp2_add(fp2_add(e2, e2), e2));
  r.z = fp2_mul(b, h);
  *l0 = i;
  *l1 = fp2_add(fp2_add(j, j), j);
  *l2 = fp2_neg(h);
}

// Addition step: T <- T + Q (Q affine), M-twist line coefficients.
static void addition_step(G2Proj& r, const Fp2& qx, const Fp2& qy, Fp2* l0,
                          Fp2* l1, Fp2* l2) {
  Fp2 theta = fp2_sub(r.y, fp2_mul(qy, r.z));
  Fp2 lambda = fp2_sub(r.x, fp2_mul(qx, r.z));
  Fp2 c = fp2_sq(theta);
  Fp2 d = fp2_sq(lambda);
  Fp2 e = fp2_mul(lambda, d);
  Fp2 f = fp2_mul(r.z, c);
  Fp2 g = fp2_mul(r.x, d);
  Fp2 h = fp2_sub(fp2_add(e, f), fp2_add(g, g));
  r.x = fp2_mul(lambda, h);
  r.y = fp2_sub(fp2_mul(theta, fp2_sub(g, h)), fp2_mul(e, r.y));
  r.z = fp2_mul(r.z, e);
  *l0 = fp2_sub(fp2_mul(theta, qx), fp2_mul(lambda, qy));
  *l1 = fp2_neg(theta);
  *l2 = lambda;
}

// g1: affine canonical (x,y) 12 limbs; g2: affine canonical Fp2 pairs 24 limbs
static Fp12 miller_loop(const uint64_t* g1, const uint64_t* g2) {
  Fp px = fp_from_canonical(g1);
  Fp py = fp_from_canonical(g1 + 6);
  Fp2 qx = {fp_from_canonical(g2), fp_from_canonical(g2 + 6)};
  Fp2 qy = {fp_from_canonical(g2 + 12), fp_from_canonical(g2 + 18)};

  Fp2 one2 = {fp_one(), FP_ZERO};
  G2Proj t = {qx, qy, one2};
  Fp12 f = fp12_one();
  Fp2 l0, l1, l2;
  int top = 63;
  while (!((BLS_X_ABS >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    f = fp12_sq(f);
    doubling_step(t, &l0, &l1, &l2);
    f = fp12_mul_by_014(f, l0, fp2_scale_fp(l1, px), fp2_scale_fp(l2, py));
    if ((BLS_X_ABS >> i) & 1) {
      addition_step(t, qx, qy, &l0, &l1, &l2);
      f = fp12_mul_by_014(f, l0, fp2_scale_fp(l1, px), fp2_scale_fp(l2, py));
    }
  }
  return fp12_conj(f);  // BLS parameter is negative
}

// ---------------------------------------------------------------------------
// Final exponentiation: easy part + Hayashida-Hayasaka-Teruya hard part
// (exactly host/pairing.py final_exponentiation — result is e(P,Q)^3)
// ---------------------------------------------------------------------------

static Fp12 final_exponentiation(const Fp12& f) {
  // easy: f^((p^6-1)(p^2+1))
  Fp12 m = fp12_mul(fp12_conj(f), fp12_inv(f));
  m = fp12_mul(fp12_frob(m, 2), m);
  // hard (HHT): (x-1)^2 (x+p) (x^2+p^2-1) + 3, x negative
  uint64_t x1 = BLS_X_ABS + 1;  // |x-1|
  Fp12 a = fp12_conj(fp12_pow_u64(m, x1));
  a = fp12_conj(fp12_pow_u64(a, x1));
  Fp12 b = fp12_mul(fp12_conj(fp12_pow_u64(a, BLS_X_ABS)), fp12_frob(a, 1));
  Fp12 bx2 = fp12_pow_u64(fp12_pow_u64(b, BLS_X_ABS), BLS_X_ABS);
  Fp12 c = fp12_mul(fp12_mul(bx2, fp12_frob(b, 2)), fp12_conj(b));
  return fp12_mul(c, fp12_mul(fp12_sq(m), m));
}

static void fp12_store_canonical(const Fp12& v, uint64_t* out) {
  const Fp* coeffs[12] = {
      &v.c0.c0.c0, &v.c0.c0.c1, &v.c0.c1.c0, &v.c0.c1.c1,
      &v.c0.c2.c0, &v.c0.c2.c1, &v.c1.c0.c0, &v.c1.c0.c1,
      &v.c1.c1.c0, &v.c1.c1.c1, &v.c1.c2.c0, &v.c1.c2.c1};
  for (int i = 0; i < 12; i++) fp_to_canonical(*coeffs[i], out + 6 * i);
}

// ---------------------------------------------------------------------------
// G1 (over Fp) Jacobian arithmetic for host-side scalar muls
// ---------------------------------------------------------------------------

struct G1Jac {
  Fp x, y, z;  // z==0 => infinity
};

static G1Jac g1_dbl(const G1Jac& p) {
  if (fp_is_zero(p.z) || fp_is_zero(p.y)) return {FP_ZERO, fp_one(), FP_ZERO};
  Fp a = fp_sq(p.x);
  Fp b = fp_sq(p.y);
  Fp c = fp_sq(b);
  Fp d = fp_sub(fp_sq(fp_add(p.x, b)), fp_add(a, c));
  d = fp_add(d, d);
  Fp e = fp_add(fp_add(a, a), a);
  Fp f = fp_sq(e);
  G1Jac r;
  r.x = fp_sub(f, fp_add(d, d));
  Fp c8 = fp_add(c, c);
  c8 = fp_add(c8, c8);
  c8 = fp_add(c8, c8);
  r.y = fp_sub(fp_mul(e, fp_sub(d, r.x)), c8);
  r.z = fp_mul(fp_add(p.y, p.y), p.z);
  return r;
}

static G1Jac g1_add(const G1Jac& p, const G1Jac& q) {
  if (fp_is_zero(p.z)) return q;
  if (fp_is_zero(q.z)) return p;
  Fp z1z1 = fp_sq(p.z);
  Fp z2z2 = fp_sq(q.z);
  Fp u1 = fp_mul(p.x, z2z2);
  Fp u2 = fp_mul(q.x, z1z1);
  Fp s1 = fp_mul(fp_mul(p.y, q.z), z2z2);
  Fp s2 = fp_mul(fp_mul(q.y, p.z), z1z1);
  if (fp_eq(u1, u2)) {
    if (fp_eq(s1, s2)) return g1_dbl(p);
    return {FP_ZERO, fp_one(), FP_ZERO};
  }
  Fp h = fp_sub(u2, u1);
  Fp i = fp_sq(fp_add(h, h));
  Fp j = fp_mul(h, i);
  Fp rr = fp_sub(s2, s1);
  rr = fp_add(rr, rr);
  Fp v = fp_mul(u1, i);
  G1Jac r;
  r.x = fp_sub(fp_sub(fp_sq(rr), j), fp_add(v, v));
  Fp s1j = fp_mul(s1, j);
  r.y = fp_sub(fp_mul(rr, fp_sub(v, r.x)), fp_add(s1j, s1j));
  r.z = fp_mul(fp_sub(fp_sq(fp_add(p.z, q.z)), fp_add(z1z1, z2z2)), h);
  return r;
}

// ---------------------------------------------------------------------------
// Fr: 4x64 Montgomery (R = 2^256) — for the verifier's O(nnz) matrix
// evaluation (reference src/ahp/verifier.rs:493-495 walks the full matrices
// on the host; same architecture here, but in native code).
// ---------------------------------------------------------------------------

struct Fr {
  uint64_t l[4];
};

static inline bool fr_geq_p(const Fr& a) {
  for (int i = 3; i >= 0; i--) {
    if (a.l[i] > FR_P[i]) return true;
    if (a.l[i] < FR_P[i]) return false;
  }
  return true;
}

static inline void fr_sub_p(Fr& a) {
  uint64_t borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.l[i] - FR_P[i] - borrow;
    a.l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
}

static inline Fr fr_add(const Fr& a, const Fr& b) {
  Fr r;
  uint64_t carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.l[i] + b.l[i] + carry;
    r.l[i] = (uint64_t)s;
    carry = (uint64_t)(s >> 64);
  }
  if (carry || fr_geq_p(r)) fr_sub_p(r);
  return r;
}

static inline Fr fr_sub(const Fr& a, const Fr& b) {
  Fr r;
  uint64_t borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    r.l[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
    for (int i = 0; i < 4; i++) {
      u128 s = (u128)r.l[i] + FR_P[i] + carry;
      r.l[i] = (uint64_t)s;
      carry = (uint64_t)(s >> 64);
    }
  }
  return r;
}

static Fr fr_mul(const Fr& a, const Fr& b) {
  uint64_t t[6] = {0};
  for (int i = 0; i < 4; i++) {
    uint64_t carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
      t[j] = (uint64_t)s;
      carry = (uint64_t)(s >> 64);
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * FR_INV;
    u128 c = (u128)t[0] + (u128)m * FR_P[0];
    carry = (uint64_t)(c >> 64);
    for (int j = 1; j < 4; j++) {
      c = (u128)t[j] + (u128)m * FR_P[j] + carry;
      t[j - 1] = (uint64_t)c;
      carry = (uint64_t)(c >> 64);
    }
    c = (u128)t[4] + carry;
    t[3] = (uint64_t)c;
    t[4] = t[5] + (uint64_t)(c >> 64);
    t[5] = 0;
  }
  Fr r;
  memcpy(r.l, t, 32);
  if (t[4] || fr_geq_p(r)) fr_sub_p(r);
  return r;
}

static Fr fr_from_canonical_bytes(const uint8_t* b32) {
  Fr a, r2;
  memcpy(a.l, b32, 32);
  memcpy(r2.l, FR_R2, 32);
  return fr_mul(a, r2);
}

static void fr_to_canonical_bytes(const Fr& a, uint8_t* out32) {
  Fr one = {{1, 0, 0, 0}};
  Fr c = fr_mul(a, one);
  memcpy(out32, c.l, 32);
}

static Fr fr_one_mont() {
  Fr r;
  memcpy(r.l, FR_ONE_MONT, 32);
  return r;
}

// eq(point, x) table over x in {0,1}^log_n, variable 0 = LSB (the MLE
// convention of ops/mle.py / linear-sumcheck). point: log_n canonical 32B.
// Doubling ladder: after round i, entry (h << i) | b holds the partial
// product with variable i set to h, so variable i lands at bit i.
static void fr_eq_table(const uint8_t* point, int log_n, Fr* table) {
  table[0] = fr_one_mont();
  uint64_t size = 1;
  for (int i = 0; i < log_n; i++) {
    Fr r = fr_from_canonical_bytes(point + 32 * i);
    for (uint64_t b = 0; b < size; b++) {
      table[size + b] = fr_mul(table[b], r);
      table[b] = fr_sub(table[b], table[size + b]);  // t*(1-r) = t - t*r
    }
    size <<= 1;
  }
}

// O(nnz) walk of one serialized sparse matrix against prebuilt eq tables.
// Returns 0 on success, nonzero rc on malformed input. Bounds checks divide
// instead of multiplying so a huge `len` cannot wrap the arithmetic.
static int32_t matrix_eval_walk(const uint8_t* ser, uint64_t ser_len,
                                const Fr* eqx, const Fr* eqy, uint64_t n,
                                Fr* acc_out) {
  if (ser_len < 8) return 1;
  uint64_t n_rows;
  memcpy(&n_rows, ser, 8);
  if (n_rows > n) return 2;
  Fr acc = {{0, 0, 0, 0}};
  const uint8_t* p = ser + 8;
  const uint8_t* end = ser + ser_len;
  for (uint64_t r = 0; r < n_rows; r++) {
    if ((uint64_t)(end - p) < 8) return 3;
    uint64_t len;
    memcpy(&len, p, 8);
    p += 8;
    if (len > (uint64_t)(end - p) / 40) return 4;
    for (uint64_t j = 0; j < len; j++) {
      Fr coeff = fr_from_canonical_bytes(p);
      p += 32;
      uint64_t col;
      memcpy(&col, p, 8);
      p += 8;
      if (col >= n) return 5;
      acc = fr_add(acc, fr_mul(fr_mul(coeff, eqx[r]), eqy[col]));
    }
  }
  *acc_out = acc;
  return 0;
}

}  // namespace

extern "C" {

// Evaluate sum_{(row,col,coeff)} coeff * eq(rx, row) * eq(ry, col) for one
// sparse matrix given in the arkworks serialized layout produced by
// utils/serialize.ser_matrix (u64 n_rows; per row u64 len; per entry 32-byte
// LE coeff + u64 col). rx/ry: log_n canonical 32-byte points each.
// out32: canonical Fr. Returns 0 on success, nonzero on malformed input.
int32_t spartan_matrix_eval(const uint8_t* ser, uint64_t ser_len,
                            const uint8_t* rx, const uint8_t* ry,
                            uint64_t log_n, uint8_t* out32) {
  uint64_t n = 1ULL << log_n;
  Fr* eqx = new Fr[n];
  Fr* eqy = new Fr[n];
  fr_eq_table(rx, (int)log_n, eqx);
  fr_eq_table(ry, (int)log_n, eqy);
  Fr acc;
  int32_t rc = matrix_eval_walk(ser, ser_len, eqx, eqy, n, &acc);
  if (rc == 0) fr_to_canonical_bytes(acc, out32);
  delete[] eqx;
  delete[] eqy;
  return rc;
}

// Same evaluation for THREE matrices (A, B, C) sharing one pair of eq
// tables — the verifier's deferred check needs all three at the same
// (rx, ry) (reference src/ahp/verifier.rs:493-495), and the two 2*2^log_n
// Fr-mul table builds dominate the walk for sparse circuits.
// out96: 3 canonical Fr values. Nonzero rc identifies the failing matrix
// in its tens digit (10/20/30) plus the walk rc in the ones digit.
int32_t spartan_matrix_eval3(const uint8_t* ser_a, uint64_t len_a,
                             const uint8_t* ser_b, uint64_t len_b,
                             const uint8_t* ser_c, uint64_t len_c,
                             const uint8_t* rx, const uint8_t* ry,
                             uint64_t log_n, uint8_t* out96) {
  uint64_t n = 1ULL << log_n;
  Fr* eqx = new Fr[n];
  Fr* eqy = new Fr[n];
  fr_eq_table(rx, (int)log_n, eqx);
  fr_eq_table(ry, (int)log_n, eqy);
  const uint8_t* sers[3] = {ser_a, ser_b, ser_c};
  const uint64_t lens[3] = {len_a, len_b, len_c};
  int32_t rc = 0;
  for (int m = 0; m < 3 && rc == 0; m++) {
    Fr acc;
    rc = matrix_eval_walk(sers[m], lens[m], eqx, eqy, n, &acc);
    if (rc == 0) fr_to_canonical_bytes(acc, out96 + 32 * m);
    else rc += 10 * (m + 1);
  }
  delete[] eqx;
  delete[] eqy;
  return rc;
}

// Product of n Miller loops + one shared final exponentiation.
//   g1: n x 12 limbs (affine canonical x,y);  g2: n x 24 limbs;
//   inf: n flags (1 = treat pair as 1 in GT);  out: 72 limbs canonical Fp12.
void spartan_pairing_product(const uint64_t* g1, const uint64_t* g2,
                             const uint8_t* inf, uint64_t n, uint64_t* out) {
  Fp12 f = fp12_one();
  for (uint64_t i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    f = fp12_mul(f, miller_loop(g1 + 12 * i, g2 + 24 * i));
  }
  fp12_store_canonical(final_exponentiation(f), out);
}

// Linear combination sum_i s_i * P_i over G1 (host-size n: a handful).
//   pts: n x 12 limbs affine canonical; inf: n flags; scalars: n x 4 limbs
//   (256-bit LE, already reduced mod r); out: 12 limbs affine canonical;
//   returns 1 if the result is infinity (out zeroed), else 0.
uint8_t spartan_g1_lincomb(const uint64_t* pts, const uint8_t* inf,
                           const uint64_t* scalars, uint64_t n,
                           uint64_t* out) {
  G1Jac acc = {FP_ZERO, fp_one(), FP_ZERO};
  for (uint64_t i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    G1Jac base = {fp_from_canonical(pts + 12 * i),
                  fp_from_canonical(pts + 12 * i + 6), fp_one()};
    const uint64_t* s = scalars + 4 * i;
    int top = 255;
    while (top >= 0 && !((s[top / 64] >> (top % 64)) & 1)) top--;
    G1Jac part = {FP_ZERO, fp_one(), FP_ZERO};
    for (int b = top; b >= 0; b--) {
      part = g1_dbl(part);
      if ((s[b / 64] >> (b % 64)) & 1) part = g1_add(part, base);
    }
    acc = g1_add(acc, part);
  }
  if (fp_is_zero(acc.z)) {
    memset(out, 0, 96);
    return 1;
  }
  Fp zinv = fp_inv(acc.z);
  Fp zinv2 = fp_sq(zinv);
  Fp zinv3 = fp_mul(zinv2, zinv);
  fp_to_canonical(fp_mul(acc.x, zinv2), out);
  fp_to_canonical(fp_mul(acc.y, zinv3), out + 6);
  return 0;
}

}  // extern "C"
