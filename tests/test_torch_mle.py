"""Port MLE, sparse and sumcheck-round operations vs the JAX package.

The same seeded Fr tables go through spartan_tpu.ops.{mle,sparse,sumcheck}
and their spartan_tpu_torch counterparts; results must be equal integers.
"""

import numpy as np
import pytest
import torch

from spartan_tpu.host import field as hf
from spartan_tpu.ops import field as jf
from spartan_tpu.ops import mle as jmle
from spartan_tpu.ops import sparse as jsparse
from spartan_tpu.ops import sumcheck as jsc
from spartan_tpu_torch.ops import field as tf
from spartan_tpu_torch.ops import mle as tmle
from spartan_tpu_torch.ops import sparse as tsparse
from spartan_tpu_torch.ops import sumcheck as tsc

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

N = 16


def _vals(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    return [sum(int(x) << (62 * i) for i, x in enumerate(row)) % hf.R for row in words]


def _both(vals):
    return jf.encode_mont(jf.FR, vals), tf.encode_mont(tf.FR, vals)


def _same(jarr, tarr):
    return jf.decode_mont(jf.FR, jarr) == tf.decode_mont(tf.FR, tarr)


def test_fold_eval_at_and_scale():
    jt, tt = _both(_vals(N, 1))
    jr, tr = _both(_vals(4, 2))
    assert _same(jmle.fold(jt, jr[:, 0]), tmle.fold(tt, tr[:, 0]))
    assert _same(jmle.eval_at(jt, jr), tmle.eval_at(tt, tr))
    assert _same(jmle.scale(jt, jr[:, 1]), tmle.scale(tt, tr[:, 1]))
    assert jf.decode_ints(jf.FR, jmle.sum_mod(jt)) == tf.decode_ints(tf.FR, tmle.sum_mod(tt))


def test_eq_tables():
    pt = _vals(4, 3)
    jp, tp = _both(pt)
    assert _same(jmle.eq_table(jp), tmle.eq_table(tp[None])[0])
    js, ts = jmle.eq_suffix_tables(pt), tmle.eq_suffix_tables(pt)
    assert len(js) == len(ts) == 5
    assert all(_same(a, b) for a, b in zip(js, ts))


@pytest.mark.parametrize("which", ["sum_over_y", "eval_on_x_table"])
def test_sparse_products(which):
    rng = np.random.default_rng(4)
    nnz = 40
    rows = rng.integers(0, N, size=nnz).astype(np.int64)
    cols = rng.integers(0, N, size=nnz).astype(np.int64)
    rows[:12] = 3  # one dense row and column
    cols[12:24] = 5
    vals = _vals(nnz, 5)
    jv, tv = _both(vals)
    jt, tt = _both(_vals(N, 6))
    jcoo = (jnp_i32(rows), jnp_i32(cols), jv)
    tcoo = (torch.from_numpy(rows), torch.from_numpy(cols), tv)
    assert _same(getattr(jsparse, which)(jcoo, jt, N), getattr(tsparse, which)(tcoo, tt[None], N)[0])


def jnp_i32(a):
    import jax.numpy as jnp

    return jnp.asarray(a.astype(np.int32))


@pytest.mark.parametrize("do_fold", [False, True])
def test_sumcheck_rounds(do_fold):
    tabs = [_both(_vals(N, 10 + i)) for i in range(4)]
    js, ts = _both(_vals(N // (4 if do_fold else 2), 20))
    jr, tr = _both(_vals(1, 21))
    jout = jsc.sc1_round(tabs[0][0], tabs[1][0], tabs[2][0], js, do_fold, jr)
    tout = tsc.sc1_round(tabs[0][1], tabs[1][1], tabs[2][1], ts, do_fold, tr)
    assert all(_same(a, b) for a, b in zip(jout, tout))
    jout = jsc.prod2_round(tabs[0][0], tabs[3][0], do_fold, jr)
    tout = tsc.prod2_round(tabs[0][1], tabs[3][1], do_fold, tr)
    assert all(_same(a, b) for a, b in zip(jout, tout))
