"""The port's device-resident transcript against the JAX package and the host
stream, on the CPU (plain versions; the kernels are held against these by
tests/test_torch_csrc_host.py here and by chip_smoke.py on the card):

- Blake2s of word-aligned messages against hashlib and the JAX package's
  ``blake2s_words``;
- the serialization words of Fr, feed and sample against the JAX package's
  ``fs_device`` and the port's host ``Blake2sRng``, rejections included;
- ``get_state``/``set_state`` of the native and the Python stream;
- the device-resident phases' plain versions (the route the CPU takes, and
  what the kernels are held against) at log_n = 3..10: their messages,
  challenges, round 4's values and chain states equal those of the JAX
  package's ``fused.sc1_phase`` and ``sc2_phase`` on the same inputs, kept
  in tests/fixtures/sumcheck_phases_jax.json by
  scripts/make_sumcheck_fixture.py (the JAX programs take about half a
  minute a size to compile on a CPU);
- a 2^5 prove through both routes (the device-resident phases and the host
  loop) gives the golden proof's bytes. The commitment's messages are taken
  from the golden proof, so no MSM runs here; the whole prove through the
  default route, MSMs included, is tests/test_torch_argument.py's, which
  also holds it against the golden bytes and the JAX package's verifier.
"""

import hashlib
import json
import pathlib
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.host import field as hf
from spartan_tpu.ops import blake2s as jb
from spartan_tpu.ops import fs_device as jfs
from spartan_tpu.utils import serialize as jser
from spartan_tpu_torch.ops import blake2s as tb
from spartan_tpu_torch.ops import field as tf
from spartan_tpu_torch.ops import fs_device as tfs
from spartan_tpu_torch.utils.transcript import Blake2sRng

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "proof_2e5_seed3.bin"
PHASES = pathlib.Path(__file__).parent / "fixtures" / "sumcheck_phases_jax.json"


def _random_words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("nwords", [0, 1, 8, 10, 16, 17])
def test_blake2s_matches_hashlib_and_jax(nwords):
    w = _random_words(nwords, nwords)
    got = tb.blake2s_words(torch.from_numpy(w.astype(np.int64)))
    want = hashlib.blake2s(w.astype("<u4").tobytes()).digest()
    assert tfs.words_to_state(got) == want
    assert np.array_equal(got.numpy(), np.asarray(jb.blake2s_words(jnp.asarray(w))).astype(np.int64))


def test_fr_serialization_words_are_the_limbs():
    """ser_fr of canonical values as words: the port's 32-bit limbs
    themselves, where the JAX package packs two 16-bit limbs a word."""
    xs = [0, 1, hf.R - 1, random.Random(5).randrange(hf.R)]
    words = tfs.limbs_to_words(tf.encode_ints(tf.FR, xs))
    assert b"".join(w.numpy().astype("<u4").tobytes() for w in words) == b"".join(map(jser.ser_fr, xs))
    from spartan_tpu.ops import field as jf

    jax_words = np.asarray(jfs.limbs_to_words(jf.encode_ints(jf.FR, xs)))
    assert np.array_equal(words.numpy(), jax_words.astype(np.int64))
    vec = tfs.ser_fr_vec_words(tf.encode_ints(tf.FR, xs)).numpy().astype("<u4").tobytes()
    assert vec == jser.ser_fr_vec(xs)


def test_feed_and_sample_match_jax_and_host_stream():
    """Feeds and 40 + 10 samples from the plain transcript, the JAX
    package's and the host stream: the same values; some draws rejected."""
    rng = random.Random(3)
    feed_a = bytes(rng.randrange(256) for _ in range(64))
    feed_b = bytes(rng.randrange(256) for _ in range(32))
    host = Blake2sRng.setup()
    host.feed(feed_a)
    want = host.sample_fr_vec(40)
    host.feed(feed_b)
    want += host.sample_fr_vec(10)

    def words(b: bytes) -> np.ndarray:
        return np.frombuffer(b, dtype="<u4").copy()

    st = tfs.fs_feed(tb.blake2s_words(torch.zeros(0, dtype=torch.int64)),
                     torch.from_numpy(words(feed_a).astype(np.int64)))
    jst = jfs.fs_feed(jb.blake2s_words(jnp.zeros(0, jnp.uint32)), jnp.asarray(words(feed_a)))
    assert np.array_equal(st.numpy(), np.asarray(jst).astype(np.int64))
    got, ctr = [], 0
    for _ in range(40):
        r, ctr = tfs.fs_sample_fr(st, ctr)
        got.append(int.from_bytes(tfs.words_to_state(r), "little"))
    assert ctr > 40  # rejections were drawn
    jl, jctr = jfs.fs_sample_fr_n(jst, jnp.uint32(0), 40)
    jl = np.asarray(jl)
    assert got == [sum(int(jl[i, j]) << (16 * i) for i in range(16)) for j in range(40)]
    assert ctr == int(jctr)
    st, ctr = tfs.fs_feed(st, torch.from_numpy(words(feed_b).astype(np.int64))), 0
    for _ in range(10):
        r, ctr = tfs.fs_sample_fr(st, ctr)
        got.append(int.from_bytes(tfs.words_to_state(r), "little"))
    assert got == want


@pytest.mark.parametrize("stream", ["native", "python"])
def test_get_and_set_state(stream, monkeypatch):
    """get_state after a feed is the chain state; set_state resumes from a
    state and restarts the output stream."""
    if stream == "python":
        from spartan_tpu_torch.host import native

        monkeypatch.setattr(native, "load", lambda: None)
    a = Blake2sRng.setup()
    assert (a._native is None) == (stream == "python")
    a.feed(b"spartan")
    state = a.get_state()
    assert state == hashlib.blake2s(hashlib.blake2s(b"").digest() + b"spartan").digest()
    first = a.sample_fr_vec(3)
    b = Blake2sRng.setup()
    b.sample_fr()  # a stream part-way through is restarted
    b.set_state(state)
    assert b.sample_fr_vec(3) == first and b.get_state() == state
    with pytest.raises(ValueError):
        b.set_state(state[:31])


@pytest.fixture(scope="module")
def golden_route():
    """prove's inputs at 2^5 (circuit seed 3) and a stand-in for the
    commitment: commit and open return the golden proof's messages, so a
    prove costs only its sumchecks and host work."""
    from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input
    from spartan_tpu_torch.protocol import prover as pr
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS
    from spartan_tpu_torch.protocol.proof import Proof

    cs, v, w = generate_circuit_with_random_input(num_public=4, num_private=28, pad_to_square=True,
                                                  density=1, rng=random.Random(3))
    pk = MLArgumentForR1CS.index(*cs.to_matrices(), "cpu")
    gold = Proof.deserialize(GOLDEN.read_bytes())
    opens = [(gold.prover_second_message.z_rv_0, gold.prover_second_message.proof_for_z_rv_0),
             (gold.prover_sixth_message.z_ry, gold.prover_sixth_message.proof_for_z_ry)]

    def prove(mp, route):
        mp.setattr(pr, "commit", lambda pp, z: gold.prover_first_message.commitment)
        it = iter(opens)
        mp.setattr(pr, "open_poly", lambda pp, z, point: (*next(it), None))
        if route == "host loop":
            mp.setenv("SPARTAN_DEVICE_FS", "0")
        else:
            mp.delenv("SPARTAN_DEVICE_FS", raising=False)
        return MLArgumentForR1CS.prove(pk, v, w, types.SimpleNamespace(device=torch.device("cpu")))

    return prove


def test_device_route_proof_equals_host_loop_and_golden(golden_route, monkeypatch):
    from spartan_tpu_torch import timers

    timers.reset()
    device = golden_route(monkeypatch, "device").serialize()
    assert "Prove Sumcheck 1 (fused)" in timers.SPANS and "Prove Sumcheck 1" not in timers.SPANS
    host = golden_route(monkeypatch, "host loop").serialize()
    assert "Prove Sumcheck 1" in timers.SPANS
    assert device == host == GOLDEN.read_bytes()


def _phase_inputs(log_n: int):
    """Tables Az, Bz, Cz, W, Z, tor and a chain state, drawn as
    scripts/make_sumcheck_fixture.py draws them."""
    rng = random.Random(1000 + log_n)
    n = 1 << log_n
    tabs = [[rng.randrange(hf.R) for _ in range(n)] for _ in range(5)]
    tor = [rng.randrange(hf.R) for _ in range(log_n)]
    state = bytes(rng.randrange(256) for _ in range(32))
    return tabs, tor, state


@pytest.mark.parametrize("log_n", range(3, 11))
def test_plain_phases_match_jax_fused(log_n):
    """Both phases through protocol.fused on CPU tensors (the plain versions
    of the round launches, from log_n = 9, and of the one-block tail) against
    spartan_tpu's fused.sc1_phase and sc2_phase: every message, challenge,
    round 4's va, vb, vc and r_a, r_b, r_c, and the chain states."""
    from spartan_tpu_torch.ops import mle as tm
    from spartan_tpu_torch.protocol import fused

    want = json.loads(PHASES.read_text())[str(log_n)]
    ints = lambda xs: [int(x, 16) for x in xs]  # noqa: E731
    tabs, tor, state = _phase_inputs(log_n)
    mont = [tf.encode_mont(tf.FR, t) for t in tabs]
    suffix = [t[None] for t in tm.eq_suffix_tables(tor, "cpu")]
    (r1,) = fused.sc1_phase(*(t[None] for t in mont[:3]), suffix, [tor], [state])  # B = 1
    assert r1.evals == [ints(e) for e in want["sc1"]["evals"]]
    assert (r1.rs, r1.vabc, r1.rabc) == (ints(want["sc1"]["rs"]), ints(want["sc1"]["vabc"]),
                                         ints(want["sc1"]["rabc"]))
    assert r1.state.hex() == want["sc1"]["state"]
    (r2,) = fused.sc2_phase(mont[3][None], mont[4][None], [state])
    assert r2.evals == [ints(e) for e in want["sc2"]["evals"]] and r2.rs == ints(want["sc2"]["rs"])
    assert r2.state.hex() == want["sc2"]["state"]
