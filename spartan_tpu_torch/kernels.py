"""Build, load and launch the hand-written Hopper kernels (csrc/*.cu).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/libspartan_kernels.so``, and bound
with ``ctypes``: device pointers and the CUDA stream go in as ``c_void_p``,
lane counts as ``c_int64``, and every entry point returns
``cudaGetLastError()`` right after its launch.

The library is built at first use and rebuilt when the hash of the sources
changes. There is no fallback: a missing ``nvcc``, a failed compile or a
failed load raises ``KernelBuildError`` with the compiler's output.

Every entry point has a launch counter in ``LAUNCHES``; ``launch`` adds one
where it launches and nowhere else, so a run can show which kernels its path
went through. ``DOUBLINGS`` counts the doublings the double kernels did
(one ``g1_double`` or ``g2_double`` launch doubles k times) and ``LANES``
the launches of each kernel by lane count and int arguments.

``YARDSTICKS`` are entry points that only ``chip_smoke.py`` calls, to time a
kernel against other versions of it (the team point kernels at each team
size, the one-thread G1 and G2 kernels and Fp inversion, the Fr and Fp
products before the carry flag); they count no launches.

``PHASE_KERNELS`` are the kernels of the device-resident sumcheck phases,
which replace JAX functions that are not Pallas kernels: the round kernels
K6 and K7, each round with its transcript step (K5) in the same launch, and
the one-block tails that run a phase's last rounds (``csrc/sumcheck_ops.cu``),
each on a batch axis (B instances of one circuit a launch; the single prove
is B = 1); and one that only ``chip_smoke.py`` calls, K5's Blake2s as a
batch (``blake2s_batch``). Their arguments are tensors of any shape and
ints; ``call`` launches them and counts like ``launch``.

``FUSED_KERNELS`` are K1 and K2 where the prover runs them on whole
functions that the JAX package computes as one function, not as Pallas
kernels: Jacobian-to-affine normalization of G1 and G2 points
(``csrc/normalize.cuh``, entry points in ``fp_ops.cu``), the eq tables and
the openings' quotient ladder (``csrc/fr_tables.cuh``, entry points in
``fr_ops.cu``). ``call`` launches them too.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB_NAME = "libspartan_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# entry point -> (number of input arrays, source file, Pallas function replaced)
KERNELS = {
    "fr_mul": (2, "fr_ops.cu", "spartan_tpu/ops/pallas_field.py:254"),
    "fr_add": (2, "fr_ops.cu", "spartan_tpu/ops/pallas_field.py:258"),
    "fr_sub": (2, "fr_ops.cu", "spartan_tpu/ops/pallas_field.py:262"),
    "fp_mul": (2, "fp_ops.cu", "spartan_tpu/ops/pallas_field.py:254"),
    "fp_add": (2, "fp_ops.cu", "spartan_tpu/ops/pallas_field.py:258"),
    "fp_sub": (2, "fp_ops.cu", "spartan_tpu/ops/pallas_field.py:262"),
    "fp_inv": (1, "fp_ops.cu", "spartan_tpu/ops/field.py:299"),
    "g1_madd": (2, "g1_ops.cu", "spartan_tpu/ops/pallas_curve.py:385"),
    "g1_add": (2, "g1_team.cu", "spartan_tpu/ops/pallas_curve.py:378"),
    "g1_double": (1, "g1_team.cu", "spartan_tpu/ops/pallas_curve.py:392"),
    "g2_madd": (2, "g2_team.cu", "spartan_tpu/ops/pallas_curve.py:410"),
    "g2_add": (2, "g2_team.cu", "spartan_tpu/ops/pallas_curve.py:399"),
    "g2_double": (1, "g2_team.cu", "spartan_tpu/ops/pallas_curve.py:421"),
}

# entry point -> number of int arguments after the lane count
INT_ARGS = {"g1_double": 1, "g2_double": 1}  # k: the launch returns 2^k P

# yardstick -> (number of input arrays, number of int arguments)
YARDSTICKS = {
    "fr_mul_sum64": (2, 0),  # field.cuh's product, fr_mul's before the carry flag
    "fp_mul_sum64": (2, 0),  # field.cuh's product, fp_mul's before the carry flag
    "g1_add_team": (2, 1),  # team size
    "g1_madd_team": (2, 1),  # team size
    "g1_double_team": (1, 2),  # k, team size
    "g1_add_onethread": (2, 0),
    "g1_madd_onethread": (2, 0),
    "g1_double_onethread": (1, 0),
    "g2_add_team": (2, 1),  # team size
    "g2_madd_team": (2, 1),  # team size
    "g2_double_team": (1, 2),  # k, team size
    "g2_add_onethread": (2, 0),
    "g2_madd_onethread": (2, 0),
    "g2_double_onethread": (1, 0),
    "fp_inv_thread": (1, 0),
}

# entry point -> (source file, JAX function replaced, tensor arguments, int arguments); the phase kernels' last
# ints are B, then (sc1's) the weights' and the transcript's instance strides, and each also replaces its batched
# counterpart in spartan_tpu/protocol/batched.py (:269 with :248, :371 with :377, :290, :388)
PHASE_KERNELS = {
    "sc1_round": ("sumcheck_ops.cu", "spartan_tpu/ops/sumcheck.py:77", 18, 7),
    "prod2_round": ("sumcheck_ops.cu", "spartan_tpu/ops/sumcheck.py:97", 10, 5),
    "sc1_tail": ("sumcheck_ops.cu", "spartan_tpu/protocol/fused.py:166", 14, 7),
    "sc2_tail": ("sumcheck_ops.cu", "spartan_tpu/protocol/fused.py:205", 6, 5),
    "blake2s_batch": ("sumcheck_ops.cu", "spartan_tpu/ops/blake2s.py:120", 2, 2),
}

# entry point -> (source file, JAX function replaced, tensor arguments, int arguments)
FUSED_KERNELS = {
    "g1_normalize": ("fp_ops.cu", "spartan_tpu/ops/curve.py:270", 2, 2),  # n, path
    "g2_normalize": ("fp_ops.cu", "spartan_tpu/ops/curve.py:270", 2, 2),
    "eq_tables": ("fr_ops.cu", "spartan_tpu/ops/mle.py:89", 2, 2),  # nv, tables
    "quot_level": ("fr_ops.cu", "spartan_tpu/commitment/scheme.py:175", 4, 2),  # nv, level
    "quot_tail": ("fr_ops.cu", "spartan_tpu/commitment/scheme.py:175", 4, 2),  # nv, level0
}

LAUNCHES: collections.Counter = collections.Counter()
DOUBLINGS: collections.Counter = collections.Counter()
LANES: collections.defaultdict = collections.defaultdict(collections.Counter)  # name -> {(n, *args): launches}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or the kernel library failed to compile or load."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point reported a CUDA error at launch."""


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``. The entry points that build on a
    device (setup, keygen, index) default to ``"cuda"``; a CUDA device on a
    machine without one raises here, before any work, instead of carrying on
    on the CPU. The CPU is taken only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


_lib = None
build_seconds = None  # wall time of the build this process ran (None: none ran)


def reset_counts() -> None:
    LAUNCHES.clear()
    DOUBLINGS.clear()
    LANES.clear()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the Hopper kernels cannot be built on this machine"
        )
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _build(nvcc: str, digest: str) -> Path:
    """Compile each .cu to an object in parallel, then link the library."""
    global build_seconds
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in srcs:
        obj = BUILD / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} ==\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    (BUILD / "build.log").write_text(log)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
    tmp = BUILD / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    so = BUILD / LIB_NAME
    os.replace(tmp, so)
    (BUILD / (LIB_NAME + ".sha256")).write_text(digest)
    build_seconds = time.perf_counter() - t0
    return so


def load():
    """Return the loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    nvcc = _find_nvcc()
    digest = _source_hash()
    so = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha256")
    if not so.exists() or not stamp.exists() or stamp.read_text() != digest:
        so = _build(nvcc, digest)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelBuildError(f"cannot load {so}: {e}") from e
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {name: (n_in, INT_ARGS.get(name, 0)) for name, (n_in, _s, _r) in KERNELS.items()}
    for name, (n_in, n_int) in {**sigs, **YARDSTICKS}.items():
        fn = getattr(lib, "spk_" + name)
        fn.argtypes = [vp] * (n_in + 1) + [i64] + [i32] * n_int + [vp]
        fn.restype = ctypes.c_int
    for name, (_src, _rep, n_t, n_int) in {**PHASE_KERNELS, **FUSED_KERNELS}.items():
        fn = getattr(lib, "spk_" + name)
        fn.argtypes = [vp] * n_t + [i64] * n_int + [vp]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_log() -> str:
    p = BUILD / "build.log"
    return p.read_text() if p.exists() else ""


def launch(name: str, out: torch.Tensor, *ins: torch.Tensor, args=()) -> torch.Tensor:
    """Launch kernel ``name`` on CUDA tensors: inputs and output share one
    shape (limb-major, lanes last), dtype int32, one device, contiguous.
    ``args`` are the entry point's int arguments after the lane count."""
    if len(ins) != KERNELS[name][0] or len(args) != INT_ARGS.get(name, 0):
        raise ValueError(f"{name}: expected {KERNELS[name][0]} inputs and "
                         f"{INT_ARGS.get(name, 0)} int arguments")
    for t in (out, *ins):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs CUDA")
        if t.device != out.device:
            raise ValueError(f"{name}: tensors on {t.device} and {out.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel needs torch.int32 limbs")
        if t.shape != out.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(out.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor")
    n = out.shape[-1]
    if n == 0:
        return out
    fn = getattr(load(), "spk_" + name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in ins], out.data_ptr(), n, *args, stream)
    if rc != 0:
        raise KernelLaunchError(f"{name}: cudaGetLastError() = {rc} at launch (n={n})")
    LAUNCHES[name] += 1
    LANES[name][(n, *args)] += 1
    if name.endswith("_double"):
        DOUBLINGS[name] += args[0]
    return out


def call(name: str, tensors, ints, key) -> None:
    """Launch ``PHASE_KERNELS`` or ``FUSED_KERNELS`` entry ``name`` on int32
    CUDA tensors, all on one device and contiguous, with its int arguments.
    ``key`` is the launch's entry in ``LANES`` (its width)."""
    _src, _rep, n_t, n_int = PHASE_KERNELS.get(name) or FUSED_KERNELS[name]
    if len(tensors) != n_t or len(ints) != n_int:
        raise ValueError(f"{name}: expected {n_t} tensors and {n_int} int arguments")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel needs torch.int32 words")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor")
    fn = getattr(load(), "spk_" + name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *[int(i) for i in ints], stream)
    if rc != 0:
        raise KernelLaunchError(f"{name}: cudaGetLastError() = {rc} at launch ({key})")
    LAUNCHES[name] += 1
    LANES[name][tuple(key)] += 1
