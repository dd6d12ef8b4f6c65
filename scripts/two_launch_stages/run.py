"""The cycle split of the two-launch sumcheck kernels on the card, by stage.

A one-off measurement of the design that the one-launch round replaced (a
round kernel and a transcript kernel a round, commit 6f01809); nothing else
uses it.

    git archive 6f01809 spartan_tpu_torch/csrc | tar -x -C _archive_parent
    python3 scripts/two_launch_stages/run.py _archive_parent/spartan_tpu_torch/csrc

Builds stages.cu (beside this file) with nvcc against the given csrc/ of that
commit and prints, from clock64() stamps of thread 0 of block 0: K6's loads,
fold, evaluation products, warp sums, block sum and partial store at one
pair (folding), 128 pairs and 2^15 pairs (no fold); K5 fs_sc1_emit's sum of
partials, evaluations, each Blake2s compression, the sampler and the new
pre at 1 and 256 partials (19 evaluations, a 2^16 round's); the device time
of the stamped K6 (a CUDA graph of 20); and the cycles a compression takes
in a chain of 1,000 on one thread, with that commit's rotates and with PRMT and
funnel shifts. Needs one card and nvcc; writes the SASS instruction counts
of each kernel.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
CUDA = os.environ.get("CUDA_HOME", "/usr/local/cuda")


def build(csrc: str, out: str) -> ctypes.CDLL:
    t0 = time.time()
    r = subprocess.run([f"{CUDA}/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{csrc}", "-o", out,
                        os.path.join(HERE, "stages.cu")], capture_output=True, text=True)
    print(f"build {r.returncode} in {time.time() - t0:.1f} s")
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip()[:160])
    if r.returncode:
        raise SystemExit(r.stderr[-3000:])
    return ctypes.CDLL(out)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    csrc = sys.argv[1]
    work = tempfile.mkdtemp()
    so = os.path.join(work, "stages.so")
    lib = build(csrc, so)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    st = torch.zeros(32, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def fr(n):
        vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        arr = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for v in vals] for i in range(8)], dtype=np.uint32)
        return torch.from_numpy(arr.view(np.int32)).to(dev).contiguous()

    def k6(pairs, fold):
        blocks = max(1, min(256, -(-pairs // 128)))
        w = (4 if fold else 2) * pairs
        tabs = [fr(w) for _ in range(3)]
        args = [t.data_ptr() for t in tabs + [fr(pairs), fr(1).reshape(8).contiguous()]
                + [torch.empty((8, 2 * pairs), dtype=torch.int32, device=dev) for _ in range(3)]
                + [torch.empty((3, blocks, 8), dtype=torch.int32, device=dev)]]
        call = lambda s: lib.pr_k6(*[vp(a) for a in args], i64(pairs), i64(int(fold)), i64(blocks),  # noqa: E731
                                   vp(st.data_ptr()), vp(s))
        res = []
        for _ in range(6):
            call(stream)
            torch.cuda.synchronize()
            res.append(np.diff(st.cpu().numpy()[:7]))
        d = np.median(np.array(res[1:]), axis=0)
        names = ["loads", "fold", "evaluation products", "warp sums", "block sum", "partial store"]
        print(f"K6 (two-launch) pairs={pairs} fold={int(fold)} blocks={blocks}: cycles "
              + ", ".join(f"{n} {int(x)}" for n, x in zip(names, d)) + f"; total {int(d.sum())}")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            s = torch.cuda.current_stream().cuda_stream
            for _ in range(20):
                call(s)
        graph.replay()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        print(f"K6 (two-launch, stamped) pairs={pairs}: device {e0.elapsed_time(e1) / 100 * 1000:.2f} us a launch")

    def k5(nblocks, d=19):
        part = fr(3 * nblocks).t().reshape(3, nblocks, 8).contiguous()
        tor, pre = fr(1).reshape(8).contiguous(), fr(1).reshape(8).contiguous()
        consts = fr(5 * d).t().reshape(5, d, 8).contiguous()
        state = torch.from_numpy(rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
                                 .view(np.int32)).to(dev)
        outs = [torch.zeros((d, 8), dtype=torch.int32, device=dev)] + [torch.zeros(8, dtype=torch.int32,
                                                                                 device=dev) for _ in range(2)]
        res = []
        for _ in range(6):
            ts = [part, tor, consts, pre.clone(), state.clone(), *outs]
            lib.pr_k5(*[vp(t.data_ptr()) for t in ts], i64(nblocks), i64(d), vp(st.data_ptr()), vp(stream))
            torch.cuda.synchronize()
            a = st.cpu().numpy()
            res.append(np.diff(a[: int(a[30])]))
        c = np.median(np.array(res[1:]), axis=0)
        print(f"K5 (two-launch) fs_sc1_emit partials={nblocks} D={d}: cycles sum of partials {int(c[0])}, evaluations "
              f"{int(c[1])}, compressions {[int(x) for x in c[2:-2]]}, sampler {int(c[-2])}, to_mont and pre "
              f"{int(c[-1])}; total {int(c.sum())}")

    for pairs, fold in ((1, True), (128, True), (1 << 15, False)):
        k6(pairs, fold)
    for nb in (1, 256):
        k5(nb)
    msg = torch.from_numpy(rng.integers(0, 1 << 32, size=16, dtype=np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev)
    digests = []
    for v, label in ((0, "shift-and-or rotates"), (1, "PRMT and funnel-shift rotates")):
        out = torch.zeros(8, dtype=torch.int32, device=dev)
        for _ in range(2):
            lib.pr_chain(v, vp(msg.data_ptr()), vp(out.data_ptr()), i64(1000), vp(st.data_ptr()), vp(stream))
            torch.cuda.synchronize()
        print(f"Blake2s, a chain of 1000 compressions on one thread, {label}: {st[0].item() / 1000:.1f} cycles each")
        digests.append(out.clone())
    print("both forms give the same digests:", torch.equal(digests[0], digests[1]))
    sass = subprocess.run([f"{CUDA}/bin/cuobjdump", "-sass", so], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w\s+)?([A-Z][A-Z0-9_.]*)", f)
        cnt = {}
        for o in ops:
            cnt[o.split(".")[0]] = cnt.get(o.split(".")[0], 0) + 1
        top = sorted(cnt.items(), key=lambda kv: -kv[1])[:10]
        print(f"SASS {name[:60]}: {len(ops)} instructions; " + ", ".join(f"{k} {n}" for k, n in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
