"""Time the truncated-SVD rungs of ops/svd.py on the card.

    python -m asvd4llm_tpu_torch.tools.svd_rungs [--repeats 3] [--out FILE]

For the Llama-2-7B leaf shapes the sensitivity scan factorizes (4096x4096,
11008x4096, 4096x11008 and the 32000x4096 head), f32, each rung in turns
(exact ``torch.linalg.svd``, randomized subspace iteration, the Gram path,
the scan's blocked low-memory Gram), the median of ``--repeats`` device
times (CUDA events) and the peak memory each call allocates above its
input, in multiples of the input's f32 bytes. The matrix is a random
weight times an activation-like column scale, as the act-aware scan sees
it. Each rung's relative reconstruction error ||W - U S Vh||_F / ||W||_F
at every rank is printed beside the exact rung's. Writes the rows as JSON
to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# (leaf, out, in, ranks): the weight grid's 0.4 and 0.9 ranks at rank_align
# 1, the 0.9 rank at rank_align 128 (the scan's max rank in the smoke), and
# the head at ratio 0.9
SHAPES = [
    ("q_proj", 4096, 4096, (819, 1843, 1920)),
    ("gate_proj", 11008, 4096, (1194, 2686, 2688)),
    ("down_proj", 4096, 11008, (1194, 2686, 2688)),
    ("lm_head", 32000, 4096, (3268,)),
]


def _matrix(torch, m, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn((m, n), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    scale = (torch.randn((n,), generator=g, device="cuda").abs() + 0.2) ** 0.5
    return w, scale


def _rungs(torch, svd):
    def exact(w32, w, scale, rank):
        u, s, vh = torch.linalg.svd(w32, full_matrices=False)
        return u[:, :rank], s[:rank], vh[:rank, :]

    def randomized(w32, w, scale, rank):
        return svd.truncated_svd(w32, rank, backend="randomized",
                                 generator=torch.Generator(device="cuda").manual_seed(0))

    def gram(w32, w, scale, rank):
        u, s, vh = svd._gram_svd_full(w32)
        return u[:, :rank], s[:rank], vh[:rank, :]

    def gram_lowmem(w32, w, scale, rank):
        return svd.gram_truncated_svd_lowmem(w, scale, rank)

    return {"exact": exact, "randomized": randomized, "gram": gram,
            "gram_lowmem": gram_lowmem}


def _rank_independent(rung):
    # exact and Gram factor at full rank and slice; lowmem's back-multiply
    # is a small share; randomized's subspace follows the rank
    return rung != "randomized"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("svd_rungs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from asvd4llm_tpu_torch.ops import svd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rungs = _rungs(torch, svd)
    # first calls set up cuSOLVER and cuBLAS handles
    w, scale = _matrix(torch, 256, 128, 0)
    for fn in rungs.values():
        fn(w.float() * scale[None, :], w, scale, 64)
    torch.cuda.synchronize()

    rows = []
    for si, (leaf, m, n, ranks) in enumerate(SHAPES):
        w, scale = _matrix(torch, m, n, 1 + si)
        w32 = w.float() * scale[None, :]
        norm = float(torch.linalg.norm(w32))
        times: dict = {}
        peaks: dict = {}
        errs: dict = {}
        for rep in range(args.repeats):
            for rung, fn in rungs.items():
                for rank in ranks:
                    if rank != ranks[-1] and _rank_independent(rung):
                        continue   # timed once per shape, at the largest rank
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    s_ev = torch.cuda.Event(enable_timing=True)
                    e_ev = torch.cuda.Event(enable_timing=True)
                    s_ev.record()
                    u, s, vh = fn(w32, w, scale, rank)
                    e_ev.record()
                    torch.cuda.synchronize()
                    key = (rung, rank)
                    times.setdefault(key, []).append(s_ev.elapsed_time(e_ev))
                    peaks[key] = (torch.cuda.max_memory_allocated() - base) / (4 * m * n)
                    if rep == 0:
                        # the SCALED matrix's factors throughout
                        for r in ranks:
                            if r == rank or (r < rank and _rank_independent(rung)):
                                rec = (u[:, :r] * s[:r][None, :]) @ vh[:r, :]
                                errs[(rung, r)] = float(torch.linalg.norm(w32 - rec)) / norm
                    del u, s, vh
        for (rung, rank), ts in sorted(times.items()):
            row = {"leaf": leaf, "shape": [m, n], "rung": rung, "rank": rank,
                   "ms_median": float(np.median(ts)), "ms": ts,
                   "peak_x_input_f32": peaks[(rung, rank)],
                   "rel_err": {str(r): errs[(rung, r)] for r in ranks
                               if (rung, r) in errs},
                   "rel_err_exact": {str(r): errs[("exact", r)] for r in ranks}}
            rows.append(row)
            print(f"{leaf} {m}x{n} {rung:12s} rank {rank:5d}: median "
                  f"{row['ms_median']:10.1f} ms of {['%.1f' % t for t in ts]}, peak "
                  f"{row['peak_x_input_f32']:.2f}x the f32 input; rel err "
                  + ", ".join(f"r{r} {errs[(rung, r)]:.6e} (exact {errs[('exact', r)]:.6e})"
                              for r in ranks if (rung, r) in errs), flush=True)
        del w, scale, w32
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi.stdout.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
