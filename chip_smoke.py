#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (asvd4llm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as the chip check runs it
    python3 chip_smoke.py --phases kernels

Phases:
  kernels  build the CUDA kernels from csrc/, hold each against its plain
           PyTorch version at Llama-2-7B shapes (bf16 and f32), and time the
           kernel, the plain version, a PyTorch yardstick and the bound;
  main     write a random checkpoint at Llama-2-7B widths (depth cut to 2
           layers); run the port's CLI with a parameter-ratio target, then
           greedy-decode the compressed model with use_pallas=True over
           dense caches; run the CLI with a KV-cache target on the same
           checkpoint, then greedy-decode over the realized latent cache;
           run the CLI with the weight target again with int8 and with int4
           deployed factors, each followed by greedy decode, with the
           KV-cache target and int8 factors at the CLI's default rank_align
           (ranks padded to multiples of 16 at run time), followed by greedy
           decode, once with AWQ int4 fake-quant (PPL only), and once
           with the weight target scaled by Fisher information and abs-mean
           statistics (--scaling_method fisher_abs_mean: the calib_fisher
           phase's seconds, vector count and peak device memory), followed
           by greedy decode. Every
           decode runs generate_on_device (one captured CUDA graph replayed
           per token, the served path) and generate (eager steps) in turns,
           which must emit the same tokens; the decode step is timed both
           ways on the host clock and traced for device busy and idle
           share, with the graph's capture time. Each run's kernel launches
           are counted from 0 (a replay counts the launches its capture
           made); the kernel each run exists for must be > 0. Then one
           Fisher calibration batch (1 x 256 tokens) of Llama-2-7B at its
           full 32 layers, random bf16 weights built on the card, whose
           peak device memory must stay below 1.25x the weights' bytes;
  export   the weight-target, KV-target, int8 and int4 models of the main
           phase through save_compressed (native checkpoint) and
           export_hf_repo (HF repo, f32), read back onto the card by
           load_compressed and load_model: every tensor equal to the
           model's (bit for bit; the repo after the cast back to bf16), and
           greedy decode of each reloaded model through generate_on_device
           with the model's tokens and its kernel launched; bytes on disk
           and seconds to write and read each artifact. Then the builder
           (export.build_repo.main, --calib_dataset synthetic) once end to
           end on the smoke checkpoint, with its repo and native checkpoint
           read back and decoded. Needs the main phase;
  serve    the paged continuous-batching engine (PagedEngine, use_pallas,
           bf16 pools, automatic page size) on the weight-target and
           KV-target models of the main phase: dense pools (kernel 5),
           latent="v" (kernel 5, V-latent) with chunked prefill and the
           prefix cache, latent="kv" (kernel 6) with multi-step decode, and
           latent="auto"; 8 requests of 64-1024 prompt tokens each, through
           the engine's captured decode graphs and with eager steps
           (eager_steps=True), in turns, with the same tokens. Needs the
           main phase;
  fulldepth  Llama-2-7B at its published 32 layers and widths, random bf16
           weights built on the card: pipeline.compress with the
           prefix-cached suffix scan and a scan_resume_path (the scan's SVD
           and evaluation seconds by leaf shape, the SVD backend each shape
           resolved to, peak memory against the weights' bytes, the
           host-eigh rung's count, which must be 0), pipeline.evaluate
           (windowed PPL, kernel 1 at M = 1024) and greedy decode through
           generate_on_device and eagerly, in turns, with identical tokens;
           then six leaves' grids timed with the suffix and the serial
           evaluator in turns (PPLs within rtol 1e-3), and a 2-layer scan
           resumed from half its JSONL (the same sensitivity and manifest).

Exits non-zero without a CUDA device, and when any phase fails. The last
line of standard output is the device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
L2_FLUSH_BYTES = 128 << 20                     # > the 50 MB L2

# Llama-2-7B (meta-llama/Llama-2-7b-hf config.json); depth is cut below
LLAMA2_7B = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 11008,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "num_hidden_layers": 32, "vocab_size": 32000,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
SMOKE_LAYERS = 2
KERNEL1_SHAPES = [  # (name, N, K, R): Llama-2-7B linears at ratio 0.9, rank_align 128
    ("q_proj", 4096, 4096, 1920), ("k_proj", 4096, 4096, 1920),
    ("v_proj", 4096, 4096, 1920), ("o_proj", 4096, 4096, 1920),
    ("gate_proj", 11008, 4096, 2688), ("up_proj", 11008, 4096, 2688),
    ("down_proj", 4096, 11008, 2688),
]
# Llama-2-7B k/v projections at the ranks of the KV-target run (ratio 0.5,
# rank_align 1): not multiples of 8, so a call with them as they are takes
# the WMMA form; align_ranks pads them for the wgmma form
KERNEL1_KV_SHAPES = [("k_proj", 4096, 4096, 819), ("v_proj", 4096, 4096, 409)]
DECODE_BATCH, PROMPT_LEN, NEW_TOKENS = 4, 128, 32
KERNEL1_M = (1, DECODE_BATCH, 16, 64, 256, 1024)   # checked, bf16 and f32
KERNEL1_TIMED_M = (DECODE_BATCH, 64, 256, 1024)     # timed, bf16
# calibration rows and window length of the two CLI runs (the PPL scan
# evaluates every leaf at 6 weight ratios and 19 KV ratios on these rows)
MAIN_SIZES = {"n_calib_samples": 8, "seqlen": 256}


def log(msg):
    print(msg, flush=True)


class Timer:
    """Device time of a callable: the sum of the GPU activities (kernels,
    memsets, copies) that torch.profiler's CUPTI trace records for it, the
    median over the timed calls (one slow call, such as the first after a
    clock change, does not move it), with the L2 flushed before every call
    (a decode step finds each layer's weights cold). The flush reads 128 MB and writes nothing large,
    so it leaves the L2 holding clean lines, as the previous layer's weights
    would: a flush that wrote would make every timed call pay for writing
    its lines back. One stream runs everything, so the trace in start order
    is flush, call, flush, call...; the flush's own activities are dropped
    by position. Where the trace holds no device activity, CUDA events
    around each call give the time instead, and `method` says which."""

    def __init__(self, torch):
        self.torch = torch
        buf = torch.ones(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        self.flush = buf.max
        self.method = None

    def _trace(self, run, names=False):
        """The GPU activities of `run` in start order: their us, or (name,
        us) pairs."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            self.torch.cuda.synchronize()
        acts = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                      for e in prof.events() if e.device_type == DeviceType.CUDA)
        return [(name, us) if names else us for _, name, us in acts]

    def ms(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            self.flush()
            fn()
        torch.cuda.synchronize()
        n_flush = len(self._trace(self.flush))

        def run():
            for _ in range(iters):
                self.flush()
                fn()
        acts = self._trace(run)
        per_call = len(acts) // iters
        if acts and per_call > n_flush and len(acts) == per_call * iters:
            self.method = "device time from the profiler trace, median of calls"
            return float(np.median([sum(acts[c * per_call + n_flush:(c + 1) * per_call])
                                    for c in range(iters)])) / 1e3
        self.method = "CUDA events around each call, median of calls"
        times = []
        for _ in range(iters):
            self.flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


    def by_activity(self, fn, iters=5):
        """Device us per call of each GPU activity of `fn` by kernel name,
        for flushed calls (the flush's activities dropped by position, as
        in `ms`)."""
        n_flush = len(self._trace(self.flush, names=True))

        def run():
            for _ in range(iters):
                self.flush()
                fn()
        acts = self._trace(run, names=True)
        per_call = len(acts) // iters
        out: dict = {}
        for i, (name, us) in enumerate(acts):
            if i % per_call >= n_flush:
                short = name.replace("(anonymous namespace)::", "").replace("void ", "")
                short = short.split("(")[0].strip() or name[:40]
                out[short] = out.get(short, 0.0) + us / iters
        return out


# the tensor-core and TMA forms of kernels 1-6 (a longer name first where one
# contains another)
NEW_FORM_KERNELS = ("gemm_nt_i8", "gemm_nt_q4", "gemm_nt", "paged_latent_split_kernel",
                    "latent_split_kernel", "paged_dense_split_kernel")


def new_form_ptxas(build_logs):
    """(library, kernel, register line, spill line) of each kernel of the
    wgmma forms in the nvcc -Xptxas -v output."""
    rows = []
    for name, out in build_logs.items():
        kernel = None
        for ln in out.splitlines():
            if "Compiling entry function" in ln:
                mangled = ln.split("'")[1] if "'" in ln else ln
                kernel = next((k for k in NEW_FORM_KERNELS if k in mangled), None)
                if kernel:
                    # integer and bool template arguments as mangled:
                    # ILi2ELi128E... -> <2, 128>, ILi128ELb1E -> <128, 1>
                    args = mangled.split(kernel, 1)[1].split("Ev")[0]
                    kernel += "<" + ", ".join(re.findall(r"L[ib](\d+)E", args)) + ">"
                spill = None
            elif kernel and "spill" in ln:
                spill = ln.strip()
            elif kernel and "registers" in ln:
                rows.append((name, kernel, ln.split(":", 1)[-1].strip(), spill))
                kernel = None
    return rows


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(out, ref):
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d / (ref.float().abs() + 1e-6)).median())


def within(out, ref, atol, rtol):
    return bool(((out.float() - ref.float()).abs()
                 <= atol + rtol * ref.float().abs()).all())


def old_form_in_turns(torch, timer, new, old, name, ref, k_ms, atol, rtol, failures, label):
    """An earlier form `old` (named `name`) on the inputs of the form `new`:
    held against the plain version's `ref`, then timed in turns with the new
    form (new, old, old, new; the first new time `k_ms` given). -> (new ms,
    old ms, text for the log line)."""
    out = old()
    torch.cuda.synchronize()
    o_err = max_err(out, ref)[0]
    o_ok = within(out, ref, atol, rtol) and bool(torch.isfinite(out.float()).all())
    if not o_ok:
        failures.append(label)
    o_ms, o2_ms, k2_ms = timer.ms(old), timer.ms(old), timer.ms(new)
    text = (f"; form {name} max_abs_err={o_err:.3e} {'ok' if o_ok else 'FAIL'}, in turns"
            f" new/old/old/new {k_ms * 1e3:.1f}/{o_ms * 1e3:.1f}/{o2_ms * 1e3:.1f}/"
            f"{k2_ms * 1e3:.1f} us")
    return (k_ms + k2_ms) / 2, (o_ms + o2_ms) / 2, text


# ------------------------------------------------------------------ kernels

def kernel1_unaligned_ranks(torch, timer, g, failures):
    """Kernel 1 at KERNEL1_KV_SHAPES, bf16: each rank as it is (the WMMA form
    above M=16) and zero-padded by pad_rank (the wgmma form), both held
    against the plain version; at M=1024 the two timed in turns beside two
    matmuls and the bound. -> their M=1024 sums for the kernels line."""
    from asvd4llm_tpu_torch.ops import fused_lowrank as fl
    from asvd4llm_tpu_torch.ops.lowrank import pad_rank

    atol = rtol = 2e-2
    keys = ("wmma_tiled_ms", "padded_wgmma_tiled_ms", "library_ms", "bound_ms")
    sums = dict.fromkeys(keys, 0.0)
    err_all = 0.0
    for M in (DECODE_BATCH, 1024):
        for name, N, K, R in KERNEL1_KV_SHAPES:
            x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
            b = (torch.randn(R, K, generator=g, device="cuda") * K ** -0.5).bfloat16()
            a = (torch.randn(N, R, generator=g, device="cuda") * R ** -0.5).bfloat16()
            bias = (torch.randn(N, generator=g, device="cuda") * 0.1).bfloat16()
            ref = fl.fused_lowrank_reference(x, a, b, bias)
            pad = pad_rank({"A": a, "B": b, "b": bias})
            runs = {"as is": lambda: fl.fused_lowrank_apply(x, a, b, bias),
                    "padded": lambda: fl.fused_lowrank_apply(x, pad["A"], pad["B"], bias)}
            line = f"  bfloat16 M={M:4d} {name:9s} N={N} K={K} R={R}"
            for label, fn in runs.items():
                out = fn()
                form = fl.fused_lowrank_apply.last_form
                torch.cuda.synchronize()
                err = max_err(out, ref)[0]
                ok = within(out, ref, atol, rtol)
                err_all = max(err_all, err)
                rank = R if label == "as is" else pad["A"].shape[1]
                line += (f"; rank {label} ({rank}) form={form} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"fused_lowrank M={M} {name} R={R} {label}")
            if M == 1024:
                new_ms, old_ms, old2_ms, new2_ms = (
                    timer.ms(runs[k]) for k in ("padded", "as is", "as is", "padded"))
                l_ms = timer.ms(lambda: torch.nn.functional.linear(
                    torch.matmul(x, b.t()), a, bias))
                bms, by = bound((R * K + N * R + M * K + M * N + N) * 2,
                                2 * M * R * (K + N), torch.bfloat16)
                line += (f" | padded, wgmma_tiled {(new_ms + new2_ms) / 2 * 1e3:.1f} us,"
                         f" as is, wmma_tiled {(old_ms + old2_ms) / 2 * 1e3:.1f} us (in turns"
                         f" {new_ms * 1e3:.1f}/{old_ms * 1e3:.1f}/{old2_ms * 1e3:.1f}/"
                         f"{new2_ms * 1e3:.1f} us), two matmuls {l_ms * 1e3:.1f} us, bound"
                         f" {bms * 1e3:.1f} us ({by})")
                for k_, v_ in zip(keys, ((old_ms + old2_ms) / 2, (new_ms + new2_ms) / 2,
                                         l_ms, bms)):
                    sums[k_] += v_
            log(line)
    log(f"  k_proj + v_proj at the KV-target ranks, M=1024 bf16: padded (wgmma_tiled) "
        f"{sums['padded_wgmma_tiled_ms'] * 1e3:.1f} us, as is (wmma_tiled) "
        f"{sums['wmma_tiled_ms'] * 1e3:.1f} us, two matmuls {sums['library_ms'] * 1e3:.1f}"
        f" us, bound {sums['bound_ms'] * 1e3:.1f} us")
    return dict(sums, max_abs_err=err_all,
                shape="k_proj R=819 + v_proj R=409 of Llama-2-7B, M=1024, bf16")


def phase_kernels(torch, timer, record):
    from asvd4llm_tpu_torch.ops import fused_lowrank as fl
    from asvd4llm_tpu_torch.ops import latent_attention as la

    g = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
    failures = []

    # kernel 1 ------------------------------------------------------------
    log("kernel fused_lowrank: y = (x·Bᵀ)·Aᵀ + bias vs fused_lowrank_reference")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops", "old_ms")
    sums = {M: dict.fromkeys(keys, 0.0) for M in KERNEL1_TIMED_M}
    err_at = {M: 0.0 for M in KERNEL1_TIMED_M}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
        for M in KERNEL1_M:
            for name, N, K, R in KERNEL1_SHAPES:
                x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
                b = (torch.randn(R, K, generator=g, device="cuda") * K ** -0.5).to(dtype)
                a = (torch.randn(N, R, generator=g, device="cuda") * R ** -0.5).to(dtype)
                bias = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dtype)
                out = fl.fused_lowrank_apply(x, a, b, bias)
                form = fl.fused_lowrank_apply.last_form
                ref = fl.fused_lowrank_reference(x, a, b, bias)
                torch.cuda.synchronize()
                err, med_rel = max_err(out, ref)
                ok = within(out, ref, atol, rtol)
                line = (f"  {str(dtype)[6:]:8s} M={M:4d} {name:9s} N={N} K={K} R={R}"
                        f" form={form} max_abs_err={err:.3e} median_rel={med_rel:.2e}"
                        f" tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
                if dtype == torch.bfloat16 and M in KERNEL1_TIMED_M:
                    isz = x.element_size()
                    nbytes = (R * K + N * R + M * K + M * N + N) * isz
                    flops = 2 * M * R * (K + N)
                    bms, by = bound(nbytes, flops, dtype)
                    k_ms = timer.ms(lambda: fl.fused_lowrank_apply(x, a, b, bias))
                    p_ms = timer.ms(lambda: fl.fused_lowrank_reference(x, a, b, bias))
                    l_ms = timer.ms(lambda: torch.nn.functional.linear(
                        torch.matmul(x, b.t()), a, bias))
                    line += (f" | kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us,"
                             f" two matmuls {l_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us"
                             f" ({by})")
                    o_ms = 0.0
                    if form == "wgmma_tiled":
                        # the split-K WMMA form on the same inputs, held against the
                        # plain version too, then the new one again: old and new
                        # compared in turns within this run
                        old = fl._launch(x, a, b, bias, form="wmma_tiled")
                        torch.cuda.synchronize()
                        o_err = max_err(old, ref)[0]
                        o_ok = within(old, ref, atol, rtol)
                        line += (f"; form wmma_tiled max_abs_err={o_err:.3e}"
                                 f" {'ok' if o_ok else 'FAIL'}")
                        if not o_ok:
                            failures.append(f"fused_lowrank wmma_tiled M={M} {name}")
                        o_ms = timer.ms(lambda: fl._launch(x, a, b, bias, form="wmma_tiled"))
                        k2_ms = timer.ms(lambda: fl.fused_lowrank_apply(x, a, b, bias))
                        line += (f"; form wmma_tiled {o_ms * 1e3:.1f} us, {form} again"
                                 f" {k2_ms * 1e3:.1f} us")
                        k_ms = (k_ms + k2_ms) / 2
                    for k_, v_ in zip(keys, (k_ms, p_ms, l_ms, bms, nbytes, flops, o_ms)):
                        sums[M][k_] += v_
                    err_at[M] = max(err_at[M], err)
                log(line)
                if not ok:
                    failures.append(f"fused_lowrank {dtype} M={M} {name}")
    log(f"  timing: {timer.method}")
    kv_ranks = kernel1_unaligned_ranks(torch, timer, g, failures)

    def k1_row(M):
        sm = sums[M]
        by = "bytes" if sm["bytes"] / HBM_BYTES_PER_S >= \
            sm["flops"] / PEAK_FLOPS["torch.bfloat16"] else "operations"
        log(f"  one Llama-2-7B layer's 7 linears at M={M} bf16: kernel "
            f"{sm['ms'] * 1e3:.1f} us, plain {sm['plain_ms'] * 1e3:.1f} us, two "
            f"matmuls {sm['library_ms'] * 1e3:.1f} us, bound {sm['bound_ms'] * 1e3:.1f}"
            f" us ({by}: {sm['bytes'] / 1e6:.1f} MB, {sm['flops'] / 1e9:.2f} GFLOP), "
            f"{100 * sm['bound_ms'] / sm['ms']:.1f}% of the bound"
            + (f"; form wmma_tiled {sm['old_ms'] * 1e3:.1f} us" if sm["old_ms"] else ""))
        return {"max_abs_err": err_at[M], "ms": sm["ms"], "plain_ms": sm["plain_ms"],
                "bound_ms": sm["bound_ms"], "bound_by": by, "library_ms": sm["library_ms"],
                "shape": f"7 linears of one Llama-2-7B layer, ratio 0.9, M={M}, bf16"}
    rows = {M: k1_row(M) for M in KERNEL1_TIMED_M}
    record["fused_lowrank"] = {
        "name": "fused_lowrank", "route": "cuda",
        "source": "asvd4llm_tpu_torch/csrc/fused_lowrank.cu",
        "replaces": "asvd4llm_tpu/ops/pallas_lowrank.py:118",
        **rows[DECODE_BATCH],
        "m1024": dict(rows[1024], form="wgmma_tiled", wmma_tiled_ms=sums[1024]["old_ms"]),
        "m1024_kv_target_ranks": kv_ranks,
    }

    # kernel 2 ------------------------------------------------------------
    log("kernel latent_attention: s = softmax(q·RoPE(tk·A_kᵀ))·tv vs "
        "latent_attention_reference")
    cases = [  # (label, B, H, KV, hd, T, Rk, Rv, pos, softcap, sliding)
        ("mha", 4, 32, 32, 128, 544, 1024, 1024, 543, 0.0, 0),
        ("mha_mid", 4, 32, 32, 128, 544, 1024, 1024, 300, 0.0, 0),
        ("gqa4", 4, 32, 8, 128, 544, 1024, 768, 543, 0.0, 0),
        ("sliding", 4, 32, 32, 128, 544, 1024, 1024, 500, 0.0, 128),
        ("softcap", 4, 32, 8, 128, 544, 1024, 1024, 543, 50.0, 0),
        ("mha_b1", 1, 32, 32, 128, 544, 1024, 1024, 543, 0.0, 0),
        ("mha_t2048", 4, 32, 32, 128, 2048, 1024, 1024, 2047, 0.0, 0),
        ("kv_target", 4, 32, 32, 128, 544, 819, 409, 543, 0.0, 0),   # ranks of the run
    ]
    timed = ("mha", "gqa4", "mha_b1", "mha_t2048", "kv_target")
    main = None
    extra = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
        for label, B, H, KV, hd, T, Rk, Rv, pos, cap, sw in cases:
            q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
            tk = (torch.randn(B, T, Rk, generator=g, device="cuda") * 0.5).to(dtype)
            tv = (torch.randn(B, T, Rv, generator=g, device="cuda") * 0.5).to(dtype)
            a_k = (torch.randn(KV * hd, Rk, generator=g, device="cuda")
                   * Rk ** -0.5).to(dtype)
            inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device="cuda",
                                                  dtype=torch.float32) / hd))
            fr = torch.arange(T, device="cuda", dtype=torch.float32)[:, None] * inv
            emb = torch.cat([fr, fr], dim=-1)
            cos, sin = emb.cos().contiguous(), emb.sin().contiguous()
            kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
            # the position as the decode graph gives it: one int32 on the card
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            out = la._latent_attention_core(q, tk, tv, a_k, cos, sin, pos_t, **kw)
            form = la.latent_decode_attention.last_form
            ref = la.latent_attention_reference(q, tk, tv, a_k, cos, sin, pos, **kw)
            torch.cuda.synchronize()
            err, med_rel = max_err(out, ref)
            ok = within(out, ref, atol, rtol)
            line = (f"  {str(dtype)[6:]:8s} {label:9s} B={B} H={H} KV={KV} hd={hd} T={T}"
                    f" Rk={Rk} Rv={Rv} pos={pos} form={form} max_abs_err={err:.3e}"
                    f" median_rel={med_rel:.2e} tol=atol {atol:g} + rtol {rtol:g}"
                    f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"latent_attention {dtype} {label}")
            if dtype == torch.bfloat16 and label in timed:
                live = pos + 1 if sw <= 0 else min(pos + 1, sw)
                isz = tk.element_size()
                nbytes = (B * live * (Rk + Rv) + KV * hd * Rk + B * H * hd) * isz \
                    + B * H * Rv * 4 + 2 * live * hd * 4
                flops = 2 * B * live * (Rk * KV * hd + H * hd + H * Rv)
                bms, by = bound(nbytes, flops, dtype)
                # the split form on the caches and A_k zero-padded to ranks that are
                # multiples of 8 (what align_ranks gives; the same inputs where they
                # are already), and the tile32 form on the caches as they are: both
                # held against the plain version, then timed in turns
                pk, pv, pa = (torch.nn.functional.pad(t, (0, -t.shape[-1] % 8))
                              for t in (tk, tv, a_k))

                def new():
                    return la._latent_attention_core(q, pk, pv, pa, cos, sin, pos_t,
                                                     form="split_wgmma", **kw)

                def old():
                    return la._latent_attention_core(q, tk, tv, a_k, cos, sin, pos_t,
                                                     form="tile32", **kw)
                for fname, fn in (("split_wgmma", new), ("tile32", old)):
                    got = fn()
                    torch.cuda.synchronize()
                    f_err = max_err(got[..., :Rv], ref)[0]
                    f_ok = within(got[..., :Rv], ref, atol, rtol) and \
                        not bool(got[..., Rv:].any())
                    line += f"; form {fname} max_abs_err={f_err:.3e} {'ok' if f_ok else 'FAIL'}"
                    if not f_ok:
                        failures.append(f"latent_attention {fname} {label}")
                k_ms, o_ms, o2_ms, k2_ms = (timer.ms(fn) for fn in (new, old, old, new))
                p_ms = timer.ms(lambda: la.latent_attention_reference(
                    q, tk, tv, a_k, cos, sin, pos, **kw))
                l_ms = timer.ms(lambda: _sdpa_latent(torch, q, tk, tv, a_k, cos, sin,
                                                     KV, hd))
                turns = f"{k_ms * 1e3:.1f}/{o_ms * 1e3:.1f}/{o2_ms * 1e3:.1f}/{k2_ms * 1e3:.1f}"
                k_ms, o_ms = (k_ms + k2_ms) / 2, (o_ms + o2_ms) / 2
                line += (f" | form split_wgmma{' (ranks padded)' if Rk % 8 or Rv % 8 else ''}"
                         f", position on the card, all {-(-T // la.SPLIT_KEYS)} chunks"
                         f" launched: {k_ms * 1e3:.1f} us (in turns new/old/old/new {turns}"
                         f" us), form tile32 {o_ms * 1e3:.1f} us, plain"
                         f" {p_ms * 1e3:.1f} us, unfused+SDPA {l_ms * 1e3:.1f} us, bound"
                         f" {bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB,"
                         f" {flops / 1e9:.2f} GFLOP), {100 * bms / k_ms:.1f}% of the bound")
                if label != "kv_target":
                    acts = timer.by_activity(new)
                    line += "; device us by launch: " + ", ".join(
                        f"{n} {us:.1f}" for n, us in acts.items())
                row = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": l_ms, "tile32_ms": o_ms}
                if label == "mha":
                    main = row
                else:
                    extra[label] = dict(row, shape=f"B={B} H={H} KV={KV} hd={hd} T={T} "
                                        f"Rk={Rk} Rv={Rv} pos={pos} bf16")
            log(line)
    log(f"  kernel 2 at B=4 H=KV=32 hd=128 T=544 Rk=Rv=1024 pos=543: {main['ms'] * 1e3:.1f}"
        f" us with the position read on the card and all 5 chunks launched")
    record["latent_attention"] = {
        "name": "latent_attention", "route": "cuda",
        "source": "asvd4llm_tpu_torch/csrc/latent_attention.cu",
        "replaces": "asvd4llm_tpu/ops/pallas_latent_attention.py:284",
        **main,
        "shape": "B=4 H=KV=32 hd=128 T=544 Rk=Rv=1024 pos=543 (int32 on the card) bf16, "
                 "form split_wgmma",
        **extra,
    }
    phase_quant_kernels(torch, timer, record, failures)
    phase_paged_kernels(torch, timer, record, failures)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")


Q4_GROUP = 128


def quantize_factors(torch, kind, a, b):
    """The q8 or q4 deployment form of one low-rank leaf's factors, as
    ops/quant_apply.py makes it (q4 without the AWQ fold)."""
    from asvd4llm_tpu_torch.ops.quant import quantize_to_int, quantize_to_int4_grouped
    if kind == "q8":
        a8, aq = quantize_to_int(a, 8)
        b8, bq = quantize_to_int(b, 8)
        return a8, aq, b8, bq
    a4, asc, azs = quantize_to_int4_grouped(a, group=Q4_GROUP)
    b4, bsc, bzs = quantize_to_int4_grouped(b, group=Q4_GROUP)
    pad = a4.shape[1] * 2 - b4.shape[0]
    b4, bsc, bzs = (torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in (b4, bsc, bzs))
    return a4, asc, azs, b4, bsc, bzs


def q_apply(kind, x, q, bias, **kw):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    if kind == "q8":
        return fq.fused_lowrank_apply_q8(x, q[0], q[1], q[2], q[3], bias, **kw)
    return fq.fused_lowrank_apply_q4(x, *q, bias, group=Q4_GROUP, **kw)


def q_launch(kind, x, q, bias, form):
    """Kernel 3 or 4 in a named form (measurements only)."""
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    if kind == "q8":
        return fq._launch_q8(x, q[0], q[1].scale, q[1].zero, q[2], q[3].scale, q[3].zero,
                             bias, form=form)
    return fq._launch_q4(x, *q, bias, Q4_GROUP, form=form)


def q_reference(kind, x, q, bias):
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    if kind == "q8":
        a8, aq, b8, bq = q
        return fq.fused_lowrank_q8_reference(x, a8, aq.scale, aq.zero, b8, bq.scale,
                                             bq.zero, bias)
    return fq.fused_lowrank_q4_reference(x, *q, bias, group=Q4_GROUP)


def q_bytes(kind, q, M, N, K, isz):
    """Bytes the quantized linear must move: codes, f32 scales and zeros,
    x, y and the bias, each once."""
    io = (M * K + M * N + N) * isz
    if kind == "q8":
        a8, _, b8, _ = q
        return a8.numel() + b8.numel() + 8 * (a8.shape[0] + b8.shape[0]) + io
    return sum(v.numel() * v.element_size() for v in q) + io


def phase_quant_kernels(torch, timer, record, failures):
    """Kernels 3 and 4 at the shapes of kernel 1 (the 7 linears of a
    Llama-2-7B layer at ratio 0.9, factors quantized by the port): each
    against its plain version; in bf16, its time beside its bound, its
    plain version, the dequantize + two matmuls yardstick (what the JAX
    package runs above 1024 tokens) and kernel 1 on the same factors
    dequantized to bf16."""
    from asvd4llm_tpu_torch.ops import fused_lowrank as fl
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq

    g = torch.Generator(device="cuda").manual_seed(3)
    tol = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
    for kind, name, tpu_line, what in (
            ("q8", "fused_lowrank_q8", "asvd4llm_tpu/ops/pallas_lowrank.py:217",
             "int8 codes, per-row scale and zero"),
            ("q4", "fused_lowrank_q4", "asvd4llm_tpu/ops/pallas_lowrank.py:371",
             f"packed 4-bit codes, group {Q4_GROUP}, R and K padded to 512")):
        log(f"kernel {name}: y = (x·dq(B)ᵀ)·dq(A)ᵀ + bias ({what}) vs its plain version")
        keys = ("ms", "plain_ms", "yardstick_ms", "kernel1_ms", "bound_ms", "bytes", "flops",
                "old_ms")
        sums = {M: dict.fromkeys(keys, 0.0) for M in (DECODE_BATCH, 1024)}
        err_at = {M: 0.0 for M in (DECODE_BATCH, 1024)}
        counter = _counted()[name]
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol = tol[dtype]
            shapes = KERNEL1_SHAPES if dtype == torch.bfloat16 else KERNEL1_SHAPES[:1]
            for M in (1, DECODE_BATCH, 16, 1024):
                for lin, N, K, R in shapes:
                    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
                    a = torch.randn(N, R, generator=g, device="cuda") * R ** -0.5
                    b = torch.randn(R, K, generator=g, device="cuda") * K ** -0.5
                    bias = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dtype)
                    q = quantize_factors(torch, kind, a.to(dtype), b.to(dtype))
                    out = q_apply(kind, x, q, bias)
                    form = getattr(counter, "last_form", None)
                    ref = q_reference(kind, x, q, bias)
                    torch.cuda.synchronize()
                    err, med_rel = max_err(out, ref)
                    ok = within(out, ref, atol, rtol)
                    line = (f"  {str(dtype)[6:]:8s} M={M:4d} {lin:9s} N={N} K={K} R={R}"
                            + (f" form={form}" if form else "")
                            + f" max_abs_err={err:.3e} median_rel={med_rel:.2e}"
                            f" tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"{name} {dtype} M={M} {lin}")
                    if dtype == torch.bfloat16:
                        # operations at the true rank R: the q4 codes' padding to 512
                        # adds zero rows that the function does not need
                        nbytes = q_bytes(kind, q, M, N, K, x.element_size())
                        flops = 2 * M * R * (K + N)
                        bms, by = bound(nbytes, flops, dtype)
                        a_dq, b_dq = (v.to(dtype) for v in _dequantized(kind, q, K))
                        k_ms = timer.ms(lambda: q_apply(kind, x, q, bias))
                        p_ms = timer.ms(lambda: q_reference(kind, x, q, bias))
                        y_ms = timer.ms(lambda: q_apply(kind, x, q, bias, max_tokens=0))
                        k1_ms = timer.ms(lambda: fl.fused_lowrank_apply(x, a_dq, b_dq, bias))
                        line += (f" | kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us,"
                                 f" dequant+two matmuls {y_ms * 1e3:.1f} us, kernel 1 on bf16"
                                 f" factors {k1_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us"
                                 f" ({by}: {nbytes / 1e6:.1f} MB)")
                        o_ms = 0.0
                        if form == "wgmma_tiled":
                            # the earlier WMMA form on the same inputs, held against the
                            # plain version, then timed in turns with the new one
                            k_ms, o_ms, text = old_form_in_turns(
                                torch, timer, lambda: q_apply(kind, x, q, bias),
                                lambda: q_launch(kind, x, q, bias, "wmma_tiled"), "wmma_tiled",
                                ref, k_ms, atol, rtol, failures, f"{name} wmma_tiled M={M} {lin}")
                            line += text
                        if M == DECODE_BATCH and lin == "q_proj":
                            for label, fn in ((name, lambda: q_apply(kind, x, q, bias)),
                                              ("fused_lowrank", lambda: fl.fused_lowrank_apply(
                                                  x, a_dq, b_dq, bias))):
                                acts = timer.by_activity(fn)
                                log(f"  {label} at q_proj M={M}, device us per call by launch: "
                                    + ", ".join(f"{n} {us:.1f}" for n, us in acts.items()))
                        if M in sums:
                            for k_, v_ in zip(keys, (k_ms, p_ms, y_ms, k1_ms, bms, nbytes,
                                                     flops, o_ms)):
                                sums[M][k_] += v_
                            err_at[M] = max(err_at[M], err)
                    log(line)

        def q_row(M):
            sm = sums[M]
            by = "bytes" if sm["bytes"] / HBM_BYTES_PER_S >= \
                sm["flops"] / PEAK_FLOPS["torch.bfloat16"] else "operations"
            log(f"  one Llama-2-7B layer's 7 linears at M={M} bf16: kernel "
                f"{sm['ms'] * 1e3:.1f} us, plain {sm['plain_ms'] * 1e3:.1f} us, dequant+two "
                f"matmuls {sm['yardstick_ms'] * 1e3:.1f} us, kernel 1 on bf16 factors "
                f"{sm['kernel1_ms'] * 1e3:.1f} us, bound {sm['bound_ms'] * 1e3:.1f} us ({by}: "
                f"{sm['bytes'] / 1e6:.1f} MB, {sm['flops'] / 1e9:.2f} GFLOP), "
                f"{100 * sm['bound_ms'] / sm['ms']:.1f}% of the bound"
                + (f"; form wmma_tiled {sm['old_ms'] * 1e3:.1f} us" if sm["old_ms"] else ""))
            return {"max_abs_err": err_at[M], "ms": sm["ms"], "plain_ms": sm["plain_ms"],
                    "bound_ms": sm["bound_ms"], "bound_by": by, "library_ms": None,
                    "yardstick_ms": sm["yardstick_ms"], "kernel1_ms": sm["kernel1_ms"],
                    "shape": f"7 linears of one Llama-2-7B layer, ratio 0.9, M={M}, bf16"}
        m1024 = dict(q_row(1024), form="wgmma_tiled", wmma_tiled_ms=sums[1024]["old_ms"])
        record[name] = {
            "name": name, "route": "cuda",
            "source": f"asvd4llm_tpu_torch/csrc/{name}.cu", "replaces": tpu_line,
            **q_row(DECODE_BATCH), "m1024": m1024,
        }
        if kind == "q8":
            record[name]["m1024_kv_target_ranks"] = q8_unaligned_ranks(torch, timer, g, failures)


def q8_unaligned_ranks(torch, timer, g, failures):
    """Kernel 3 at KERNEL1_KV_SHAPES (ranks as the CLI leaves them at its
    default rank_align), bf16, M=1024: the factors quantized to int8 and
    padded by align_ranks' pad_rank must take the wgmma form and match the
    plain version of the unpadded leaf; the unpadded leaf (the WMMA form)
    too. The two timed in turns beside dequantize + two matmuls and the
    bound. -> their sums for the kernels line."""
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops.lowrank import pad_rank
    from asvd4llm_tpu_torch.ops.quant import QuantParams

    M, atol, rtol = 1024, 2e-2, 2e-2
    keys = ("wmma_tiled_ms", "padded_wgmma_tiled_ms", "yardstick_ms", "bound_ms")
    sums = dict.fromkeys(keys, 0.0)
    err_all = 0.0
    counter = fq.fused_lowrank_apply_q8
    for name, N, K, R in KERNEL1_KV_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        a = (torch.randn(N, R, generator=g, device="cuda") * R ** -0.5).bfloat16()
        b = (torch.randn(R, K, generator=g, device="cuda") * K ** -0.5).bfloat16()
        bias = (torch.randn(N, generator=g, device="cuda") * 0.1).bfloat16()
        q = quantize_factors(torch, "q8", a, b)
        leaf = {"A8": q[0], "Asc": q[1].scale, "Azp": q[1].zero, "B8": q[2],
                "Bsc": q[3].scale, "Bzp": q[3].zero, "b": bias}
        p = pad_rank(leaf)
        qp = (p["A8"], QuantParams(p["Asc"], p["Azp"], 255), p["B8"],
              QuantParams(p["Bsc"], p["Bzp"], 255))
        ref = q_reference("q8", x, q, bias)
        runs = {"as is": lambda: q_apply("q8", x, q, bias),
                "padded": lambda: q_apply("q8", x, qp, bias)}
        want = {"as is": "wmma_tiled", "padded": "wgmma_tiled"}
        line = f"  bfloat16 M={M} {name:9s} N={N} K={K} R={R} int8"
        for label, fn in runs.items():
            out = fn()
            form = counter.last_form
            torch.cuda.synchronize()
            err = max_err(out, ref)[0]
            ok = within(out, ref, atol, rtol) and form == want[label]
            err_all = max(err_all, err)
            line += (f"; rank {label} ({p['Bsc'].shape[0] if label == 'padded' else R}) "
                     f"form={form} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"fused_lowrank_q8 M={M} {name} R={R} {label}")
        new_ms, old_ms, old2_ms, new2_ms = (
            timer.ms(runs[k]) for k in ("padded", "as is", "as is", "padded"))
        y_ms = timer.ms(lambda: q_apply("q8", x, q, bias, max_tokens=0))
        bms, by = bound(q_bytes("q8", q, M, N, K, 2), 2 * M * R * (K + N), torch.bfloat16)
        line += (f" | padded, wgmma_tiled {(new_ms + new2_ms) / 2 * 1e3:.1f} us, as is,"
                 f" wmma_tiled {(old_ms + old2_ms) / 2 * 1e3:.1f} us (in turns"
                 f" {new_ms * 1e3:.1f}/{old_ms * 1e3:.1f}/{old2_ms * 1e3:.1f}/"
                 f"{new2_ms * 1e3:.1f} us), dequant+two matmuls {y_ms * 1e3:.1f} us, bound"
                 f" {bms * 1e3:.1f} us ({by})")
        for k_, v_ in zip(keys, ((old_ms + old2_ms) / 2, (new_ms + new2_ms) / 2, y_ms, bms)):
            sums[k_] += v_
        log(line)
    log(f"  int8 k_proj + v_proj at the KV-target ranks, M=1024 bf16: padded (wgmma_tiled) "
        f"{sums['padded_wgmma_tiled_ms'] * 1e3:.1f} us, as is (wmma_tiled) "
        f"{sums['wmma_tiled_ms'] * 1e3:.1f} us, dequant+two matmuls "
        f"{sums['yardstick_ms'] * 1e3:.1f} us, bound {sums['bound_ms'] * 1e3:.1f} us")
    return dict(sums, max_abs_err=err_all,
                shape="int8 k_proj R=819 + v_proj R=409 of Llama-2-7B, M=1024, bf16")


def _dequantized(kind, q, K):
    """(A, B) of a quantized leaf dequantized in f32, cut to its true dims."""
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops.quant import dequantize
    if kind == "q8":
        a8, aq, b8, bq = q
        return dequantize(a8, aq), dequantize(b8[:, :K], bq)
    return fq._q4_factors(*q, Q4_GROUP, K, q[1].dtype)


KERNEL_NAMES = ("fused_lowrank", "latent_attention", "fused_lowrank_q8", "fused_lowrank_q4",
                "paged_dense_attention", "paged_latent_attention")


def _counted():
    """The wrapper that counts each kernel's launches, by kernel name (a
    replayed CUDA graph adds the launches its capture made, once per
    replay)."""
    from asvd4llm_tpu_torch.utils.graphs import counted_kernels
    return counted_kernels()


def kernel_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def form_counts():
    """Launches by form of each kernel (each has several)."""
    return {name: dict(fn.form_launches) for name, fn in _counted().items()
            if hasattr(fn, "form_launches")}


def reset_kernel_counts():
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = {}


def _sdpa_latent(torch, q, tk, tv, a_k, cos, sin, KV, hd, mask=None):
    """Yardstick, never called by the port: the unfused latent path with
    PyTorch's scaled_dot_product_attention (K materialized, V = latents;
    `mask` [B, 1, 1, T] bool, where a key may be attended)."""
    B, H, _ = q.shape
    T = tk.shape[1]
    k = torch.matmul(tk, a_k.t()).reshape(B, T, KV, hd).transpose(1, 2)
    half = hd // 2
    k = k * cos.to(k.dtype) + torch.cat([-k[..., half:], k[..., :half]], -1) * sin.to(k.dtype)
    rep = H // KV
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
    v = tv[:, None].expand(B, H, T, tv.shape[2])
    return torch.nn.functional.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                                            attn_mask=mask)


# ------------------------------------------------------ kernels 5 and 6

PAGE = 256                       # the engine's automatic page at 7B width, bf16
PAGED_POSITIONS = (1023, 700, 255, 0)
PAGED_MP = 4                     # logical pages per row in the kernel phase
PAGED_CASES = [  # (label, kernel, KV, Rk, Rv, softcap, sliding)
    ("dense", "dense", 32, 0, 0, 0.0, 0),
    ("vlatent", "vlatent", 32, 0, 1024, 0.0, 0),
    ("latent", "latent", 32, 1024, 1024, 0.0, 0),
    ("dense_gqa4", "dense", 8, 0, 0, 0.0, 0),
    ("vlatent_gqa4", "vlatent", 8, 0, 1024, 0.0, 0),
    ("latent_gqa4", "latent", 8, 1024, 1024, 0.0, 0),
    ("dense_sliding", "dense", 32, 0, 0, 0.0, 128),
    ("latent_softcap", "latent", 32, 1024, 1024, 50.0, 0),
]


def _live_keys(positions, sliding):
    return sum(p + 1 if sliding <= 0 else min(p + 1, sliding) for p in positions)


def paged_kernel_args(torch, pa, kind, q, pools, pt, positions, a_k=None, cos=None,
                      sin=None):
    """(core, plain version, positional args) of kernel 5 or 6."""
    if kind == "latent":
        return (pa._paged_latent_core, pa.paged_latent_reference,
                (q, pools["tk"], pools["tv"], a_k, cos, sin, pt, positions))
    v = pools["v"] if kind == "dense" else pools["tv"]
    return pa._paged_dense_core, pa.paged_dense_reference, (q, pools["k"], v, pt, positions)


def _sdpa_paged(torch, kind, q, pools, pt, positions, KV, hd, a_k=None, cos=None,
                sin=None):
    """Yardstick, never called by the port: gather the row's pages to
    [B, T] and run scaled_dot_product_attention with a per-row mask (kernel
    6: kernel 2's unfused latent yardstick on the gathered latents)."""
    B, H, _ = q.shape
    rows = pt.long()
    T = rows.shape[1] * PAGE
    mask = (torch.arange(T, device=q.device)[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    qd = q.to(next(iter(pools.values())).dtype)
    if kind == "latent":
        tk = pools["tk"][rows].flatten(1, 2)
        tv = pools["tv"][rows].flatten(1, 2)
        return _sdpa_latent(torch, qd, tk, tv, a_k, cos[:T].to(tk.dtype), sin[:T].to(tk.dtype),
                            KV, hd, mask=mask)
    rep = H // KV
    k = pools["k"][rows].flatten(1, 2).transpose(1, 2)            # [B, KV, T, hd]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
    if kind == "dense":
        v = pools["v"][rows].flatten(1, 2).transpose(1, 2)
        v = v.repeat_interleave(rep, dim=1) if rep > 1 else v
    else:
        tv = pools["tv"][rows].flatten(1, 2)
        v = tv[:, None].expand(B, H, T, tv.shape[2])
    return torch.nn.functional.scaled_dot_product_attention(qd[:, :, None, :], k, v,
                                                            attn_mask=mask)


def paged_bound(kind, positions, sliding, B, H, KV, hd, Rk, Rv, isz):
    """(bytes, operations) the step must move and do: each live key's K/V
    (or latent) rows once, A_k and the live cos/sin rows once (kernel 6),
    q and the f32 output once."""
    live = _live_keys(positions, sliding)
    width = Rv if kind != "dense" else hd
    io = B * H * hd * 4 + B * H * width * 4 + B * 4 * (1 + PAGED_MP)
    if kind == "dense":
        return live * 2 * KV * hd * isz + io, 2 * live * H * hd * 2
    if kind == "vlatent":
        return live * (KV * hd + Rv) * isz + io, 2 * live * H * (hd + Rv)
    max_live = max(positions) + 1
    return (live * (Rk + Rv) * isz + KV * hd * Rk * isz + 2 * max_live * hd * 4 + io,
            2 * live * (Rk * KV * hd + H * hd + H * Rv))


def phase_paged_kernels(torch, timer, record, failures):
    """Kernels 5 and 6 at Llama-2-7B width (H=32, hd=128, page 256) on a
    shuffled pool of 64 pages with ragged positions, each against its plain
    version in f32 and bf16; in bf16 the main cases are timed beside their
    bound, their plain version and a gather + SDPA yardstick, the split
    forms in turns with the tile32 form they replace."""
    from asvd4llm_tpu_torch.models.decoder import rope_cos_sin
    from asvd4llm_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(5)
    B, H, hd, NP = len(PAGED_POSITIONS), 32, 128, 64
    perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(5)) + 1
    pt = perm[:B * PAGED_MP].reshape(B, PAGED_MP).to(torch.int32).cuda()
    positions = torch.tensor(PAGED_POSITIONS, dtype=torch.int32, device="cuda")
    cos, sin = rope_cos_sin(torch.arange(PAGED_MP * PAGE, device="cuda"), hd, 10000.0)
    mains = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol = rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        for label, kind, KV, Rk, Rv, cap, sw in PAGED_CASES:
            def rnd(*shape, scale=0.5):
                return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)
            pools = {"k": rnd(NP, PAGE, KV, hd)} if kind != "latent" else \
                {"tk": rnd(NP, PAGE, Rk)}
            if kind == "dense":
                pools["v"] = rnd(NP, PAGE, KV, hd)
            else:
                pools["tv"] = rnd(NP, PAGE, Rv)
            a_k = rnd(KV * hd, Rk, scale=Rk ** -0.5) if kind == "latent" else None
            q = torch.randn(B, H, hd, generator=g, device="cuda")
            core, plain, args = paged_kernel_args(torch, pa, kind, q, pools, pt, positions,
                                                  a_k, cos, sin)
            kw = dict(scale=hd ** -0.5, softcap=cap, sliding=sw, kv_heads=KV)
            out = core(*args, **kw)
            form = (pa.paged_latent_decode_attention if kind == "latent"
                    else pa.paged_dense_decode_attention).last_form
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            err, med_rel = max_err(out, ref)
            ok = within(out, ref, atol, rtol) and bool(torch.isfinite(out).all())
            name = "paged_latent_attention" if kind == "latent" else "paged_dense_attention"
            line = (f"  {str(dtype)[6:]:8s} {name} {label:14s} B={B} H={H} KV={KV} hd={hd}"
                    f" P={PAGE} pool {NP} pages Rk={Rk} Rv={Rv} positions {PAGED_POSITIONS}"
                    + (f" form={form}" if form else "")
                    + f" max_abs_err={err:.3e} median_rel={med_rel:.2e}"
                    f" tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {dtype} {label}")
            if dtype == torch.bfloat16 and label in ("dense", "vlatent", "latent"):
                nbytes, flops = paged_bound(kind, PAGED_POSITIONS, sw, B, H, KV, hd, Rk, Rv,
                                            pools[next(iter(pools))].element_size())
                bms, by = bound(nbytes, flops, dtype)
                k_ms = timer.ms(lambda: core(*args, **kw))
                extra = {}
                if form in ("split_wgmma", "split_tma"):
                    k_ms, extra["tile32_ms"], text = old_form_in_turns(
                        torch, timer, lambda: core(*args, **kw),
                        lambda: core(*args, form="tile32", **kw), "tile32", ref, k_ms, atol,
                        rtol, failures, f"{name} tile32 {label}")
                    line += text
                p_ms = timer.ms(lambda: plain(*args, **kw))
                l_ms = timer.ms(lambda: _sdpa_paged(torch, kind, q, pools, pt, positions,
                                                    KV, hd, a_k, cos, sin))
                line += (f" | kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us,"
                         f" gather+SDPA {l_ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us"
                         f" ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP),"
                         f" {100 * bms / k_ms:.1f}% of the bound")
                acts = timer.by_activity(lambda: core(*args, **kw))
                line += "; device us by launch: " + ", ".join(
                    f"{n} {us:.1f}" for n, us in acts.items())
                mains[label] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                                "bound_ms": bms, "bound_by": by, "library_ms": l_ms, **extra}
            log(line)
            del pools, a_k, args, out, ref
    shape = (f"B={B} H=KV=32 hd={hd} P={PAGE}, shuffled pool of {NP} pages, positions "
             f"{PAGED_POSITIONS}, bf16")
    record["paged_dense_attention"] = {
        "name": "paged_dense_attention", "route": "cuda",
        "source": "asvd4llm_tpu_torch/csrc/paged_dense_attention.cu",
        "replaces": "asvd4llm_tpu/ops/pallas_latent_attention.py:405",
        **mains["dense"], "shape": shape + ", dense V, form split_tma",
        "vlatent": dict(mains["vlatent"], shape=shape + ", V-latent Rv=1024, form split_tma"),
    }
    record["paged_latent_attention"] = {
        "name": "paged_latent_attention", "route": "cuda",
        "source": "asvd4llm_tpu_torch/csrc/paged_latent_attention.cu",
        "replaces": "asvd4llm_tpu/ops/pallas_latent_attention.py:496",
        **mains["latent"], "shape": shape + ", Rk=Rv=1024, form split_wgmma",
    }


# -------------------------------------------------------------- main path

def write_checkpoint(work, config, layers):
    """A random bf16 checkpoint at the config's widths, depth cut to
    `layers`."""
    from asvd4llm_tpu_torch.utils.testing import write_random_checkpoint
    ckpt = os.path.join(work, "ckpt")
    t0 = time.perf_counter()
    write_random_checkpoint(ckpt, dict(config, num_hidden_layers=layers),
                            seed=0, dtype="bfloat16")
    log(f"checkpoint: {ckpt} (random weights, seed 0, bf16) in "
        f"{time.perf_counter() - t0:.1f} s; reduced: num_hidden_layers "
        f"{config['num_hidden_layers']}→{layers}")
    return ckpt


def run_cli(torch, ckpt, work, target_flags, sizes, device):
    """One compression run through the port's CLI; returns its output."""
    from asvd4llm_tpu_torch import cli
    argv = ["--model_id", ckpt, *target_flags, "--act_aware",
            "--calib_dataset", "synthetic", "--eval_ppl", "synthetic",
            "--n_calib_samples", str(sizes["n_calib_samples"]),
            "--seqlen", str(sizes["seqlen"]), "--eval_dtype", "bfloat16",
            "--cache_dir", os.path.join(work, "cache"),
            "--output_dir", os.path.join(work, "out")]
    log(f"  cli: {' '.join(argv[2:])}")
    t0 = time.perf_counter()
    out = cli.main(argv, device=device)
    secs = time.perf_counter() - t0
    ppl = out["results"]["synthetic"]
    manifest = out["manifest"] or {}
    log(f"  ppl(synthetic, seqlen {sizes['seqlen']}) = {ppl!r}; manifest: "
        f"{len(manifest)} low-rank leaves {manifest}")
    log("  phase times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["phase_times"].items())
        + f"; total {secs:.1f}")
    if not (ppl == ppl and 1.0 < ppl < float("inf")):
        raise AssertionError(f"PPL {ppl!r} is not a finite value above 1")
    if not manifest:
        raise AssertionError("the compression run factorized no leaf")
    return out


def _check_tokens(toks, prompt, vocab):
    B, S = prompt.shape
    if toks.shape != (B, S + NEW_TOKENS) or (toks[:, :S] != prompt).any() \
            or toks.min() < 0 or toks.max() >= vocab:
        raise AssertionError(f"generation returned a wrong result, shape {toks.shape}")


def greedy(torch, out, prompt, *, latent_kv):
    """Greedy decode with use_pallas=True, in turns: generate_on_device (the
    served path: one captured CUDA graph replayed per token), generate
    (eager steps and a host read per token), generate, generate_on_device.
    All four must emit the same tokens; returns them."""
    from asvd4llm_tpu_torch.eval.generate import generate, generate_on_device
    B, S = prompt.shape
    secs = {"graph": [], "eager": []}
    runs = []
    dev = out["params"]["embed_tokens"].device
    for path, fn in (("graph", generate_on_device), ("eager", generate),
                     ("eager", generate), ("graph", generate_on_device)):
        _sync(torch, dev)
        t0 = time.perf_counter()
        toks = fn(out["params"], out["spec"], prompt, max_new_tokens=NEW_TOKENS,
                  latent_kv=latent_kv, use_pallas=True)
        _sync(torch, dev)
        secs[path].append(time.perf_counter() - t0)
        _check_tokens(toks, prompt, out["spec"].vocab_size)
        runs.append(toks)
    first = runs[0]
    if not all(np.array_equal(t, first) for t in runs):
        same = [[int(np.array_equal(a, b)) for b in runs] for a in runs]
        cols = [int(np.argmax((t != first).any(axis=0))) - S for t in runs[1:]]
        raise AssertionError(f"generate_on_device and generate disagree: runs "
                             f"graph/eager/eager/graph equal pairwise {same}; first "
                             f"differing new token of runs 2-4 vs run 1: {cols}")
    g, e = (float(np.mean(secs[k])) for k in ("graph", "eager"))
    log(f"  generate_on_device vs generate (batch {B}, prompt {S}, {NEW_TOKENS} new, "
        f"latent_kv={latent_kv}, use_pallas=True), in turns graph/eager/eager/graph "
        f"{'/'.join(f'{t:.3f}' for t in (secs['graph'][0], *secs['eager'], secs['graph'][1]))}"
        f" s (prefill and, for the graph, its capture included): graph {g:.3f} s "
        f"{B * NEW_TOKENS / g:.1f} tok/s, eager {e:.3f} s {B * NEW_TOKENS / e:.1f} tok/s; "
        f"identical tokens, first row's new {first[0, S:S + 8].tolist()}...")
    return first


def step_check(torch, out, prompt, *, latent_kv, steps=16):
    """One decode step after the prompt, with the kernels and with the plain
    tensor path on the same caches: the logits must agree within a bf16
    tolerance (5% of the largest logit; bf16 keeps 8 bits of mantissa and a
    step rounds some thirty times). Then the step on the host clock as
    eager launches and as a replay of its captured CUDA graph, in turns
    (eager, graph, graph, eager, `steps` // 4 steps each), each from its
    own copy of the prefilled caches, and a traced window of `steps` // 2
    steps of each. Returns {path: (step ms, device busy ms, idle share)}."""
    from asvd4llm_tpu_torch.eval.generate import (
        DecodeGraph, decode_step, init_caches, prefill_host,
    )
    from asvd4llm_tpu_torch.ops.lowrank import align_ranks

    # ranks padded to the kernels' multiple, as generate(use_pallas=True) does
    params, spec = align_ranks(out["params"], out["spec"]), out["spec"]
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(prompt, device=dev)
    B, S = ids.shape
    caches = init_caches(params, spec, B, S + steps, params["embed_tokens"].dtype,
                         latent=latent_kv, device=dev)
    logits, caches = prefill_host(params, spec, ids, caches, latent=latent_kv)
    tok = torch.argmax(logits, dim=-1)[:, None]
    clone = [{k: v.clone() for k, v in c.items()} for c in caches]
    fused, _ = decode_step(params, spec, tok, clone, S, use_pallas=True)
    clone = [{k: v.clone() for k, v in c.items()} for c in caches]
    plain, _ = decode_step(params, spec, tok, clone, S, use_pallas=False)
    if fused.shape != (B, spec.vocab_size) or not bool(torch.isfinite(fused).all()):
        raise AssertionError("decode-step logits are not finite or of a wrong shape")
    err = float((fused - plain).abs().max())
    tol = 0.05 * float(plain.abs().max())
    agree = float((fused.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"  first decode step, kernels vs plain tensor path: max_abs_err "
        f"{err:.3e} tol {tol:.3e} (5% of max |logit|), argmax agreement "
        f"{agree:.2f} {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        raise AssertionError("decode step with the kernels disagrees with the plain path")
    kernels_at_path_shapes(torch, params, spec, caches, S)
    state = {"tok": tok, "caches": [{k: v.clone() for k, v in c.items()} for c in caches],
             "pos": S}

    def eager(n):
        for _ in range(n):
            logits, state["caches"] = decode_step(params, spec, state["tok"],
                                                  state["caches"], state["pos"],
                                                  use_pallas=True)
            state["tok"] = torch.argmax(logits, dim=-1)[:, None]
            state["pos"] += 1
    dg = DecodeGraph(params, spec, tok, caches, S, steps + 1, use_pallas=True)
    run = {"eager": eager, "graph": dg.replay}
    q = steps // 4
    host = {"eager": 0.0, "graph": 0.0}
    for path in ("eager", "graph", "graph", "eager"):
        _sync(torch, dev)
        t0 = time.perf_counter()
        run[path](q)
        _sync(torch, dev)
        host[path] += (time.perf_counter() - t0) * 1e3 / (2 * q)
    result = {}
    for path in ("eager", "graph"):
        busy, idle = decode_breakdown(torch, lambda: run[path](steps // 2), steps // 2,
                                      f"{path} decode") if dev.type == "cuda" else (None, None)
        result[path] = (host[path], busy, idle)
    log(f"  decode step with the kernels, host clock: eager {host['eager']:.3f} ms, graph "
        f"replay {host['graph']:.3f} ms ({B * 1e3 / host['graph']:.1f} tok/s at batch {B}, "
        f"cache {S + steps}); graph capture {dg.graph.capture_s * 1e3:.1f} ms (warm-up "
        f"step included)")
    result["capture_ms"] = dg.graph.capture_s * 1e3
    return result


def kernels_at_path_shapes(torch, params, spec, caches, pos):
    """Each kernel against its plain version at the shapes this main-path
    run gives it: every low-rank leaf of the compressed model on a random
    decode-batch x, and every latent layer on its filled caches with a random
    query at `pos`. Same tolerances as the kernel phase."""
    from asvd4llm_tpu_torch.models.decoder import attn_scale, rope_cos_sin
    from asvd4llm_tpu_torch.models.registry import (
        is_lowrank, is_q4_lowrank, is_q8_lowrank, iter_linears,
    )
    from asvd4llm_tpu_torch.ops import fused_lowrank as fl
    from asvd4llm_tpu_torch.ops import latent_attention as la
    from asvd4llm_tpu_torch.ops.quant import QuantParams

    dev = params["embed_tokens"].device
    dtype = params["embed_tokens"].dtype
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.Generator(device=dev).manual_seed(2)
    B = caches[0][next(iter(caches[0]))].shape[0]
    for name, leaf in iter_linears(params, spec, include_extras=True):
        quant = "q8" if is_q8_lowrank(leaf) else "q4" if is_q4_lowrank(leaf) else None
        if quant:
            # x as wide as the path gives it (q4 codes are padded to 512)
            K = spec.intermediate_size if name.endswith("down_proj") else spec.hidden_size
            q = (leaf["A8"], QuantParams(leaf["Asc"], leaf["Azp"], 255), leaf["B8"],
                 QuantParams(leaf["Bsc"], leaf["Bzp"], 255)) if quant == "q8" else \
                tuple(leaf[k] for k in ("A4", "Asc", "Azs", "B4", "Bsc", "Bzs"))
            x = torch.randn(B, K, generator=g, device=dev).to(dtype)
            out = q_apply(quant, x, q, leaf["b"])
            ref = q_reference(quant, x, q, leaf["b"])
            sync()
            err, _ = max_err(out, ref)
            ok = within(out, ref, 2e-2, 2e-2)
            log(f"  fused_lowrank_{quant} at {name} (M={B}, N={out.shape[1]}, K={K}, "
                f"codes {tuple(q[0].shape)} / {tuple(q[2 if quant == 'q8' else 3].shape)}): "
                f"max_abs_err {err:.3e} tol=atol 0.02 + rtol 0.02 {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_lowrank_{quant} disagrees with its plain "
                                     f"version at {name}")
            continue
        if not is_lowrank(leaf):
            continue
        x = torch.randn(B, leaf["B"].shape[1], generator=g, device=dev).to(dtype)
        out = fl.fused_lowrank_apply(x, leaf["A"], leaf["B"], leaf["b"])
        ref = fl.fused_lowrank_reference(x, leaf["A"], leaf["B"], leaf["b"])
        sync()
        err, _ = max_err(out, ref)
        ok = within(out, ref, 2e-2, 2e-2)
        log(f"  fused_lowrank at {name} (M={B}, N={leaf['A'].shape[0]}, "
            f"K={leaf['B'].shape[1]}, R={leaf['A'].shape[1]}, form "
            f"{fl.fused_lowrank_apply.last_form}): max_abs_err {err:.3e} "
            f"tol=atol 0.02 + rtol 0.02 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_lowrank disagrees with its plain version at {name}")
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    for i, (layer, cache) in enumerate(zip(params["layers"], caches)):
        if "tk" not in cache:
            continue
        tk, tv = cache["tk"], cache["tv"]
        T = tk.shape[1]
        cos, sin = rope_cos_sin(torch.arange(T, device=dev), hd, spec.rope_theta)
        q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
        kw = dict(scale=attn_scale(spec), softcap=spec.attn_logit_softcap,
                  sliding=spec.sliding_window if spec.layer_uses_sliding(i) else 0,
                  kv_heads=KV)
        args = (q, tk, tv, layer["k_proj"]["A"], cos.float().contiguous(),
                sin.float().contiguous(), pos)
        out = la._latent_attention_core(*args, **kw)
        ref = la.latent_attention_reference(*args, **kw)
        sync()
        err, _ = max_err(out, ref)
        ok = within(out, ref, 1e-2, 1e-2)
        log(f"  latent_attention at layer {i} (B={B} H={H} KV={KV} hd={hd} T={T} "
            f"Rk={tk.shape[2]} Rv={tv.shape[2]} pos={pos}, form "
            f"{la.latent_decode_attention.last_form}): max_abs_err {err:.3e} "
            f"tol=atol 0.01 + rtol 0.01 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"latent_attention disagrees with its plain version "
                                 f"at layer {i}")


def decode_breakdown(torch, run, steps, label="decode"):
    """Where a decode step's device time goes: GPU activity by kernel name
    from a profiler trace of `steps` steps, and the device's idle share of
    the traced wall time. Returns (device busy ms per step, idle share), or
    (None, None) when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        log(f"  {label} breakdown: the profiler trace holds no device activity")
        return None, None
    idle = max(0.0, 1 - busy / wall)
    log(f"  {label} breakdown over {steps} steps: device busy {busy / steps:.3f} ms "
        f"per step, traced wall {wall / steps:.3f} ms per step (profiler on), "
        f"device idle share {idle:.3f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {t / steps:.4f} ms/step {100 * t / busy:5.1f}%  {name[:90]}")
    return busy / steps, idle


def main_prompt(vocab):
    """The decode prompt of every main-path and export run."""
    return np.random.RandomState(1).randint(0, vocab, (DECODE_BATCH, PROMPT_LEN))


class FisherProbe:
    """Around one CLI run: wraps the pipeline's calib_fisher_info to keep
    the Fisher vectors it returns and the device's peak memory over the
    call (`vectors` stays None in a run that computes none)."""

    def __init__(self, torch):
        self.torch = torch
        self.vectors = self.peak = self.base = None

    def __enter__(self):
        from asvd4llm_tpu_torch import pipeline
        torch, self.orig = self.torch, pipeline.calib_fisher_info

        def probe(params, *args, **kw):
            dev = params["embed_tokens"].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                self.base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            self.vectors = self.orig(params, *args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                self.peak = torch.cuda.max_memory_allocated(dev)
            return self.vectors
        pipeline.calib_fisher_info = probe
        return self

    def __exit__(self, *exc):
        from asvd4llm_tpu_torch import pipeline
        pipeline.calib_fisher_info = self.orig

    def check(self, out):
        """One vector per linear (lm_head included), each finite and
        positive somewhere; logs the phase's seconds and peak memory."""
        from asvd4llm_tpu_torch.models.registry import iter_linears
        names = [n for n, _ in iter_linears(out["params"], out["spec"], include_extras=True)]
        vecs = self.vectors
        mem = "not measured" if self.peak is None else (
            f"{self.peak / 1e9:.3f} GB ({self.base / 1e9:.3f} GB held before the phase)")
        log(f"  calib_fisher: {out['phase_times']['calib_fisher']:.3f} s, {len(vecs)} Fisher "
            f"vectors for {len(names)} linears (lm_head included), peak device memory over "
            f"the phase {mem}; largest entries "
            + ", ".join(f"{n.rsplit('.', 1)[-1]} {float(vecs[n].max()):.3e}"
                        for n in names[:7] + ["lm_head"]))
        if sorted(vecs) != sorted(names):
            raise AssertionError(f"Fisher vectors for {sorted(set(names) ^ set(vecs))[:4]} "
                                 f"missing or extra")
        bad = [n for n, v in vecs.items()
               if not bool(self.torch.isfinite(v).all()) or not bool((v > 0).any())]
        if bad:
            raise AssertionError(f"Fisher vectors not finite or all 0: {bad[:4]}")


WEIGHT_TARGET = ["--param_ratio_target", "0.9", "--rank_align", "128"]
KV_TARGET = ["--compress_kv_cache", "--kv_cache_ratio_target", "0.5"]  # rank_align 1
# (run, what it adds to the CLI, cache mode of its decode or None for a
# PPL-only run, the kernel the run must launch)
MAIN_RUNS = [
    ("weight target", WEIGHT_TARGET, False, "fused_lowrank"),
    ("KV-cache target", KV_TARGET, True, "latent_attention"),
    ("int8 factors", WEIGHT_TARGET + ["--deploy_int8_factors"], False, "fused_lowrank_q8"),
    # k/v at ranks 819/409, which align_ranks pads to 832/416 in evaluate
    # and generate
    ("int8 factors, default rank_align", KV_TARGET + ["--deploy_int8_factors"], False,
     "fused_lowrank_q8"),
    ("int4 factors", WEIGHT_TARGET + ["--deploy_int4_factors", "--int4_group_size",
                                      str(Q4_GROUP)], False, "fused_lowrank_q4"),
    ("AWQ int4 fake-quant", WEIGHT_TARGET + ["--weight_quant", "awq_int4"], None, None),
    ("Fisher scaling", WEIGHT_TARGET + ["--scaling_method", "fisher_abs_mean"], False,
     "fused_lowrank"),
]


def phase_main_path(torch, work, config, layers, sizes, device, launches, models=None):
    """The MAIN_RUNS through the CLI on one checkpoint and cache directory
    (runs after the first reuse its sensitivity scan), each but the last
    followed by greedy decode with use_pallas=True and a decode-step check.
    The kernel counts are set to 0 just before each run and read just after
    its decode; `launches` accumulates them per kernel. `models`, when
    given, keeps (params, spec, greedy tokens, manifest) of the SERVE_MODELS
    and EXPORT_RUNS runs for the serve and export phases. Returns
    {run: counts}."""
    ckpt = write_checkpoint(work, config, layers)
    prompt = main_prompt(config["vocab_size"])
    counts_by_run = {}
    steps = {}
    for run, flags, latent_kv, _ in MAIN_RUNS:
        decode = "PPL only" if latent_kv is None else \
            f"then generate with {'the latent' if latent_kv else 'dense'} caches"
        log(f"main path, {run}: cli {' '.join(flags)}, {decode}")
        reset_kernel_counts()
        with FisherProbe(torch) as fisher:
            out = run_cli(torch, ckpt, work, flags, sizes, device)
        if fisher.vectors is not None:
            fisher.check(out)
        toks = None
        if latent_kv is not None:
            toks = greedy(torch, out, prompt, latent_kv=latent_kv)
        counts, forms = kernel_counts(), form_counts()
        log(f"  kernel launches in this run: {counts}; by form: {forms}")
        check_forms(run, MAIN_FORMS.get(run, {}), forms)
        if run in UNALIGNED_Q8_RUNS:
            check_unaligned_q8(run, out)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        counts_by_run[run] = counts
        if latent_kv is not None:
            steps[run] = step_check(torch, out, prompt, latent_kv=latent_kv)
        if models is not None and run in SERVE_MODELS + EXPORT_RUNS:
            models[run] = (out["params"], out["spec"], toks, out["manifest"])
        del out
    log("decode steps, graph vs eager (step ms on the host clock / device busy ms per step"
        " / idle share on the host clock, 1 - busy / step / idle share in the traced "
        "window, profiler on; capture ms):")
    for run, r in steps.items():
        log(f"  {run}: " + "; ".join(
            f"{p} {r[p][0]:.3f} / " + ("not measured" if r[p][1] is None else
                                      f"{r[p][1]:.3f} / {1 - r[p][1] / r[p][0]:.3f} / "
                                      f"{r[p][2]:.3f}")
            for p in ("graph", "eager")) + f"; capture {r['capture_ms']:.1f}")
    return counts_by_run


# the tensor-core form each run's kernel-path work must take: the PPL eval
# at M=1024 (kernel 1, kernel 3 in the int8 runs, kernel 4 in the int4 run)
# and, in the KV-target run, the latent decode (its ranks padded); none of
# these kernels may run an earlier form (OLD_FORMS) in the run
MAIN_FORMS = {"weight target": {"fused_lowrank": "wgmma_tiled"},
              "KV-cache target": {"fused_lowrank": "wgmma_tiled",
                                  "latent_attention": "split_wgmma"},
              "int8 factors": {"fused_lowrank_q8": "wgmma_tiled"},
              "int8 factors, default rank_align": {"fused_lowrank_q8": "wgmma_tiled"},
              "int4 factors": {"fused_lowrank_q4": "wgmma_tiled"},
              "Fisher scaling": {"fused_lowrank": "wgmma_tiled"}}
OLD_FORMS = ("wmma_tiled", "tile32", "cuda_cores")
# runs whose int8 leaves come out of the search at ranks that are not
# multiples of 16, so that only align_ranks in evaluate and generate (and
# not the search) sends their M=1024 calls to wgmma_tiled
UNALIGNED_Q8_RUNS = ("int8 factors, default rank_align",)


def check_unaligned_q8(run, out):
    """The run's int8 leaves keep their true ranks, and some are not
    multiples of 16."""
    from asvd4llm_tpu_torch.models.registry import is_q8_lowrank, iter_linears
    ranks = {name: leaf["Bsc"].shape[0] for name, leaf in
             iter_linears(out["params"], out["spec"], include_extras=True)
             if is_q8_lowrank(leaf)}
    log(f"  int8 ranks as the search left them: {ranks}")
    if not any(r % 16 for r in ranks.values()):
        raise AssertionError(f"{run}: no int8 leaf has a rank to pad ({ranks})")


def check_forms(run, want, forms):
    """Each kernel of `want` launched its named form in the run, and no
    earlier form."""
    for kernel, form in want.items():
        got = forms.get(kernel, {})
        if not got.get(form):
            raise AssertionError(f"{run}: {kernel} never ran its {form} form ({got})")
        old = [f for f in got if f in OLD_FORMS]
        if old:
            raise AssertionError(f"{run}: {kernel} ran the earlier forms {old} ({got})")


def fisher_full_depth(torch, config, device, seqlen=256):
    """One Fisher calibration batch (1 x `seqlen` tokens) of the model at
    its published depth, random bf16 weights built on the device from seed
    0 (no file written). The peak-memory counter is reset after the weights
    are built; the batch's peak above what the device held before must stay
    below 1.25x the weights' bytes (keeping every linear's gradient would
    need about 2x). A second batch is timed warm."""
    from asvd4llm_tpu_torch.calib.fisher import calib_fisher_info
    from asvd4llm_tpu_torch.export.checkpoint import flatten
    from asvd4llm_tpu_torch.models.init import init_params
    from asvd4llm_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(config)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    _sync(torch, dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    _sync(torch, dev)
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in flatten(params))
    weight_bytes = sum(t.numel() * t.element_size() for _, t in flatten(params))
    loader = [{"input_ids": np.random.RandomState(2).randint(0, spec.vocab_size, (1, seqlen))}]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        fisher = calib_fisher_info(params, spec, loader)
        _sync(torch, dev)
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    # forward, the layers' forward again under remat, backward (2x forward)
    flop = 8 * n_params * (seqlen - 1)
    log(f"full-depth Fisher batch: {spec.num_layers} layers, {n_params / 1e9:.3f} G params, "
        f"weights {weight_bytes / 1e9:.3f} GB built on the device in {build_s:.1f} s; "
        f"1 x {seqlen} tokens: {secs[0]:.3f} s first batch, {secs[1]:.3f} s warm "
        f"({flop / 1e12:.1f} TFLOP at 8 N T: {flop / secs[1] / 1e12:.1f} TFLOP/s warm); "
        f"peak device memory above the {base / 1e9:.3f} GB held before "
        + ("not measured" if peak is None else
           f"{peak / 1e9:.3f} GB = {peak / weight_bytes:.3f}x the weights (limit 1.25x)"))
    want = spec.num_layers * 7 + 1
    bad = [n for n, v in fisher.items()
           if not bool(torch.isfinite(v).all()) or not bool((v > 0).any())]
    if len(fisher) != want or bad:
        raise AssertionError(f"full-depth Fisher: {len(fisher)} vectors of {want}; "
                             f"not finite or all 0: {bad[:4]}")
    if peak is not None and peak >= 1.25 * weight_bytes:
        raise AssertionError(f"full-depth Fisher peaked at {peak / weight_bytes:.3f}x the "
                             f"weights' bytes: the gradients are not freed as they come")
    del params, fisher
    if cuda:
        torch.cuda.empty_cache()


# ------------------------------------------------------------- full depth

# the full-depth compression run: Llama-2-7B at its published 32 layers
FULLDEPTH_SIZES = {"n_calib_samples": 8, "seqlen": 256}
# the leaves whose grid is timed with the suffix and the serial evaluator
PAIRED_LEAVES = [(0, "q_proj"), (0, "down_proj"), (16, "q_proj"), (16, "down_proj"),
                 (31, "q_proj"), (31, "down_proj")]
# the predicted per-leaf speedup of the suffix evaluator: the serial one runs
# all L layers and the head, the suffix one layers l..L-1 and the head; at
# Llama-2-7B widths the head (4096 x 32000) costs 131 M MACs a token against
# 202 M for a layer
HEAD_IN_LAYERS = 4096 * 32000 / (4 * 4096 * 4096 + 3 * 4096 * 11008)


def _fulldepth_cfg(work, tag, layers, **kw):
    from asvd4llm_tpu_torch.config import ASVDConfig
    return ASVDConfig(
        model_id=f"llama-2-7b-random-{layers}l", param_ratio_target=0.9, rank_align=128,
        act_aware=True, calib_dataset="synthetic", eval_ppl="synthetic",
        n_calib_samples=FULLDEPTH_SIZES["n_calib_samples"], seqlen=FULLDEPTH_SIZES["seqlen"],
        eval_dtype="bfloat16", use_cache=False, use_pallas=True,
        cache_dir=os.path.join(work, f"{tag}_cache"), output_dir=os.path.join(work, f"{tag}_out"),
        scan_resume_path=os.path.join(work, f"{tag}_scan.jsonl"), **kw)


def _random_model(torch, config, layers, dev):
    """Random bf16 weights at the config's widths and `layers` depth, built
    on the device from seed 0 (no file written)."""
    from asvd4llm_tpu_torch.models.init import init_params
    from asvd4llm_tpu_torch.models.spec import spec_from_hf_config
    spec = spec_from_hf_config(dict(config, num_hidden_layers=layers))
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    return params, spec


def scan_split(scan_log):
    """The scan's per-leaf records by leaf shape: leaves, backends, SVD and
    evaluation seconds, candidates."""
    by: dict = {}
    for r in scan_log:
        d = by.setdefault(r["shape"], {"leaves": 0, "backends": set(), "svd_s": 0.0,
                                       "eval_s": 0.0, "candidates": 0})
        d["leaves"] += 1
        d["backends"].add(r["backend"])
        d["svd_s"] += r["svd_s"]
        d["eval_s"] += r["eval_s"]
        d["candidates"] += r["candidates"]
    return by


def paired_evaluators(torch, params, spec, cfg, art, dev):
    """For PAIRED_LEAVES, the leaf's weight grid (one SVD, six dense
    candidates) scored by the suffix evaluator (layers l..31 and the head
    from the cached hidden at layer l's input) and by the serial one (a full
    forward per candidate), in turns suffix/serial/serial/suffix; the PPLs
    must agree within rtol 1e-3 (bf16: the two run other row batches)."""
    from asvd4llm_tpu_torch.calib import sensitivity as sens
    from asvd4llm_tpu_torch.eval.ppl import evaluate_perplexity
    from asvd4llm_tpu_torch.models.registry import linear_name, set_linear
    from asvd4llm_tpu_torch.ops.asvd import build_scaling_vector

    grid = sens.WEIGHT_RATIO_GRID
    ids = np.concatenate([np.asarray(b["input_ids"]) for b in art["calib_loader"]])
    n = ids.shape[0]
    rows = torch.as_tensor(ids, device=dev)
    labels, mask = rows[:, 1:], torch.ones(n, device=dev)
    L = len(params["layers"])
    with torch.no_grad():
        hidden, at = sens._embed_rows(params, spec, rows), 0
        for li, key in PAIRED_LEAVES:
            while at < li:
                hidden, at = sens._advance_block(params, spec, hidden, at), at + 1
            name = linear_name(spec, li, key)
            leaf = params["layers"][li][key]
            scale = build_scaling_vector(art["stats"][name], None, cfg.alpha)
            leaves = sens.recomposed_dense_all_ratios(
                leaf["w"], leaf["b"], grid, scale, cfg.rank_align, cfg.svd_backend,
                torch.Generator(device=dev).manual_seed(0))
            w_hats = torch.stack([leaves[r]["w"] for r in grid])
            run = {
                "suffix": lambda: sens._blocks_ppl(n, [sens._ppl_multi_ratio_suffix(
                    params, spec, hidden, labels, mask, key, li, w_hats)]),
                "serial": lambda: np.array([evaluate_perplexity(
                    set_linear(params, spec, name, leaves[r]), spec, ids, n) for r in grid]),
            }
            secs = {"suffix": [], "serial": []}
            ppl = {}
            for path in ("suffix", "serial", "serial", "suffix"):
                ppl[path], s = _timed(torch, dev, run[path])
                secs[path].append(s)
            t_suf, t_ser = (float(np.median(secs[p])) for p in ("suffix", "serial"))
            pred = (L + HEAD_IN_LAYERS) / (L - li + HEAD_IN_LAYERS)
            rel = float(np.max(np.abs(ppl["suffix"] / ppl["serial"] - 1)))
            log(f"  {name} grid of {len(grid)}: suffix {'/'.join(f'{s:.3f}' for s in secs['suffix'])}"
                f" s, serial {'/'.join(f'{s:.3f}' for s in secs['serial'])} s (in turns); "
                f"speedup {t_ser / t_suf:.2f}x measured, {pred:.2f}x predicted "
                f"((L + head) / (L - l + head), head = {HEAD_IN_LAYERS:.3f} layers); "
                f"PPL max rel diff {rel:.2e} (rtol 1e-3); suffix PPL "
                f"{[round(float(p), 3) for p in ppl['suffix']]}")
            if not rel <= 1e-3:
                raise AssertionError(f"{name}: the suffix and serial evaluators disagree "
                                     f"({ppl['suffix']} against {ppl['serial']})")


def resume_on_card(torch, work, config, dev):
    """Per-leaf resume at 2 layers: a finished scan's JSONL cut to half its
    lines (and no factor checkpoints, as after a kill inside the scan),
    then a rerun with the cache off must recompute only the missing leaves
    and give the same sensitivity dict (replayed leaves bit for bit,
    recomputed ones within rtol 1e-5) and the same manifest."""
    from asvd4llm_tpu_torch import pipeline
    params, spec = _random_model(torch, config, SMOKE_LAYERS, dev)
    cfg = _fulldepth_cfg(work, "resume", SMOKE_LAYERS)
    path = cfg.scan_resume_path
    _, man, art = pipeline.compress(params, spec, None, cfg)
    with open(path) as f:
        lines = f.readlines()
    keep = len(lines) // 2
    with open(path, "w") as f:
        f.writelines(lines[:keep])
    shutil.rmtree(path + ".factors")
    scan_log = []
    (_, man2, art2), secs = _timed(torch, dev, lambda: pipeline.compress(
        params, spec, None, cfg, scan_log=scan_log))
    sens, sens2 = art["sensitivity"], art2["sensitivity"]
    names = list(sens)
    recomputed = [r["name"] for r in scan_log]
    bitwise = sens2 == sens
    worst = max(abs(sens2[n][r] / sens[n][r] - 1) for n in names[keep:] for r in sens[n])
    log(f"resume at {SMOKE_LAYERS} layers: JSONL of {len(lines)} leaves cut to {keep}; the "
        f"rerun ({secs:.2f} s) recomputed {len(recomputed)} leaves, "
        f"{'the same dict bit for bit' if bitwise else f'recomputed PPLs within {worst:.2e}'}"
        f", manifest {'equal' if man2 == man else 'DIFFERENT'} ({len(man2)} leaves)")
    if recomputed != names[keep:] or list(sens2) != names or man2 != man:
        raise AssertionError(f"resume recomputed {recomputed} of {names}; manifests "
                             f"{man2} against {man}")
    if any(sens2[n] != sens[n] for n in names[:keep]) or not worst <= 1e-5:
        raise AssertionError("the resumed scan's sensitivity differs from the first run's")
    del params


def phase_fulldepth(torch, work, config, device, launches):
    """Llama-2-7B at its published 32 layers and widths, random bf16 weights
    built on the device from seed 0: pipeline.compress (the suffix scan
    with a scan_resume_path, the search), pipeline.evaluate (windowed PPL
    with the kernels: kernel 1 at M = 1024 through all 32 layers), then
    greedy decode of NEW_TOKENS at DECODE_BATCH through generate_on_device
    and eagerly, in turns, with identical tokens (kernel 1 at M = 4). The
    kernel counts are set to 0 before compress and read after the decode.
    Then the paired suffix/serial timings at full depth, and per-leaf
    resume at 2 layers."""
    from asvd4llm_tpu_torch import pipeline
    from asvd4llm_tpu_torch.export.checkpoint import flatten
    from asvd4llm_tpu_torch.ops import svd

    dev = torch.device(device)
    _sync(torch, dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    (params, spec), build_s = _timed(torch, dev, lambda: _random_model(
        torch, config, config["num_hidden_layers"], dev))
    weight_bytes = sum(t.numel() * t.element_size() for _, t in flatten(params))
    cfg = _fulldepth_cfg(work, "fulldepth", spec.num_layers)
    log(f"full depth: {spec.num_layers} layers, weights {weight_bytes / 1e9:.3f} GB built on "
        f"the device in {build_s:.1f} s; {FULLDEPTH_SIZES}, --param_ratio_target 0.9 "
        f"--rank_align 128 --act_aware, svd_backend {cfg.svd_backend}, scan_resume_path "
        f"{os.path.basename(cfg.scan_resume_path)}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    host_eigh0 = svd.host_eigh_calls
    times, scan_log = {}, []
    reset_kernel_counts()
    t0 = time.perf_counter()
    compressed, manifest, art = pipeline.compress(params, spec, None, cfg, times=times,
                                                  scan_log=scan_log)
    ppl = pipeline.evaluate(compressed, spec, None, cfg, times=times)["synthetic"]
    total = time.perf_counter() - t0
    toks = greedy(torch, {"params": compressed, "spec": spec},
                  main_prompt(spec.vocab_size), latent_kv=False)
    counts, forms = kernel_counts(), form_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log("  phase times (s): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f"; compress + evaluate {total:.1f}")
    for shape, d in sorted(scan_split(scan_log).items()):
        log(f"  scan, {shape[0]}x{shape[1]}: {d['leaves']} leaves, backend "
            f"{'/'.join(sorted(d['backends']))}, SVD {d['svd_s']:.2f} s, evaluation "
            f"{d['eval_s']:.2f} s ({d['candidates']} candidates, "
            f"{1e3 * d['eval_s'] / max(d['candidates'], 1):.1f} ms each)")
    n_cand = sum(r["candidates"] for r in scan_log)
    n_eigh = svd.host_eigh_calls - host_eigh0
    log(f"  scan: {len(scan_log)} leaves, {n_cand} candidates scored, SVD "
        f"{sum(r['svd_s'] for r in scan_log):.2f} s, evaluation "
        f"{sum(r['eval_s'] for r in scan_log):.2f} s; manifest {len(manifest)} low-rank "
        f"leaves; host-eigh rung taken {n_eigh} times; peak device memory above the "
        f"{base / 1e9:.3f} GB held before "
        + ("not measured" if peak is None else
           f"{peak / 1e9:.3f} GB = {peak / weight_bytes:.3f}x the weights' bytes"))
    log(f"  ppl(synthetic, seqlen {cfg.seqlen}) = {ppl!r}; kernel launches: {counts}; "
        f"by form: {forms}; first row's first new tokens {toks[0, -NEW_TOKENS:][:8].tolist()}")
    if not (ppl == ppl and 1.0 < ppl < float("inf")):
        raise AssertionError(f"full depth: PPL {ppl!r} is not a finite value above 1")
    want = spec.num_layers * 7 + 1
    if len(scan_log) != want or not manifest or n_eigh:
        raise AssertionError(f"full depth: {len(scan_log)} of {want} leaves scanned, "
                             f"{len(manifest)} factorized, host eigh {n_eigh}")
    check_forms("full depth", {"fused_lowrank": "wgmma_tiled"}, forms)
    if not forms.get("fused_lowrank", {}).get("mma_skinny"):
        raise AssertionError("full depth: the decode never ran kernel 1's mma_skinny form")
    del compressed, toks
    log("full depth, suffix against serial evaluator (predicted speedup: 1.0x at layer 0, "
        "about 2x at 16, about 20x at 31):")
    paired_evaluators(torch, params, spec, cfg, art, dev)
    del params, art
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    resume_on_card(torch, work, config, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- export

# the main-path models the export phase writes and reads back
EXPORT_RUNS = ("weight target", "KV-cache target", "int8 factors", "int4 factors")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def same_tensors(torch, got, want, label, cast=False):
    """Every tensor of `got` is on `want`'s device and equal to `want`'s, bit
    for bit (with `cast`, after the cast to `want`'s dtype); returns the
    count."""
    from asvd4llm_tpu_torch.export.checkpoint import flatten
    a, b = dict(flatten(got)), dict(flatten(want))
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: tensors {sorted(a.keys() ^ b.keys())[:4]} missing "
                             f"or extra")
    for k, t in b.items():
        g = a[k].to(t.dtype) if cast else a[k]
        if g.device != t.device or g.dtype != t.dtype or not torch.equal(g, t):
            raise AssertionError(f"{label}: {k} differs from the model's ({a[k].dtype} on "
                                 f"{a[k].device} against {t.dtype} on {t.device})")
    return len(b)


def _timed(torch, dev, fn):
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    return out, time.perf_counter() - t0


def decode_reloaded(torch, params, spec, prompt, latent_kv, want, kernel, launches, label):
    """Greedy decode of a reloaded model through generate_on_device with the
    kernel counts set to 0 just before and read just after: its tokens must
    be `want` (when given) and `kernel` must have launched."""
    from asvd4llm_tpu_torch.eval.generate import generate_on_device
    reset_kernel_counts()
    toks = generate_on_device(params, spec, prompt, max_new_tokens=NEW_TOKENS,
                              latent_kv=latent_kv, use_pallas=True)
    counts = kernel_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    _check_tokens(toks, prompt, spec.vocab_size)
    if want is not None and not np.array_equal(toks, want):
        raise AssertionError(f"{label}: the reloaded model decodes other tokens than the "
                             f"model (first row {toks[0, -8:]} against {want[0, -8:]})")
    if counts[kernel] <= 0:
        raise AssertionError(f"{label}: the reloaded model's decode never launched {kernel}")
    log(f"  {label}: generate_on_device (batch {prompt.shape[0]}, {NEW_TOKENS} new) "
        + ("the model's tokens" if want is not None else "valid tokens")
        + f"; {kernel} launched {counts[kernel]} times")


def phase_export(torch, work, sizes, device, models, launches):
    """EXPORT_RUNS' models through both artifacts and back onto the device,
    then the builder once end to end (see the module docstring)."""
    from asvd4llm_tpu_torch.export import build_repo
    from asvd4llm_tpu_torch.export.checkpoint import load_compressed, save_compressed
    from asvd4llm_tpu_torch.export.hf_repo import export_hf_repo
    from asvd4llm_tpu_torch.models.loader import load_model

    ckpt = os.path.join(work, "ckpt")
    with open(os.path.join(ckpt, "config.json")) as f:
        hf_config = json.load(f)
    prompt = main_prompt(hf_config["vocab_size"])
    kernel_of = {run: k for run, _, _, k in MAIN_RUNS}
    latent_of = {run: lat for run, _, lat, _ in MAIN_RUNS}
    dev = torch.device(device)
    for run in EXPORT_RUNS:
        params, spec, toks, ranks = models[run]
        native, repo = os.path.join(work, "export_native"), os.path.join(work, "export_repo")
        log(f"export, {run}: {len(ranks)} factored leaves")
        _, w_native = _timed(torch, dev, lambda: save_compressed(native, params, spec, ranks))
        _, w_repo = _timed(torch, dev, lambda: export_hf_repo(repo, params, spec, ranks,
                                                              hf_config=hf_config))
        (p_native, spec_n, ranks_n), r_native = _timed(
            torch, dev, lambda: load_compressed(native, device=device))
        (p_repo, spec_r, _), r_repo = _timed(
            torch, dev, lambda: load_model(repo, dtype="bfloat16", device=device))
        if spec_n != spec or ranks_n != ranks or spec_r.num_layers != spec.num_layers:
            raise AssertionError(f"export, {run}: spec or ranks changed in the round trip")
        n = same_tensors(torch, p_native, params, f"{run}, native checkpoint")
        same_tensors(torch, p_repo, params, f"{run}, HF repo", cast=True)
        log(f"  native checkpoint: {_dir_bytes(native) / 1e9:.3f} GB on disk, write "
            f"{w_native:.2f} s, read onto {device} {r_native:.2f} s; HF repo (f32): "
            f"{_dir_bytes(repo) / 1e9:.3f} GB, write {w_repo:.2f} s, read {r_repo:.2f} s; "
            f"{n} tensors equal to the model's (the repo's after the cast to bf16)")
        for label, p in (("native checkpoint", p_native), ("HF repo", p_repo)):
            decode_reloaded(torch, p, spec, prompt, latent_of[run], toks, kernel_of[run],
                            launches, f"{run}, {label}")
        del p_native, p_repo
        shutil.rmtree(native)
        shutil.rmtree(repo)

    repo, native = os.path.join(work, "built_repo"), os.path.join(work, "built_native")
    argv = ["--model_id", ckpt, *WEIGHT_TARGET, "--act_aware", "--calib_dataset", "synthetic",
            "--n_calib_samples", str(sizes["n_calib_samples"]), "--seqlen",
            str(sizes["seqlen"]), "--eval_dtype", "bfloat16",
            "--cache_dir", os.path.join(work, "cache"), "--repo_dir", repo,
            "--native_dir", native]
    log(f"export, builder: python -m asvd4llm_tpu_torch.export.build_repo "
        f"{' '.join(argv[2:])}")
    _, secs = _timed(torch, dev, lambda: build_repo.main(argv, device=device))
    (p_native, spec, ranks), _ = _timed(torch, dev, lambda: load_compressed(native,
                                                                           device=device))
    (p_repo, _, _), _ = _timed(torch, dev, lambda: load_model(repo, dtype="bfloat16",
                                                             device=device))
    n = same_tensors(torch, p_repo, p_native, "builder, HF repo against its native checkpoint",
                     cast=True)
    log(f"  builder: {secs:.1f} s; {len(ranks)} factored leaves; repo "
        f"{_dir_bytes(repo) / 1e9:.3f} GB, native {_dir_bytes(native) / 1e9:.3f} GB; "
        f"{n} tensors of the reloaded repo equal the reloaded native checkpoint's")
    if not ranks:
        raise AssertionError("the builder factorized no leaf")
    decode_reloaded(torch, p_repo, spec, prompt, False, None, "fused_lowrank", launches,
                    "builder, HF repo")


# ------------------------------------------------------------------ serve

SERVE_MODELS = ("weight target", "KV-cache target")
SERVE_ENGINE = dict(max_batch=4, num_pages=256, max_pages_per_seq=8)  # automatic page
SERVE_REQUESTS, SERVE_PREFIX = 8, 512
# (run, model, latent, use_pallas, engine options, run(chunk=...), kernel it is for)
SERVE_RUNS = [
    ("dense pools", "weight target", False, True, {}, 1, "paged_dense_attention"),
    ('latent="v", chunked prefill + prefix cache', "KV-cache target", "v", True,
     {"prefill_chunk": 256, "prefix_cache": 4}, 1, "paged_dense_attention"),
    ('latent="kv", run(chunk=8)', "KV-cache target", "kv", True, {}, 8,
     "paged_latent_attention"),
    ('latent="auto"', "KV-cache target", "auto", None, {}, 1, None),
]
# the form a serve run's kernels must take alone (checked as MAIN_FORMS):
# every bf16 serve run launches kernel 5 (dense V, or V-latent in "v") only
# as split_tma, and the "kv" run kernel 6 only as split_wgmma
SERVE_FORMS = {
    "dense pools": {"paged_dense_attention": "split_tma"},
    'latent="v", chunked prefill + prefix cache': {"paged_dense_attention": "split_tma"},
    'latent="kv", run(chunk=8)': {"paged_dense_attention": "split_tma",
                                  "paged_latent_attention": "split_wgmma"},
    'latent="auto"': {"paged_dense_attention": "split_tma"},
}


def serve_traffic(vocab):
    """8 prompts of 64-1024 tokens from a fixed seed, none a whole number of
    pages; requests 3 and 4 share a 512-token prefix (request 3, 1023
    tokens, is the last of the first four to finish its prefill, so its
    prefixes are the newest in the cache when request 4 is admitted at
    request 1's retirement). Budgets 32 tokens, request 1 8 and request 5
    48, so that retirement and admission happen mid-run."""
    rng = np.random.RandomState(7)
    lens = [int(n) + (n % PAGE == 0) for n in rng.randint(64, 1025, SERVE_REQUESTS)]
    prompts = [rng.randint(0, vocab, n) for n in lens]
    prefix = rng.randint(0, vocab, SERVE_PREFIX)
    for i, n in ((3, 1023), (4, max(lens[4], SERVE_PREFIX + 97))):
        prompts[i] = np.concatenate([prefix, rng.randint(0, vocab, n - SERVE_PREFIX)])
    budgets = [32] * SERVE_REQUESTS
    budgets[1], budgets[5] = 8, 48
    return prompts, budgets


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def paged_kernels_at_path_shapes(torch, params, spec, eng):
    """Kernels 5 and 6 against their plain versions on the engine's own
    pools, page table and positions, with a random f32 query (bf16
    tolerance, as in the kernel phase)."""
    from asvd4llm_tpu_torch.models.decoder import attn_scale, rope_cos_sin
    from asvd4llm_tpu_torch.ops import paged_attention as pa

    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    pt, pos = eng._dev(eng.page_table), eng._dev(eng.positions)
    B, MP = pt.shape
    cos, sin = rope_cos_sin(torch.arange(MP * eng.page_size, device=eng.device), hd,
                            spec.rope_theta)
    g = torch.Generator(device=eng.device).manual_seed(4)
    for i, (layer, pools) in enumerate(zip(params["layers"], eng.pools)):
        kind = "latent" if "tk" in pools else "vlatent" if "tv" in pools else "dense"
        q = torch.randn(B, H, hd, generator=g, device=eng.device)
        core, plain, args = paged_kernel_args(torch, pa, kind, q, pools, pt, pos,
                                              layer["k_proj"].get("A"), cos, sin)
        kw = dict(scale=attn_scale(spec), softcap=spec.attn_logit_softcap,
                  sliding=spec.sliding_window if spec.layer_uses_sliding(i) else 0,
                  kv_heads=KV)
        out = core(*args, **kw)
        form = (pa.paged_latent_decode_attention if kind == "latent"
                else pa.paged_dense_decode_attention).last_form
        ref = plain(*args, **kw)
        _sync(torch, eng.device)
        err, _ = max_err(out, ref)
        ok = within(out, ref, 1e-2, 1e-2)
        widths = {k: tuple(v.shape) for k, v in pools.items()}
        log(f"  {'paged_latent' if kind == 'latent' else 'paged_dense'}_attention at layer "
            f"{i} ({kind}, pools {widths}, page table {tuple(pt.shape)}, positions "
            f"{eng.positions.tolist()}, form {form}): max_abs_err {err:.3e} tol=atol 0.01 + "
            f"rtol 0.01 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the paged {kind} kernel disagrees with its plain version "
                                 f"at layer {i}")


def _probe_engine(torch, params, spec, latent, use_pallas, opts, prompts, steps, eager):
    from asvd4llm_tpu_torch.serving import PagedEngine
    eng = PagedEngine(params, spec, latent=latent, use_pallas=use_pallas,
                      dtype=torch.bfloat16, eager_steps=eager, **SERVE_ENGINE, **opts)
    for p in prompts[:SERVE_ENGINE["max_batch"]]:
        eng.add_request(p, max_new_tokens=4 * steps)
    while any(r is not None and not r.decoding for r in eng.slots):
        eng._prefill_tick()
    return eng


def serve_probe(torch, params, spec, latent, use_pallas, opts, prompts, steps=8):
    """A probe engine with the first max_batch prompts prefilled: its first
    paged_decode_step with the kernels against the plain gather path on
    cloned pools (5% of the largest logit, as step_check), the paged kernels
    against their plain versions at its shapes; then the engine step on the
    host clock through the captured graph and, on a second probe engine
    with the same prompts, as eager launches (eager_steps), in turns (graph,
    eager, eager, graph, `steps` // 2 steps each), and a traced window of
    `steps` steps of each. Returns {path: (step ms, device busy ms, idle
    share)}."""
    from asvd4llm_tpu_torch.serving import paged_decode_step
    eng = _probe_engine(torch, params, spec, latent, use_pallas, opts, prompts, steps, False)
    active = [r for r in eng.slots if r is not None]
    eng._grow_pages(active, 1)
    tok, pt, pos = (eng._dev(a) for a in (eng.cur_token, eng.page_table, eng.positions))

    def clone():
        return [{k: v.clone() for k, v in p.items()} for p in eng.pools]
    params = eng.params  # ranks padded to the kernels' multiple, as the pools are
    fused, _ = paged_decode_step(params, spec, tok, clone(), pt, pos, use_pallas=True)
    plain, _ = paged_decode_step(params, spec, tok, clone(), pt, pos, use_pallas=False)
    rows = [r.slot for r in active]
    fused, plain = fused[rows], plain[rows]
    if not bool(torch.isfinite(fused).all()):
        raise AssertionError("paged decode-step logits are not finite")
    err = float((fused - plain).abs().max())
    tol = 0.05 * float(plain.abs().max())
    agree = float((fused.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"  first paged_decode_step (positions {eng.positions.tolist()}, page "
        f"{eng.page_size}), kernels vs gather path: max_abs_err {err:.3e} tol {tol:.3e} "
        f"(5% of max |logit|), argmax agreement {agree:.2f} {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        raise AssertionError("the paged decode step with the kernels disagrees with the "
                             "gather path")
    paged_kernels_at_path_shapes(torch, params, spec, eng)
    engines = {"graph": eng, "eager": _probe_engine(torch, params, spec, latent, use_pallas,
                                                    opts, prompts, steps, True)}
    for e in engines.values():   # the graph engine captures its step here, untimed
        e.step()
    capture_ms = eng._decoder.graphs[1][0].capture_s * 1e3
    host = {"graph": 0.0, "eager": 0.0}
    for path in ("graph", "eager", "eager", "graph"):
        _sync(torch, eng.device)
        t0 = time.perf_counter()
        for _ in range(steps // 2):
            engines[path].step()
        _sync(torch, eng.device)
        host[path] += (time.perf_counter() - t0) * 1e3 / steps
    if [r.tokens for r in engines["graph"].slots] != [r.tokens for r in engines["eager"].slots]:
        raise AssertionError("the probe's graph and eager engine steps emitted other tokens")
    result = {}
    for path, e in engines.items():
        busy, idle = decode_breakdown(torch, lambda: [e.step() for _ in range(steps)], steps,
                                      f"engine {path} step") \
            if eng.device.type == "cuda" else (None, None)
        result[path] = (host[path], busy, idle)
    log(f"  engine decode step (batch {len(active)}, step() with its host work), host "
        f"clock in turns: graph {host['graph']:.3f} ms, eager {host['eager']:.3f} ms; "
        f"identical tokens; capture of the step {capture_ms:.1f} ms (warm-up included)")
    return result


def _serve_traffic_run(torch, params, spec, latent, use_pallas, opts, chunk, prompts, budgets,
                       eager):
    """The 8-request traffic through a fresh engine: (engine, rids, wall s)."""
    from asvd4llm_tpu_torch.serving import PagedEngine
    eng = PagedEngine(params, spec, latent=latent, use_pallas=use_pallas,
                      dtype=torch.bfloat16, eager_steps=eager, **SERVE_ENGINE, **opts)
    _sync(torch, eng.device)
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    eng.run(chunk=chunk)
    _sync(torch, eng.device)
    return eng, rids, time.perf_counter() - t0


def _serve_line(path, eng, n_req, wall, probe):
    st = eng.stats()
    n_tok = st["tokens_generated"]
    step_ms, busy, idle = probe
    return (f"  {path}: {n_req} requests, {n_tok} tokens in {wall:.3f} s: "
            f"{n_tok / wall:.1f} tok/s with prefill; TTFT p50 {st['ttft_s']['p50']:.3f} s "
            f"p90 {st['ttft_s']['p90']:.3f} s; TPOT p50 {st['tpot_s']['p50'] * 1e3:.2f} ms "
            f"p90 {st['tpot_s']['p90'] * 1e3:.2f} ms; phase_s "
            + ", ".join(f"{k} {v:.3f}" for k, v in st["phase_s"].items())
            + f"; engine step {step_ms:.3f} ms, device busy "
            + ("not measured" if busy is None else
               f"{busy:.3f} ms, idle share {1 - busy / step_ms:.3f} on the host clock "
               f"({idle:.3f} in the traced window)"))


def phase_serve(torch, models, launches):
    """The SERVE_RUNS: for each, a probe (first-step and kernel checks,
    engine step time and breakdown through the graph and eagerly), then the
    8-request traffic through the engine's captured graphs (the served
    path) with the kernel counts set to 0 just before it and read just
    after, and the same traffic with eager steps, in turns (graph, eager,
    eager, graph): the four runs must emit the same tokens; every request
    must emit its budget of in-range tokens, and the run's kernel must have
    launched. Agreement with per-request flat generate is logged (bf16
    argmax on random weights ties). Returns {run: counts}."""
    from asvd4llm_tpu_torch.eval.generate import generate
    counts_by_run = {}
    for run, model, latent, use_pallas, opts, chunk, kernel in SERVE_RUNS:
        params, spec = models[model][:2]
        prompts, budgets = serve_traffic(spec.vocab_size)
        log(f"serve, {run}: {model} model, PagedEngine(latent={latent!r}, "
            f"use_pallas={use_pallas}, bf16 pools, automatic page, {SERVE_ENGINE}, "
            f"{opts}), run(chunk={chunk}); prompts {[len(p) for p in prompts]}, "
            f"budgets {budgets}")
        probe = serve_probe(torch, params, spec, latent, use_pallas, opts, prompts)
        args = (torch, params, spec, latent, use_pallas, opts, chunk, prompts, budgets)
        reset_kernel_counts()
        eng, rids, wall = _serve_traffic_run(*args, False)
        counts = kernel_counts()
        forms = form_counts()
        counts_by_run[run] = counts
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        log(f"  engine: latent={eng.latent!r} use_pallas={eng.use_pallas} page_size "
            f"{eng.page_size}, {eng.pools[0][next(iter(eng.pools[0]))].shape[0]} pages, "
            f"pool keys {[sorted(p) for p in eng.pools]}; decode graphs captured (n_steps:"
            f" capture ms) " + ", ".join(f"{n}: {g[0].capture_s * 1e3:.1f}"
                                        for n, g in sorted(eng._decoder.graphs.items())))
        results = [eng.result(r) for r in rids]
        for res, n in zip(results, budgets):
            if len(res) != n or res.min() < 0 or res.max() >= spec.vocab_size:
                raise AssertionError(f"a request emitted {len(res)} tokens of {n}, or "
                                     f"tokens out of range")
        st = eng.stats()
        n_tok = st["tokens_generated"]
        runs = [("graph", eng, wall)]
        for path in ("eager", "eager", "graph"):
            e, r2, w = _serve_traffic_run(*args, path == "eager")
            if [e.result(r).tolist() for r in r2] != [x.tolist() for x in results]:
                raise AssertionError(f"the {path} engine emitted other tokens than the "
                                     f"graph engine")
            runs.append((path, e, w))
        for path, e, w in runs:
            log(_serve_line(path, e, len(rids), w, probe[path]))
        tps = {p: float(np.mean([n_tok / w for q, _, w in runs if q == p]))
               for p in ("graph", "eager")}
        log(f"  in turns graph/eager/eager/graph, identical tokens; mean tok/s with "
            f"prefill graph {tps['graph']:.1f}, eager {tps['eager']:.1f}; prefix tokens "
            f"skipped {st['prefix_tokens_skipped']}")
        log(f"  kernel launches in this run: {counts}; by form: {forms}")
        check_forms(run, SERVE_FORMS.get(run, {}), forms)
        if opts.get("prefix_cache") and st["prefix_tokens_skipped"] <= 0:
            raise AssertionError("the shared prefix was never served from the prefix cache")
        want = kernel or ("paged_latent_attention" if eng.latent == "kv"
                          else "paged_dense_attention")
        if counts[want] <= 0:
            raise AssertionError(f"the serve run {run} never launched the {want} kernel")
        flat_mode = {False: False, "v": "v", "kv": True}[eng.latent]
        same = 0
        for p, res in zip(prompts, results):
            flat = generate(params, spec, p[None], max_new_tokens=len(res),
                            latent_kv=flat_mode, use_pallas=True)[0, len(p):]
            same += int((flat == res).sum())
        log(f"  agreement with per-request flat generate: {same}/{n_tok} tokens "
            f"(logged, not required)")
        del eng, runs
    return counts_by_run


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,main,export,serve,fulldepth")
    ap.add_argument("--workdir", default="",
                    help="checkpoint/cache directory (default: a temporary one)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from asvd4llm_tpu_torch.ops import _build
    secs = _build.build()
    log(f"build: {secs:.1f} s for {', '.join(_build.SOURCES)} (nvcc, sm_90a, parallel)")
    for name, out in _build.build_logs.items():
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {name}: {ln.strip()}")
    for name, kernel, regs, spill in new_form_ptxas(_build.build_logs):
        log(f"  ptxas, new form {kernel} ({name}.cu): {regs}; {spill}")

    timer = Timer(torch)
    record: dict = {}
    launches: dict = {}
    work = args.workdir or tempfile.mkdtemp(prefix="asvd_smoke_")
    try:
        if "kernels" in phases:
            phase_kernels(torch, timer, record)
        if "main" in phases:
            log(f"main path sizes: {MAIN_SIZES}, decode batch {DECODE_BATCH}, "
                f"prompt {PROMPT_LEN}, {NEW_TOKENS} new tokens")
            models = {} if "serve" in phases or "export" in phases else None
            counts = phase_main_path(torch, work, LLAMA2_7B, SMOKE_LAYERS,
                                     MAIN_SIZES, "cuda:0", launches, models)
            for run, _, _, kernel in MAIN_RUNS:
                if kernel and counts[run][kernel] <= 0:
                    raise AssertionError(f"the {run} main path never launched the "
                                         f"{kernel} kernel")
            fisher_full_depth(torch, LLAMA2_7B, "cuda:0")
            if "export" in phases:
                phase_export(torch, work, MAIN_SIZES, "cuda:0", models, launches)
            if "serve" in phases:
                phase_serve(torch, models, launches)
            del models
        elif "serve" in phases or "export" in phases:
            raise ValueError("the serve and export phases need the main phase's models")
        if "fulldepth" in phases:
            phase_fulldepth(torch, work, LLAMA2_7B, "cuda:0", launches)
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name in KERNEL_NAMES:
        if name in record:
            row = dict(record[name])
            row["launches"] = launches.get(name)
            kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
