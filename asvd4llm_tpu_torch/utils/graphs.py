"""One decode step captured as a CUDA graph and replayed.

The JAX package jits its decode loops (eval/generate.py::_decode_while,
serving/paged.py::paged_decode_scan), so a whole generation is one
dispatch. PyTorch runs eagerly, and a step of some hundred small launches
pays the host's cost for each of them; captured once into a CUDA graph, the
step is one graph launch, and n replays decode n tokens with no host round
trip in between.

A step here is a function of no arguments that reads and advances static
tensors: its token, position(s), step counter and output buffer. A graph
replays the same launches on the same addresses, so everything that changes
from one step to the next must live in such a tensor, never in a Python
value, and no launch of the step may read a device value on the host.

On a CPU tensor, or with ``eager`` (measurements only, as ``form=`` on the
kernel wrappers), ``StepGraph`` runs the step eagerly on every replay, so
the CPU tests run the code that the card replays.
"""

from __future__ import annotations

import gc
import time

import torch


def counted_kernels() -> dict:
    """The wrapper of each hand-written kernel, by kernel name; each counts
    its launches in ``launches`` and ``form_launches``."""
    from asvd4llm_tpu_torch.ops import fused_lowrank as fl
    from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq
    from asvd4llm_tpu_torch.ops import latent_attention as la
    from asvd4llm_tpu_torch.ops import paged_attention as pa
    return {"fused_lowrank": fl.fused_lowrank_apply,
            "latent_attention": la.latent_decode_attention,
            "fused_lowrank_q8": fq.fused_lowrank_apply_q8,
            "fused_lowrank_q4": fq.fused_lowrank_apply_q4,
            "paged_dense_attention": pa.paged_dense_decode_attention,
            "paged_latent_attention": pa.paged_latent_decode_attention}


def _counts() -> dict:
    return {name: (fn.launches, dict(fn.form_launches))
            for name, fn in counted_kernels().items()}


class StepGraph:
    """``step`` captured once and replayed.

    On a CUDA device the constructor runs ``step`` once eagerly on a side
    stream (this builds every kernel library, sets each kernel's shared
    memory attribute and looks up the tensor-map encoder, none of which may
    happen during a capture), puts the ``state`` tensors back as they were,
    then captures one step in the default (global) error mode, with the
    cyclic garbage collector off. A failed
    capture raises; nothing falls back to eager steps. The warm-up writes
    the caches at the step's position, which the first replay writes again
    with the same values.

    The kernel wrappers count their launches in Python, which a replay does
    not run: the launches the capture made are taken back from the counts
    and added once per replay (``per_replay``).
    """

    def __init__(self, step, state, *, eager: bool = False):
        self.step = step
        self.graph = None
        self.per_replay: dict = {}
        self.capture_s = 0.0
        if state[0].device.type == "cuda" and not eager:
            self._capture(state)

    def _capture(self, state):
        t0 = time.perf_counter()
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector stays off during the capture: a step closure
        # and the decoder that holds its graph form a cycle, and a dead one
        # collected inside the capture would destroy its graph there
        # (cudaGraphExecDestroy), which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.step()
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        for name, fn in counted_kernels().items():
            n0, forms0 = before[name]
            n1, forms1 = after[name]
            forms = {f: k - forms0.get(f, 0) for f, k in forms1.items()
                     if k != forms0.get(f, 0)}
            if n1 != n0 or forms:
                self.per_replay[name] = (n1 - n0, forms)
            fn.launches, fn.form_launches = n0, forms0
        torch.cuda.synchronize()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replay(self, n: int = 1):
        """n steps: n graph launches, or n eager calls of the step."""
        if self.graph is None:
            for _ in range(n):
                self.step()
            return
        for _ in range(n):
            self.graph.replay()
        kernels = counted_kernels()
        for name, (launches, forms) in self.per_replay.items():
            fn = kernels[name]
            fn.launches += n * launches
            for f, k in forms.items():
                fn.form_launches[f] = fn.form_launches.get(f, 0) + n * k
