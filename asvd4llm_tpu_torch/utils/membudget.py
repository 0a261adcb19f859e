"""Device-memory planning for the SVD rungs and the scan's candidate chunks.

Counterpart of the part of asvd4llm_tpu/utils/membudget.py that the
sensitivity scan needs (:73-135): ``exact_svd_workspace_bytes``,
``gram_svd_workspace_bytes`` and ``grid_chunk_candidates``. The JAX module
plans against a fixed budget (``HBM_BUDGET = 14.2e9``, a 16 GB chip minus
untracked residency) and sums live arrays; here every check reads the
card's free memory instead: what CUDA reports free
(``torch.cuda.mem_get_info``) plus what PyTorch's caching allocator holds
reserved but unused. On a CPU tensor every workspace fits and the whole
grid is one chunk. The rest of the JAX module (host residency) is not
ported (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import torch

# exact SVD workspace as a multiple of the f32 input bytes (input copy, U,
# Vh and cuSOLVER's scratch). The JAX package plans its QDWH-SVD at 16x;
# torch.linalg.svd's peak on the card is measured by the SVD-rung script
# (asvd4llm_tpu_torch/tools/svd_rungs.py, PERF.md), and this keeps margin
# above it.
EXACT_SVD_WORKSPACE_MULT = 6

# Gram-path peak for an [m, n] f32 matrix: the min^2 Gram and the eigh
# workspace (about 3x min^2) plus the full U and the input copy
_GRAM_EIGH_MULT = 4


def free_device_bytes(device) -> int | None:
    """Bytes a new allocation can take on ``device`` now; None off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + cached)


def exact_svd_workspace_bytes(m: int, n: int) -> int:
    """Planning estimate of torch.linalg.svd's peak for [m, n] f32."""
    return EXACT_SVD_WORKSPACE_MULT * m * n * 4


def gram_svd_workspace_bytes(m: int, n: int) -> int:
    """Planning estimate of the Gram path's peak for [m, n] f32."""
    mn, mx = min(m, n), max(m, n)
    return _GRAM_EIGH_MULT * mn * mn * 4 + 2 * mx * mn * 4


def fits(workspace_bytes: int, device) -> bool:
    """Whether ``workspace_bytes`` fits in the device's free memory now.
    Off CUDA everything fits."""
    free = free_device_bytes(device)
    return free is None or workspace_bytes < free


def exact_svd_fits(m: int, n: int, device) -> bool:
    """Whether an exact f32 SVD of an [m, n] matrix fits right now."""
    return fits(exact_svd_workspace_bytes(m, n), device)


def grid_chunk_candidates(C: int, cand_bytes: int, device, *,
                          temps_mult: int = 4) -> int:
    """How many of a leaf's C dense candidates the scan recomposes and
    evaluates at once. ``temps_mult * cand_bytes`` models one candidate
    and its live temporaries; half the free memory is the planning target,
    as in the JAX package. The whole grid off CUDA."""
    free = free_device_bytes(device)
    if free is None:
        return C
    per = temps_mult * cand_bytes
    return int(max(1, min(C, free * 0.5 // per)))
