"""Truncated SVD backends.

Counterpart of asvd4llm_tpu/ops/svd.py, for one 80 GB card:

- exact: ``torch.linalg.svd`` in f32, then truncate;
- randomized subspace iteration (Halko et al., the family of
  ``torch.svd_lowrank``): GEMMs + thin QR + one small exact SVD, with the
  Gaussian sketch drawn from an explicit ``torch.Generator``.

Both return ``(U, S, Vh)``, ``U: [m, k]``, ``S: [k]``, ``Vh: [k, n]`` with
``w ≈ U @ diag(S) @ Vh``. The JAX package's Gram and host-eigh rungs exist
for a 16 GB chip; on 80 GB the exact workspace of every shape this slice
runs fits, so they wait (ROADMAP queue 1), and a matrix whose exact
workspace does not fit raises instead.
"""

from __future__ import annotations

import torch

# exact SVD workspace as a multiple of the f32 input (input copy, U, Vh and
# the solver's scratch); a conservative bound for cuSOLVER's gesvdj/gesvd
_EXACT_WORKSPACE_MULTIPLE = 6


def exact_svd_fits(m: int, n: int, device) -> bool:
    """Whether an exact f32 SVD of an [m, n] matrix fits in the device
    memory that is free now. Host memory is not checked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(dev)
    return _EXACT_WORKSPACE_MULTIPLE * 4 * m * n < free


def resolve_backend(m: int, n: int, rank: int, backend: str = "auto",
                    device="cpu") -> str:
    """The SVD backend for an [m, n] matrix at ``rank``.

    "auto" keeps the JAX package's shape rule (exact for small matrices or
    ranks of at least half the spectrum, randomized otherwise; its 0.5
    boundary was measured on a TPU and is not re-measured on the card yet).
    The memory check is this card's: the exact workspace must fit in free
    device memory, else this raises (the Gram rung waits, ROADMAP queue 1)."""
    if backend == "auto":
        small = (m * n <= 1024 * 1024) or (rank >= 0.5 * min(m, n))
        backend = "exact" if small else "randomized"
    if backend == "exact" and not exact_svd_fits(m, n, device):
        raise NotImplementedError(
            f"exact SVD of a {m}x{n} matrix does not fit in free device "
            "memory; the Gram SVD rung is still to port (ROADMAP queue 1)")
    return backend


def _exact_svd(w: torch.Tensor):
    u, s, vh = torch.linalg.svd(w.float(), full_matrices=False)
    return u, s, vh


def randomized_svd(w: torch.Tensor, rank: int, *,
                   generator: torch.Generator | None = None, niter: int = 8):
    """Randomized truncated SVD via subspace (power) iteration: a sketch on
    the short side, ``niter`` power iterations with QR re-orthogonalization,
    and an exact SVD of the small projected matrix."""
    w = w.float()
    m, n = w.shape
    transposed = m < n
    a = w.t() if transposed else w  # a: [M, N] with M >= N
    M, N = a.shape
    q = min(rank + 8, N, M)  # oversample, clamped to the small dimension

    omega = torch.randn((N, q), generator=generator, dtype=torch.float32,
                        device=w.device)
    qmat, _ = torch.linalg.qr(a @ omega)
    for _ in range(niter):
        zq, _ = torch.linalg.qr(a.t() @ qmat)
        qmat, _ = torch.linalg.qr(a @ zq)
    ub, s, vh = torch.linalg.svd(qmat.t() @ a, full_matrices=False)
    u = qmat @ ub
    u, s, vh = u[:, :rank], s[:rank], vh[:rank, :]
    if transposed:
        return vh.t(), s, u.t()
    return u, s, vh


def truncated_svd(w: torch.Tensor, rank: int, *, backend: str = "auto",
                  generator: torch.Generator | None = None, niter: int = 8):
    """Dispatch between the exact and randomized truncated SVD. The exact
    path always decomposes at full rank and slices, as the JAX package's
    does; the randomized path rounds its subspace up to a 256 multiple
    (extra subspace only improves accuracy)."""
    m, n = w.shape
    rank = int(min(rank, m, n))
    if not bool(torch.isfinite(w).all()):
        # torch's solvers raise on NaN/inf where the JAX package's return
        # NaN factors; keep the latter so callers fall back to dense
        nan = float("nan")
        return (w.new_full((m, rank), nan, dtype=torch.float32),
                w.new_full((rank,), nan, dtype=torch.float32),
                w.new_full((rank, n), nan, dtype=torch.float32))
    backend = resolve_backend(m, n, rank, backend, w.device)
    if backend == "exact":
        u, s, vh = _exact_svd(w)
        return u[:, :rank], s[:rank], vh[:rank, :]
    if backend == "randomized":
        rank_b = min(-(-rank // 256) * 256, m, n)
        u, s, vh = randomized_svd(w, rank_b, generator=generator, niter=niter)
        return u[:, :rank], s[:rank], vh[:rank, :]
    if backend == "gram":
        raise NotImplementedError(
            "the Gram SVD backend is still to port (ROADMAP queue 1)")
    raise ValueError(f"unknown svd backend {backend!r}")


def singular_values(w: torch.Tensor) -> torch.Tensor:
    """All singular values (no U/V), for the stable-rank sensitivity proxy
    (ref sensitivity.py:101)."""
    return torch.linalg.svdvals(w.float())
