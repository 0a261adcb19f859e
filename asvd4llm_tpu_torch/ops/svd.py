"""Truncated SVD backends.

Counterpart of asvd4llm_tpu/ops/svd.py, for one 80 GB card:

- exact: ``torch.linalg.svd`` in f32, then truncate; a very tall or wide
  matrix (the 32000x4096 lm_head) takes the Gram rung inside it, as the
  JAX package's exact path does (:246-255);
- randomized subspace iteration (Halko et al., the family of
  ``torch.svd_lowrank``): GEMMs + thin QR + one small exact SVD, with the
  Gaussian sketch drawn from an explicit ``torch.Generator``;
- gram (:25-55): the [min, min] Gram matrix and its eigendecomposition,
  O(min^2) workspace; "auto" takes it above 1M entries (measured on the
  card, ``auto_backend``), and exact falls to it where its workspace does
  not fit the card's free memory (``resolve_backend``, JAX :217-236);
- the scan's low-memory Gram forms (:58-200): ``gram_truncated_svd_lowmem``
  accumulates the Gram of ``w * scale`` over row blocks of the resident
  weight and back-multiplies only the kept eigenvectors, and
  ``gram_truncated_svd_host_eigh``, the last rung of the scan's OOM
  ladder, runs the eigendecomposition on the host (``host_eigh_calls``
  counts it).

All return ``(U, S, Vh)``, ``U: [m, k]``, ``S: [k]``, ``Vh: [k, n]`` with
``w ≈ U @ diag(S) @ Vh``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from asvd4llm_tpu_torch.utils.membudget import exact_svd_fits

log = logging.getLogger(__name__)

# times gram_truncated_svd_host_eigh ran in this process
host_eigh_calls = 0

# the row/column block of the low-memory Gram forms (JAX :59)
GRAM_BLOCK = 1376


def _gram_truncated_svd(w: torch.Tensor, rank: int):
    """Truncated SVD of an f32 [m, n] matrix, m >= n, through the [n, n]
    Gram eigendecomposition. Squares the condition number: singular values
    below about sqrt(eps)*s_max lose precision, which a truncation that
    drops them does not see."""
    c = w.t() @ w
    s2, v = torch.linalg.eigh(c)                 # ascending
    s2, v = s2.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    u = (w @ v) / torch.clamp(s, min=1e-12)[None, :]
    return u[:, :rank], s[:rank], v.t()[:rank, :]


def _gram_svd_full(w: torch.Tensor):
    """Full min-dim factorization through the Gram path, either
    orientation."""
    w = w.float()
    m, n = w.shape
    if m >= n:
        return _gram_truncated_svd(w, n)
    u, s, vh = _gram_truncated_svd(w.t(), m)
    return vh.t(), s, u.t()


def _scaled_block(w, scale, i0, sz, dim):
    """One f32 block of ``w * scale[None, :]``: rows (dim 0) or columns
    (dim 1) i0..i0+sz of the resident weight."""
    if dim == 0:
        return w[i0:i0 + sz].float() * scale[None, :]
    return w[:, i0:i0 + sz].float() * scale[i0:i0 + sz][None, :]


def _gram_blocked(w, scale, block: int = GRAM_BLOCK):
    """f32 Gram of ``w * scale[None, :]`` accumulated over blocks of the
    resident weight, never holding the f32 scaled matrix. Tall:
    (ws)^T (ws); wide: (ws)(ws)^T."""
    m, n = w.shape
    k = min(m, n)
    c = torch.zeros((k, k), dtype=torch.float32, device=w.device)
    if m >= n:
        for i0 in range(0, m, block):
            blk = _scaled_block(w, scale, i0, min(block, m - i0), 0)
            c += blk.t() @ blk
    else:
        for j0 in range(0, n, block):
            blk = _scaled_block(w, scale, j0, min(block, n - j0), 1)
            c += blk @ blk.t()
    return c


def _blocked_right_mul(w, scale, v_r, block: int = GRAM_BLOCK):
    """(w * scale) @ v_r over row blocks -> [m, rank] f32."""
    m = w.shape[0]
    return torch.cat([_scaled_block(w, scale, i0, min(block, m - i0), 0) @ v_r
                      for i0 in range(0, m, block)], dim=0)


def _blocked_left_mul(w, scale, u_r, block: int = GRAM_BLOCK):
    """u_r^T @ (w * scale) over column blocks -> [rank, n] f32."""
    n = w.shape[1]
    return torch.cat([u_r.t() @ _scaled_block(w, scale, j0, min(block, n - j0), 1)
                      for j0 in range(0, n, block)], dim=1)


def _back_multiply(w, scale, s2, v, rank, block):
    """(u, s, vh) of ``w * scale`` at ``rank`` from the ascending
    eigenpairs (s2, v) of its Gram matrix."""
    s = torch.sqrt(torch.clamp(s2.flip(0)[:rank], min=0.0))
    v_r = v.flip(1)[:, :rank].contiguous()
    inv_s = 1.0 / torch.clamp(s, min=1e-12)
    if w.shape[0] >= w.shape[1]:
        u = _blocked_right_mul(w, scale, v_r, block) * inv_s[None, :]
        return u, s, v_r.t()
    # wide: the eigenvectors are the LEFT singular vectors
    vh = _blocked_left_mul(w, scale, v_r, block) * inv_s[:, None]
    return v_r, s, vh


def gram_truncated_svd_lowmem(w: torch.Tensor, scale: torch.Tensor, rank: int,
                              block: int = GRAM_BLOCK):
    """Rank-sliced, blocked Gram SVD of ``w * scale[None, :]``: the f32
    scaled matrix and the full-width u are never held (JAX :58-118). The
    blocked sum reassociates the Gram's adds against the one-GEMM form
    (about 1e-7 relative); eigh and the truncation are the same. Returns
    the factors of the SCALED matrix."""
    s2, v = torch.linalg.eigh(_gram_blocked(w, scale, block))
    return _back_multiply(w, scale, s2, v, rank, block)


def gram_truncated_svd_host_eigh(w: torch.Tensor, scale: torch.Tensor,
                                 rank: int, block: int = GRAM_BLOCK):
    """The last rung (JAX :172-199): the blocked Gram and the rank-sliced
    back-multiply stay on the device, the eigendecomposition runs on the
    host in f32 (numpy's ssyevd), so the device never holds an eigh
    workspace. Slow; counted in ``host_eigh_calls`` and logged."""
    global host_eigh_calls
    host_eigh_calls += 1
    log.warning("gram SVD of a %dx%d matrix with the eigendecomposition on "
                "the host (call %d)", w.shape[0], w.shape[1], host_eigh_calls)
    c = _gram_blocked(w, scale, block).cpu().numpy()
    s2, v = np.linalg.eigh(c)                     # f32, ascending
    dev = w.device
    return _back_multiply(w, scale, torch.from_numpy(s2).to(dev),
                          torch.from_numpy(np.ascontiguousarray(v)).to(dev),
                          rank, block)


def auto_backend(m: int, n: int, rank: int) -> str:
    """The "auto" rule, measured on the card: exact for matrices of at
    most 1M entries (the JAX package's small-matrix branch, JAX :227, so
    every small matrix resolves as it does there), the Gram path above.

    On an H100 the Gram path factored every Llama-2-7B leaf shape about
    10x faster than ``torch.linalg.svd`` and 2-15x faster than randomized
    subspace iteration at the scan's ranks, with a reconstruction error
    within 5e-6 relative of exact's (PERF.md, SVD rungs;
    ``tools/svd_rungs.py``). The JAX package's 0.5·min(m, n) boundary
    between exact and randomized was measured on a TPU; on the card it
    sent every MLP leaf at ratio 0.9 to the slowest rung. Ranks below
    0.4 of the grid were not measured: the scan and the search factor at
    a grid's largest rank."""
    return "exact" if m * n <= 1024 * 1024 else "gram"


def resolve_backend(m: int, n: int, rank: int, backend: str = "auto",
                    device="cpu") -> str:
    """The SVD backend for an [m, n] matrix at ``rank``: the "auto" rule,
    then exact falls to the Gram path when its workspace does not fit
    the card's free memory (JAX :229-235 against its HBM budget)."""
    if backend == "auto":
        backend = auto_backend(m, n, rank)
    if backend == "exact" and not exact_svd_fits(m, n, device):
        backend = "gram"
    return backend


def _exact_svd(w: torch.Tensor):
    """Full f32 factorization; very tall or wide matrices (the 32000 x 4096
    head) through the Gram rung, as JAX's exact path sends them (:246-255)."""
    m, n = w.shape
    if max(m, n) >= 4 * min(m, n) and max(m, n) >= 16384:
        return _gram_svd_full(w)
    return torch.linalg.svd(w.float(), full_matrices=False)


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
    """Dispatch between the exact, randomized and Gram truncated SVD. The
    exact and Gram paths decompose at full rank and slice, as the JAX
    package's do; the randomized path rounds its subspace up to a 256
    multiple (extra subspace only improves accuracy)."""
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
    if backend in ("exact", "gram"):
        u, s, vh = _exact_svd(w) if backend == "exact" else _gram_svd_full(w)
        return u[:, :rank], s[:rank], vh[:rank, :]
    if backend == "randomized":
        rank_b = min(-(-rank // 256) * 256, m, n)
        u, s, vh = randomized_svd(w, rank_b, generator=generator, niter=niter)
        return u[:, :rank], s[:rank], vh[:rank, :]
    raise ValueError(f"unknown svd backend {backend!r}")


def singular_values(w: torch.Tensor) -> torch.Tensor:
    """All singular values (no U/V), for the stable-rank sensitivity proxy
    (ref sensitivity.py:101)."""
    return torch.linalg.svdvals(w.float())
