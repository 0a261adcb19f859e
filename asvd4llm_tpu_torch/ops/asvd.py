"""Activation-aware SVD factorization (the ASVD core op).

Counterpart of asvd4llm_tpu/ops/asvd.py (ref modules/svd_linear.py:26-103):

- rank: ``int(out*in*ratio) // (in + out)``, ceiled to a multiple of
  ``rank_align`` (ref :39-44);
- activation-aware scaling: ``s = scaling**alpha * fisher**alpha + 1e-6``,
  weight columns scaled by ``s`` before the SVD, B's columns divided by
  ``s`` after (ref :48-70);
- sigma fusion: "UV" splits sqrt(S) into both factors, "U"/"V" fold S into
  one side (ref :16-24);
- factorization in f32, factors cast back to the model dtype (ref :47,102).

On a NaN or a rank of 0 the reference installs a freshly random layer; here,
as in the JAX package, the dense layer is kept (``None`` is returned).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from asvd4llm_tpu_torch.ops.svd import truncated_svd


class LowRankFactors(NamedTuple):
    """Factors of ``w ≈ A @ B`` for a linear ``y = x @ w.T + b``.

    A: [out_features, rank], B: [rank, in_features], bias: [out] or None."""
    A: torch.Tensor
    B: torch.Tensor
    bias: Optional[torch.Tensor]

    @property
    def rank(self) -> int:
        return self.A.shape[1]

    @property
    def out_features(self) -> int:
        return self.A.shape[0]

    @property
    def in_features(self) -> int:
        return self.B.shape[1]

    def n_params(self) -> int:
        return self.A.numel() + self.B.numel()

    def recompose(self) -> torch.Tensor:
        """Dense ``[out, in]`` reconstruction A @ B (float32)."""
        return self.A.float() @ self.B.float()


def rank_for_param_ratio(in_features: int, out_features: int,
                         param_ratio: float, rank_align: int = 1) -> int:
    """Reference rank formula (ref svd_linear.py:39-44)."""
    n_params = in_features * out_features
    compressed_params = int(n_params * param_ratio)
    rank = compressed_params // (in_features + out_features)
    return int(math.ceil(rank / rank_align) * rank_align)


def build_scaling_vector(scaling_diag: Optional[torch.Tensor],
                         fisher_info: Optional[torch.Tensor],
                         alpha: float) -> Optional[torch.Tensor]:
    """``s = scaling**alpha * fisher**alpha + 1e-6`` (ref svd_linear.py:48-59);
    None when both statistics are absent (pure SVD)."""
    if scaling_diag is None and fisher_info is None:
        return None
    s = None
    for stat in (scaling_diag, fisher_info):
        if stat is not None:
            term = stat.float() ** alpha
            s = term if s is None else s * term
    return s + 1e-6


def fuse_sigma(u, s, vh, sigma_fuse: str):
    """Distribute singular values into A=[out,rank], B=[rank,in]
    (ref svd_linear.py:16-24)."""
    if sigma_fuse == "UV":
        sq = torch.sqrt(s)
        return u * sq[None, :], vh * sq[:, None]
    if sigma_fuse == "U":
        return u * s[None, :], vh
    if sigma_fuse == "V":
        return u, vh * s[:, None]
    raise ValueError(f"unknown sigma_fuse {sigma_fuse!r}")


def scaled_svd(w, rank: int, *, scale=None, backend: str = "auto",
               generator=None):
    """Truncated SVD of ``w * scale[None, :]`` with ``1/scale`` folded back
    into Vh's columns: ``w ≈ U diag(S) Vh``, all f32."""
    w32 = w.float()
    if scale is not None:
        w32 = w32 * scale[None, :]
    u, s, vh = truncated_svd(w32, rank, backend=backend, generator=generator)
    if scale is not None:
        vh = vh / scale[None, :]
    return u, s, vh


def factorize_weight(w, rank: int, *, scale=None, sigma_fuse: str = "UV",
                     backend: str = "auto", generator=None):
    """Factorize one ``[out, in]`` weight into f32 (A, B)."""
    u, s, vh = scaled_svd(w, rank, scale=scale, backend=backend,
                          generator=generator)
    return fuse_sigma(u, s, vh, sigma_fuse)


def factorize_linear(w, bias, param_ratio: float, *, act_aware: bool = False,
                     scaling_diag=None, fisher_info=None, alpha: float = 0.5,
                     sigma_fuse: str = "UV", rank_align: int = 1,
                     backend: str = "auto", generator=None,
                     dtype=None) -> Optional[LowRankFactors]:
    """Full ASVD factorization of one linear layer (ref svd_linear.py:26-103).
    Returns None when it is unusable (rank 0 or non-finite factors): the
    caller keeps the dense layer."""
    out_features, in_features = w.shape
    rank = rank_for_param_ratio(in_features, out_features, param_ratio,
                                rank_align)
    if rank <= 0:
        return None
    rank = min(rank, in_features, out_features)
    scale = build_scaling_vector(scaling_diag, fisher_info, alpha) \
        if act_aware else None
    a, b = factorize_weight(w, rank, scale=scale, sigma_fuse=sigma_fuse,
                            backend=backend, generator=generator)
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        return None
    dtype = dtype or w.dtype
    return LowRankFactors(A=a.to(dtype).contiguous(), B=b.to(dtype).contiguous(),
                          bias=None if bias is None else bias.to(dtype))
