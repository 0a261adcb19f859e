"""PyTorch port vs JAX package: the Gram SVD rungs, the exact path's
routing of very tall or wide matrices, the card's "auto" rule and the
memory planning behind the rungs, in float32 on the CPU.

Singular vectors carry a sign the solver picks, so factors are compared
through S and the rank-r recomposition U S Vh. Tolerance rtol 1e-4 on
well-conditioned spectra, where two eigh solvers agree; below
sqrt(eps)*s_max the Gram tail is solver noise in either package.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu.ops import svd as jsvd  # noqa: E402
from asvd4llm_tpu.utils import membudget as jmb  # noqa: E402
from asvd4llm_tpu_torch.ops import svd as tsvd  # noqa: E402
from asvd4llm_tpu_torch.utils import membudget as tmb  # noqa: E402


def _spectrum_matrix(m, n, lo, seed=0):
    """[m, n] f32 with singular values log-spaced from 1 to ``lo``."""
    rng = np.random.RandomState(seed)
    k = min(m, n)
    u0, _ = np.linalg.qr(rng.randn(m, k))
    v0, _ = np.linalg.qr(rng.randn(n, k))
    return ((u0 * np.logspace(0, np.log10(lo), k)) @ v0.T).astype(np.float32)


def _rec(u, s, vh):
    return np.asarray((np.asarray(u) * np.asarray(s)[None, :]) @ np.asarray(vh))


def _assert_close(got, ref, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), rtol=rtol)
    rg, rr = _rec(*got), _rec(*ref)
    np.testing.assert_allclose(rg, rr, rtol=rtol, atol=rtol * np.abs(rr).max())


def test_exact_routes_very_tall_matrices_to_gram():
    """At [16384, 64] the port's exact path gives the bits of its own Gram
    rung, as JAX's exact path does (JAX ops/svd.py:251): on a 1..1e-6
    spectrum, where exact and Gram part by up to 3x on the tail."""
    w = torch.from_numpy(_spectrum_matrix(16384, 64, 1e-6))
    ex = tsvd.truncated_svd(w, 48, backend="exact")
    gr = tsvd.truncated_svd(w, 48, backend="gram")
    for a, b in zip(ex, gr):
        assert torch.equal(a, b)
    direct = torch.linalg.svd(w, full_matrices=False)[1][:48]
    assert float((ex[1][40:] / direct[40:]).max()) > 1.1  # the tail differs
    # and the same for the wide orientation
    ex_t = tsvd.truncated_svd(w.t().contiguous(), 48, backend="exact")
    np.testing.assert_array_equal(ex_t[1].numpy(), ex[1].numpy())


@pytest.mark.parametrize("shape", [(16384, 64), (64, 16384)])
def test_tall_exact_matches_jax(shape):
    """The head-like shape through both packages' exact path, on a 1..1e-2
    spectrum, where f32 Gram is accurate."""
    w = _spectrum_matrix(*shape, 1e-2, seed=1)
    _assert_close(tsvd.truncated_svd(torch.from_numpy(w), 48, backend="exact"),
                  jsvd.truncated_svd(jnp.asarray(w), 48, backend="exact"))


@pytest.mark.parametrize("shape", [(96, 40), (40, 96)])
def test_gram_svd_full_matches_jax(shape):
    """The full factorization, every rank up to min(m, n): a 1..1e-1
    spectrum keeps its smallest value clear of the Gram floor."""
    w = _spectrum_matrix(*shape, 1e-1, seed=2)
    got = tsvd._gram_svd_full(torch.from_numpy(w))
    ref = jsvd._gram_svd_full(jnp.asarray(w))
    for r in (8, 24, min(shape)):
        _assert_close([got[0][:, :r], got[1][:r], got[2][:r]],
                      [ref[0][:, :r], ref[1][:r], ref[2][:r]])
    t = tsvd.truncated_svd(torch.from_numpy(w), 24, backend="gram")
    _assert_close(t, jsvd.truncated_svd(jnp.asarray(w), 24, backend="gram"))


def _scaled_case(shape, seed):
    w = _spectrum_matrix(*shape, 1e-2, seed=seed)
    scale = (np.abs(np.random.RandomState(seed + 1).randn(shape[1])) + 0.5
             ).astype(np.float32)
    return w, scale


@pytest.mark.parametrize("shape", [(688, 256), (256, 688)])
def test_gram_lowmem_and_host_eigh_match_jax(shape):
    """The scan's blocked Gram forms on ``w * scale`` (blocks of 100 rows
    or columns), on the device and with the eigendecomposition on the host,
    against JAX's; the host rung counts its calls."""
    w, scale = _scaled_case(shape, 3)
    tw, ts = torch.from_numpy(w), torch.from_numpy(scale)
    jw, js = jnp.asarray(w), jnp.asarray(scale)
    low = tsvd.gram_truncated_svd_lowmem(tw, ts, 96, block=100)
    assert low[0].shape == (shape[0], 96) and low[2].shape == (96, shape[1])
    _assert_close(low, jsvd.gram_truncated_svd_lowmem(jw, js, 96, block=100))
    before = tsvd.host_eigh_calls
    host = tsvd.gram_truncated_svd_host_eigh(tw, ts, 96, block=100)
    assert tsvd.host_eigh_calls == before + 1
    _assert_close(host, jsvd.gram_truncated_svd_host_eigh(jw, js, 96, block=100))
    # the blocked forms against the one-GEMM Gram of the scaled matrix
    full = tsvd._gram_svd_full(tw * ts[None, :])
    _assert_close(low, [full[0][:, :96], full[1][:96], full[2][:96]])


def test_gram_error_bound():
    """The bound the JAX tests pin on its Gram rung
    (tests/test_asvd_math.py::test_gram_truncated_svd_error_bound): on a
    1/k spectrum, singular values within 1e-3 and the rank-r residual within
    1% of optimal."""
    rng = np.random.RandomState(13)
    u0, _ = np.linalg.qr(rng.randn(512, 64))
    v0, _ = np.linalg.qr(rng.randn(64, 64))
    s_true = np.arange(1, 65, dtype=np.float64) ** -1.0
    w = torch.from_numpy(((u0 * s_true) @ v0.T).astype(np.float32))
    u, s, vh = tsvd.truncated_svd(w, 24, backend="gram")
    np.testing.assert_allclose(s.numpy(), s_true[:24], rtol=1e-3)
    resid = float(torch.linalg.norm(w - (u * s[None, :]) @ vh))
    assert resid <= np.sqrt(np.sum(s_true[24:] ** 2)) * 1.01


@pytest.mark.parametrize("m,n,rank,want", [
    # at most 1M entries: exact at every rank, as in JAX
    (96, 40, 8, "exact"), (1024, 1024, 10, "exact"), (2048, 512, 500, "exact"),
    (16384, 64, 48, "exact"),
    # above: the Gram path at the Llama-2-7B leaves the card measured
    (4096, 4096, 1920, "gram"), (4096, 4096, 819, "gram"), (11008, 4096, 2688, "gram"),
    (4096, 11008, 1194, "gram"), (32000, 4096, 3268, "gram"), (1025, 1024, 10, "gram"),
])
def test_auto_rule_decisions(m, n, rank, want):
    assert tsvd.auto_backend(m, n, rank) == want
    assert tsvd.resolve_backend(m, n, rank, "auto", "cpu") == want
    if m * n <= 1024 * 1024:
        assert jsvd.resolve_backend(m, n, rank, "auto") == want


def test_exact_falls_to_gram_when_its_workspace_does_not_fit(monkeypatch):
    """Exact becomes Gram when the card's free memory cannot hold its
    workspace (JAX :229-235 against its HBM budget); the CPU always fits."""
    assert tsvd.resolve_backend(4096, 4096, 1920, "exact", "cpu") == "exact"
    free = {"bytes": 10 * 2 ** 30}
    monkeypatch.setattr(tmb, "free_device_bytes", lambda device: free["bytes"])
    assert tsvd.resolve_backend(4096, 4096, 1920, "exact", "cuda:0") == "exact"
    free["bytes"] = tmb.exact_svd_workspace_bytes(4096, 4096) - 1
    assert tsvd.resolve_backend(4096, 4096, 1920, "exact", "cuda:0") == "gram"
    assert tsvd.resolve_backend(64, 64, 8, "randomized", "cuda:0") == "randomized"


def test_membudget_planning(monkeypatch):
    """The Gram workspace is JAX's formula; the scan's chunk of candidates
    is the whole grid on the CPU and half the free memory over four
    candidates' bytes on the card."""
    for m, n in [(11008, 4096), (4096, 11008), (32000, 4096)]:
        assert tmb.gram_svd_workspace_bytes(m, n) == jmb.gram_svd_workspace_bytes(m, n)
    assert tmb.free_device_bytes("cpu") is None and tmb.fits(10 ** 15, "cpu")
    assert tmb.grid_chunk_candidates(19, 10 ** 12, "cpu") == 19
    monkeypatch.setattr(tmb, "free_device_bytes", lambda device: 8 * 90 * 2 ** 20)
    assert tmb.grid_chunk_candidates(6, 90 * 2 ** 20, "cuda:0") == 1
    assert tmb.grid_chunk_candidates(6, 10 * 2 ** 20, "cuda:0") == 6
    assert tmb.grid_chunk_candidates(19, 20 * 2 ** 20, "cuda:0") == 4
