"""The dense QR engine at the sizes and structures that stress it: the
Hessenberg reduction with and without Q, the real Francis and complex
Givens sweeps, the Schur form with Q, and the triangular eigenvector
back-substitution — all against NumPy/LAPACK in float64.

Reference semantics: reference src/qr_method/to_hessenberg.hpp:23-80
and qr_eigenvalues.hpp:40-108 (shifted+deflated superset per SURVEY §7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pcsc_eigenvalue_solver_project_tpu as es
from pcsc_eigenvalue_solver_project_tpu.solvers.hessenberg import (
    hessenberg_dense, hessenberg_dense_q)
from pcsc_eigenvalue_solver_project_tpu.solvers.qr_eigenvalues import (
    _francis_sweep, _qr_eigenvalues_accel_real, _qr_eigenvalues_accel_schur,
    triangular_eigenvectors)


def _nn_eig_err(ea, eb):
    d = np.abs(np.asarray(ea)[:, None] - np.asarray(eb)[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max()) \
        / max(1.0, np.abs(ea).max())


def _rand(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    if kind == "c":
        a = a + 1j * rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    return a


def _accel(a, tol=1e-6, max_it=None, **kw):
    n = a.shape[0]
    return es.qr_eigenvalues(
        es.DenseMatrix.from_array(a),
        es.QROptions(mode="accelerated", tolerance=tol,
                     max_iterations=max_it or 40 * n + 100, **kw))


def _c(x):
    return np.asarray(x).astype(np.complex128)


# ---------------------------------------------------------------------------
# Hessenberg reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kind", [(33, "r"), (150, "r"), (150, "c"),
                                    (200, "c")])
def test_hessenberg_structure_and_spectrum(n, kind):
    a = _rand(n, kind, seed=7 if n == 200 else 0)
    H = np.asarray(hessenberg_dense(jnp.asarray(a)))
    assert np.abs(np.tril(H, -2)).max() == 0.0  # exact zeros below
    err = _nn_eig_err(np.linalg.eigvals(_c(a)), np.linalg.eigvals(_c(H)))
    assert err < 5e-5 * n


def test_hessenberg_with_q_matches_plain():
    n = 100
    a = jnp.asarray(_rand(n, "r", seed=3))
    pb, _ = hessenberg_dense_q(a)
    pu = hessenberg_dense(a)
    # the same algorithm in two programs: same Hessenberg up to f32 noise
    assert np.abs(np.asarray(pb) - np.asarray(pu)).max() \
        < 5e-4 * max(1, np.abs(np.asarray(pu)).max())


@pytest.mark.parametrize("n,kind,seed", [(150, "r", 5), (150, "c", 0),
                                         (150, "c", 9)])
def test_hessenberg_q_accumulation(n, kind, seed):
    a = _rand(n, kind, seed=seed)
    H, Q = hessenberg_dense_q(jnp.asarray(a))
    H, Q = _c(H), _c(Q)
    assert np.abs(np.tril(H, -2)).max() == 0.0
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() < 1e-5
    assert np.abs(Q @ H @ Q.conj().T - a).max() < 1e-4


def test_hessenberg_q_large_real():
    n = 300
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)).astype(np.float32)
    h_ref = np.asarray(hessenberg_dense(jnp.asarray(a)))
    h, q = hessenberg_dense_q(jnp.asarray(a))
    h, q = np.asarray(h), np.asarray(q)
    assert np.abs(np.tril(h, -2)).max() == 0.0
    assert np.abs(h - h_ref).max() < 1e-2
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-5
    assert np.abs(q @ h @ q.T - a).max() < 1e-4
    err = _nn_eig_err(np.linalg.eigvals(_c(a)), np.linalg.eigvals(_c(h)))
    assert err < 5e-5 * n


def test_non_square_rejected():
    with pytest.raises(ValueError):
        hessenberg_dense(jnp.zeros((4, 3), jnp.float32))
    with pytest.raises(ValueError):
        es.qr_eigenvalues(es.DenseMatrix.from_array(np.zeros((4, 3))),
                          es.QROptions(mode="accelerated"))


def test_real_input_as_complex_stays_real():
    n = 150
    rng = np.random.default_rng(8)
    a = rng.standard_normal((n, n)).astype(np.float32)
    h = np.asarray(hessenberg_dense(jnp.asarray(a.astype(np.complex64))))
    assert np.abs(h.imag).max() < 1e-5          # imaginary part stays zero
    err = _nn_eig_err(np.linalg.eigvals(_c(a)), np.linalg.eigvals(_c(h.real)))
    assert err < 5e-5 * n


# ---------------------------------------------------------------------------
# eigenvalues
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kind", [(4, "r"), (33, "r"), (119, "r"),
                                    (121, "r"), (128, "r"), (129, "r"),
                                    (150, "r"), (150, "c")])
def test_eigenvalues_against_lapack(n, kind):
    a = _rand(n, kind, seed=n if n in (119, 121, 128, 129) else 0)
    r = _accel(a)
    assert bool(r.converged)
    assert _nn_eig_err(np.linalg.eigvals(_c(a)), r.eigenvalues) < 5e-4


def test_trivial_size():
    r = _accel(np.array([[3.5]], np.float32))
    assert bool(r.converged)
    assert abs(complex(np.asarray(r.eigenvalues)[0]) - 3.5) < 1e-6


def test_no_cpu_fallback_any_dtype():
    """Every dtype and mode leaves its result on the default device."""
    dev = jax.devices()[0]
    for dt in (np.float32, np.complex64, np.float64, np.complex128):
        a = np.diag(np.arange(1.0, 9.0)).astype(dt)
        for opts in (es.QROptions(mode="accelerated"),
                     es.QROptions(mode="parity"),
                     es.QROptions(mode="accelerated", compute_vectors=True)):
            r = es.qr_eigenvalues(es.DenseMatrix.from_array(a), opts)
            assert r.eigenvalues.devices() == {dev}


def test_full_rank_spectrum_sweeps_below_2n():
    """Full-rank uniform-[1,2] spectrum (nothing trivially deflatable):
    the double-shift sweeps converge in fewer than the ~2n sweeps a
    single-shift iteration needs."""
    n = 220
    rng = np.random.default_rng(0)
    d = np.sort(rng.uniform(1.0, 2.0, n))[::-1]
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((Qo * d) @ Qo.T).astype(np.float32)
    r = _accel(a, tol=3e-6, max_it=40 * n)
    eigs = np.asarray(r.eigenvalues)
    assert bool(r.converged)
    assert np.abs(np.sort(eigs.real) - np.sort(d)).max() < 1e-4
    assert np.abs(eigs.imag).max() < 1e-4
    assert int(r.iterations) < 2 * n


def test_complex_spectrum():
    n = 150
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64) / np.sqrt(n)
    r = _accel(a, tol=3e-6, max_it=40 * n)
    assert bool(r.converged)
    assert _nn_eig_err(np.linalg.eigvals(_c(a)), r.eigenvalues) < 5e-4


def test_francis_sweep_preserves_spectrum_and_hessenberg():
    """One double-shift sweep is a similarity of the live block:
    eigenvalues unchanged, structure stays Hessenberg."""
    n = 200
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    h = hessenberg_dense(jnp.asarray(a))
    before = np.linalg.eigvals(_c(h))
    h2 = np.asarray(jax.jit(_francis_sweep, static_argnums=(1, 2))(h, 0, n))
    assert np.abs(np.tril(h2, -2)).max() < 1e-5
    assert _nn_eig_err(before, np.linalg.eigvals(_c(h2))) < 5e-5


def test_clustered_spectrum_from_hessenberg_input():
    """Sweep engine on a pre-reduced matrix, mild clustered spectrum."""
    n = 180
    rng = np.random.default_rng(7)
    d = np.concatenate([np.full(30, 2.0) + 1e-3 * rng.standard_normal(30),
                        rng.uniform(0.5, 1.5, n - 30)])
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((Qo * d) @ Qo.T).astype(np.float32)
    planes, sweeps, conv = _qr_eigenvalues_accel_real(
        hessenberg_dense(jnp.asarray(a)), jnp.asarray(40 * n),
        jnp.asarray(3e-6, jnp.float32))
    assert bool(conv)
    got = np.sort(np.asarray(planes)[0])
    assert np.abs(got - np.sort(d)).max() < 5e-4


def test_complex_with_near_conjugate_pairs():
    """A complex matrix close to a real one has eigenvalues in
    near-conjugate pairs; each must come out with its own imaginary
    part."""
    rng = np.random.default_rng(0)
    n = 80
    a = (rng.standard_normal((n, n)) / np.sqrt(n)
         + 0.3j * rng.standard_normal((n, n)) / np.sqrt(n)) \
        .astype(np.complex64)
    r = _accel(a, tol=3e-6, max_it=40 * n)
    assert bool(r.converged)
    eigs = np.asarray(r.eigenvalues)
    ref = np.linalg.eigvals(_c(a))
    assert _nn_eig_err(ref, eigs) < 1e-3
    assert abs(np.sort(eigs.imag) - np.sort(ref.imag)).max() < 1e-3


def test_complex_with_planted_conjugate_pair():
    """Full spectrum of a complex operator WITH a conjugate pair (real
    2x2 block) must match numpy including imaginary-part signs."""
    rng = np.random.default_rng(11)
    n = 160
    a = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64) / np.sqrt(n)
    a[:2, :] = 0
    a[:, :2] = 0
    a[0, 0] = a[1, 1] = 0.5
    a[0, 1], a[1, 0] = 0.8, -0.8
    r = _accel(a, tol=3e-6, max_it=40 * n)
    got = np.asarray(r.eigenvalues)
    assert bool(r.converged)
    assert _nn_eig_err(np.linalg.eigvals(_c(a)), got) < 5e-4
    # the planted pair 0.5 +- 0.8i must appear with BOTH signs
    assert np.abs(got - (0.5 + 0.8j)).min() < 1e-3
    assert np.abs(got - (0.5 - 0.8j)).min() < 1e-3


# ---------------------------------------------------------------------------
# Schur form and eigenvectors
# ---------------------------------------------------------------------------

def test_schur_invariant():
    """The Schur sweeps maintain H = Q T Q^H, T triangular, eigenvalues on
    its diagonal."""
    rng = np.random.default_rng(4)
    n = 180
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    h = hessenberg_dense(jnp.asarray(a.astype(np.complex64)))
    T, Q, sweeps, hi = _qr_eigenvalues_accel_schur(
        h, jnp.asarray(40 * n), jnp.asarray(3e-6, jnp.float32))
    assert int(hi) <= 1
    T, Q, H = _c(T), _c(Q), _c(h)
    assert np.abs(Q @ T @ Q.conj().T - H).max() < 5e-4
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() < 1e-4
    assert np.abs(np.tril(T, -1)).max() < 1e-4
    assert _nn_eig_err(np.linalg.eigvals(_c(a)), np.diagonal(T)) < 5e-4


@pytest.mark.parametrize("kind", ["r", "c"])
def test_eigenvectors_residual(kind):
    n = 150
    a = _rand(n, kind, seed=7)
    r = _accel(a, max_it=40 * n, compute_vectors=True)
    assert bool(r.converged)
    V = _c(r.eigenvectors)
    R = _c(a) @ V - V * _c(r.eigenvalues)[None, :]
    assert np.abs(R).max() < 5e-3


def test_vectors_and_values_paths_agree():
    n = 64
    a = _rand(n, "r", seed=2)
    vals = _accel(a)
    pairs = _accel(a, compute_vectors=True)
    assert _nn_eig_err(vals.eigenvalues, pairs.eigenvalues) < 5e-5


def _residual(T, Y):
    lam = np.diagonal(T).astype(np.complex128)
    nrm = np.maximum(np.linalg.norm(Y, axis=0), 1e-30)
    Yn = Y / nrm
    R = T.astype(np.complex128) @ Yn - Yn * lam[None, :]
    return np.abs(R).max()


@pytest.mark.parametrize("n", [33, 129, 250])
def test_trisolve_complex_residual(n):
    rng = np.random.default_rng(n)
    T = np.triu(rng.standard_normal((n, n))
                + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    T += np.diag(np.linspace(1.0, 3.0, n)).astype(np.complex64)
    eps = np.finfo(np.float32).eps * float(np.abs(T).max())
    Yc = _c(triangular_eigenvectors(jnp.asarray(T), eps))
    assert np.abs(np.tril(Yc, -1)).max() == 0.0   # strictly upper + diag
    # diag entries are the per-column scale: 1, or less for columns the
    # overflow rescaling touched (down to underflow) — always real >= 0
    dg = np.diagonal(Yc)
    assert (dg.real >= 0).all() and np.abs(dg.imag).max() == 0.0
    # relative residual tolerant of the f32 recurrence's growth on a
    # random triangular operand (real Schur factors behave much better)
    assert _residual(T, Yc) < 5e-3


def test_trisolve_realistic_schur_factor():
    """Schur factor of a random matrix (what the pipeline feeds):
    residual at f32-eps scale."""
    n = 180
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)
    w, Vec = np.linalg.eig(A)
    Q, _ = np.linalg.qr(Vec)
    T = np.triu(Q.conj().T @ A @ Q).astype(np.complex64)
    eps = np.finfo(np.float32).eps * float(np.abs(T).max())
    Yc = _c(triangular_eigenvectors(jnp.asarray(T), eps))
    assert _residual(T, Yc) < 5e-6


def test_trisolve_repeated_eigenvalues_clamped():
    """Repeated diagonal entries hit the eps clamp and still produce
    finite, normalizable columns (the LAPACK perturbation trick)."""
    n = 40
    rng = np.random.default_rng(2)
    T = np.triu(0.1 * rng.standard_normal((n, n)), 1).astype(np.complex64)
    T += np.eye(n, dtype=np.complex64) * 2.0    # all eigenvalues equal
    eps = np.finfo(np.float32).eps * 2.0
    Y = np.asarray(triangular_eigenvectors(jnp.asarray(T), eps))
    assert np.isfinite(Y).all()   # rescaling: no f32 overflow
    assert (np.linalg.norm(Y, axis=0) > 0.0).all()


def test_trisolve_matches_numpy_backsubstitution():
    """Device back-substitution against the column-by-column NumPy loop
    in float64."""
    n = 24
    rng = np.random.default_rng(5)
    T = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    Y = np.asarray(triangular_eigenvectors(jnp.asarray(T), 1e-300))
    d = np.diagonal(T)
    for k in range(n):
        y = np.zeros(n, complex)
        y[k] = 1.0
        for i in range(k - 1, -1, -1):
            y[i] = -(T[i, i + 1:k + 1] @ y[i + 1:k + 1]) / (d[i] - d[k])
        np.testing.assert_allclose(Y[:, k], y, rtol=1e-9, atol=1e-12)
