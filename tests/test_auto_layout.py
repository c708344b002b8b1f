"""Automatic layout selection (matrix/auto.py) — the runtime-dispatch
spirit of the reference (power_method.hpp:141-147) at the layer where it
matters here: between sparse layouts."""

import numpy as np
import jax.numpy as jnp
import pytest

import pcsc_eigenvalue_solver_project_tpu as es
from pcsc_eigenvalue_solver_project_tpu.matrix.auto import (
    LayoutDecision, PermutedOperator, from_coo, suggest_layout)
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import InterleavedDIA
from pcsc_eigenvalue_solver_project_tpu.matrix.gell import SparseGELL


def _banded_coo(n, bw, rng, shuffle=None):
    i = np.repeat(np.arange(n), 2 * bw + 1)
    off = np.tile(np.arange(-bw, bw + 1), n)
    j = i + off
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    v = rng.standard_normal(len(i)).astype(np.float32)
    if shuffle is not None:
        i, j = shuffle[i], shuffle[j]
    return i, j, v


def _dense_of(i, j, v, n):
    d = np.zeros((n, n), np.float64)
    np.add.at(d, (i, j), v)
    return d


class TestDecisionRule:
    def test_banded_picks_dia(self):
        rng = np.random.default_rng(0)
        n = 2048
        i, j, v = _banded_coo(n, 8, rng)
        dec = suggest_layout(i, j, v, (n, n))
        assert dec.kind == "dia_il" and dec.perm is None
        assert dec.stats["n_diagonals"] == 17

    def test_uniform_random_picks_gell_unpermuted(self):
        rng = np.random.default_rng(1)
        n = 4096
        i = np.repeat(np.arange(n), 6)
        j = rng.integers(0, n, 6 * n)
        v = rng.standard_normal(6 * n).astype(np.float32)
        dec = suggest_layout(i, j, v, (n, n))
        assert dec.kind == "gell" and dec.perm is None
        # irreducible: RCM must not have claimed a meaningful cut
        assert dec.stats["chunks_per_tile_rcm"] >= \
            0.75 * dec.stats["chunks_per_tile"]

    def test_shuffled_banded_recovered_by_rcm(self):
        """A banded matrix with scrambled vertex labels looks uniform;
        the RCM probe must recover the banded structure and pick the
        permuted DIA fast path."""
        rng = np.random.default_rng(2)
        n = 2048
        shuffle = rng.permutation(n)
        i, j, v = _banded_coo(n, 4, rng, shuffle=shuffle)
        raw = suggest_layout(i, j, v, (n, n), try_rcm=False)
        assert raw.kind == "gell"          # looks unstructured without RCM
        dec = suggest_layout(i, j, v, (n, n))
        assert dec.kind == "dia_il" and dec.perm is not None
        assert dec.stats["n_diagonals_rcm"] <= 32

    def test_local_pattern_stays_gell(self):
        rng = np.random.default_rng(3)
        n = 65536
        i = np.repeat(np.arange(n), 4)
        j = (i + rng.integers(-8192, 8193, 4 * n)) % n
        v = rng.standard_normal(4 * n).astype(np.float32)
        dec = suggest_layout(i, j, v, (n, n))
        assert dec.kind == "gell"


class TestFromCoo:
    def test_kinds_and_matvec(self):
        rng = np.random.default_rng(4)
        n = 1024
        i, j, v = _banded_coo(n, 3, rng)
        m = from_coo(i, j, v, (n, n), layout="auto")
        assert isinstance(m, InterleavedDIA)
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(m.decode_vec(m.matvec(m.encode_vec(jnp.asarray(x)))))
        np.testing.assert_allclose(y, _dense_of(i, j, v, n) @ x, rtol=2e-5,
                                   atol=1e-4)

    def test_permuted_operator_matvec_and_diagonal(self):
        rng = np.random.default_rng(5)
        n = 1024
        shuffle = rng.permutation(n)
        i, j, v = _banded_coo(n, 3, rng, shuffle=shuffle)
        m = from_coo(i, j, v, (n, n), layout="auto")
        assert isinstance(m, PermutedOperator)
        assert isinstance(m.inner, InterleavedDIA)
        d = _dense_of(i, j, v, n)
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(m.decode_vec(m.matvec(m.encode_vec(jnp.asarray(x)))))
        np.testing.assert_allclose(y, d @ x, rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.diagonal()), np.diag(d),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(m.to_dense()), d, rtol=1e-6,
                                   atol=1e-6)

    def test_explicit_layouts_and_errors(self):
        rng = np.random.default_rng(6)
        n = 256
        i, j, v = _banded_coo(n, 2, rng)
        assert isinstance(from_coo(i, j, v, (n, n), layout="gell"),
                          SparseGELL)
        assert isinstance(from_coo(i, j, v, (n, n), layout="dia_il"),
                          InterleavedDIA)
        with pytest.raises(ValueError):
            from_coo(i, j, v, (n, n), layout="nope")
        with pytest.raises(ValueError):
            from_coo([0], [0], [1.0], (2, 3), layout="dia_il")

    def test_rectangular_auto_falls_back_to_gell(self):
        m = from_coo([0, 1], [0, 2], np.float32([1, 2]), (2, 3),
                     layout="auto")
        assert isinstance(m, SparseGELL)


class TestSolversOnAutoOperators:
    def test_power_method_through_permuted_operator(self):
        """End-to-end: scrambled banded operator, auto layout (permuted
        DIA), power method converges to the dense oracle and the decoded
        eigenvector satisfies A x = lam x in ORIGINAL indexing."""
        rng = np.random.default_rng(7)
        n = 512
        shuffle = rng.permutation(n)
        i, j, v = _banded_coo(n, 2, rng, shuffle=shuffle)
        # dominance for fast, deterministic convergence
        i = np.concatenate([i, np.arange(n)])
        j = np.concatenate([j, np.arange(n)])
        v = np.concatenate([v, np.full(n, 6.0, np.float32)])
        v[-1] = 30.0
        m = from_coo(i, j, v, (n, n), layout="auto")
        assert isinstance(m, PermutedOperator)
        r = es.power_method(m, es.SolverOptions(max_iterations=2000,
                                                tolerance=1e-8))
        d = _dense_of(i, j, v, n)
        ev = np.linalg.eigvals(d)
        lam_oracle = ev[np.argmax(np.abs(ev))]
        lam = complex(np.asarray(r.eigenvalue))
        assert bool(r.converged)
        assert abs(lam - lam_oracle) < 1e-3 * abs(lam_oracle)
        x = np.asarray(r.eigenvector)
        resid = np.abs(d @ x - lam * x).max() / np.abs(lam)
        assert resid < 1e-3

    def test_auto_matches_handpicked_layout_numerics(self):
        rng = np.random.default_rng(8)
        n = 1024
        i = np.repeat(np.arange(n), 5)
        j = rng.integers(0, n, 5 * n)
        v = rng.standard_normal(5 * n).astype(np.float32)
        auto = from_coo(i, j, v, (n, n), layout="auto")
        hand = SparseGELL.from_coo(i, j, v, (n, n))
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        np.testing.assert_allclose(np.asarray(auto.matvec(x)),
                                   np.asarray(hand.matvec(x)), rtol=1e-6)
