"""Guards for running on an NVIDIA GPU: no kernels for another accelerator,
no host pinning, full-precision float32 dots, the compile-cache location,
the imports the card's machine can satisfy, and (on the card only) device
placement."""

import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pcsc_eigenvalue_solver_project_tpu as es
from pcsc_eigenvalue_solver_project_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py_files(*roots):
    for r in roots:
        path = os.path.join(ROOT, r)
        if os.path.isfile(path):
            yield path
            continue
        for d, _, files in os.walk(path):
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def _source(path):
    with open(path) as f:
        return f.read()


def test_no_foreign_kernel_imports():
    banned = ("pallas." + "t" + "pu", "plt" + "pu")
    hits = [p for p in _py_files("pcsc_eigenvalue_solver_project_tpu", "tests",
                                 "tools", "bench.py", "__graft_entry__.py",
                                 "chip_smoke.py")
            if any(b in _source(p) for b in banned)]
    assert hits == []


@pytest.mark.parametrize("pattern", [
    'default_backend() != "cpu"', 'default_backend() == "cpu"',
    'local_devices(backend="cpu")', "jax.default_device(",
])
def test_no_host_pinning_in_package(pattern):
    hits = [p for p in _py_files("pcsc_eigenvalue_solver_project_tpu")
            if pattern in _source(p)]
    assert hits == []


ALLOWED = {"jax", "jaxlib", "numpy", "scipy", "optax", "chex", "einops",
           "pytest", "hypothesis",
           "pcsc_eigenvalue_solver_project_tpu", "chip_smoke"}  # this repo


@pytest.mark.parametrize("root", ["pcsc_eigenvalue_solver_project_tpu",
                                  "bench.py", "chip_smoke.py"])
def test_imports_are_available_on_the_card_machine(root):
    bad = set()
    for p in _py_files(root):
        for node in ast.walk(ast.parse(_source(p))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for nm in names:
                top = nm.split(".")[0]
                if top not in ALLOWED and top not in sys.stdlib_module_names:
                    bad.add((os.path.relpath(p, ROOT), top))
    assert not bad


def test_compile_cache_env_is_the_only_cache(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.use_checkout_cache(ROOT) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        path = compile_cache.use_checkout_cache(ROOT)
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.use_checkout_cache(ROOT) == path   # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_precisions(closed):
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)
    walk(closed.jaxpr)
    return out


def _lanczos_step():
    from pcsc_eigenvalue_solver_project_tpu.solvers.lanczos import (
        lanczos_decomposition)
    a = jnp.eye(16, dtype=jnp.float32)
    return lambda x: lanczos_decomposition(lambda v: a @ v, x, 4)


def _arnoldi_step():
    from pcsc_eigenvalue_solver_project_tpu.solvers.arnoldi import (
        arnoldi_decomposition)
    a = jnp.eye(16, dtype=jnp.float32)
    return lambda x: arnoldi_decomposition(lambda v: a @ v, x, 4)


def _hessenberg():
    from pcsc_eigenvalue_solver_project_tpu.solvers.hessenberg import (
        hessenberg_dense_q)
    return lambda x: hessenberg_dense_q(jnp.outer(x, x))


def _francis():
    from pcsc_eigenvalue_solver_project_tpu.solvers.qr_eigenvalues import (
        _qr_eigenvalues_accel_real)
    return lambda x: _qr_eigenvalues_accel_real(
        jnp.outer(x, x), jnp.asarray(3), jnp.asarray(1e-6, jnp.float32))


def _parity():
    from pcsc_eigenvalue_solver_project_tpu.solvers.qr_eigenvalues import (
        _qr_eigenvalues_parity)
    return lambda x: _qr_eigenvalues_parity(
        jnp.outer(x, x), jnp.asarray(3), jnp.asarray(1e-6, jnp.float32))


@pytest.mark.parametrize("make", [_lanczos_step, _arnoldi_step, _hessenberg,
                                  _francis, _parity])
def test_float32_dots_lower_with_highest_precision(make):
    closed = jax.make_jaxpr(make())(jnp.ones((16,), jnp.float32))
    precs = _dot_precisions(closed)
    assert precs, "expected at least one dot"
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == hi for p in precs), precs


def test_full_precision_decorator_scopes_dot_precision():
    """Products traced under ``full_precision`` ask for HIGHEST; outside
    it the default stays in force."""
    from pcsc_eigenvalue_solver_project_tpu.core.precision import (
        full_precision)

    @full_precision
    def gram(x):
        return jnp.conj(x).T @ x

    precs = _dot_precisions(jax.make_jaxpr(gram)(jnp.ones((8, 3), jnp.float32)))
    assert precs == [(jax.lax.Precision.HIGHEST,) * 2]
    plain = _dot_precisions(jax.make_jaxpr(lambda x: x.T @ x)(
        jnp.ones((8, 3), jnp.float32)))
    assert plain == [None]


@pytest.mark.gpu
def test_results_live_on_the_gpu(gpu):
    a = np.diag(np.arange(1.0, 33.0)) + 0.01
    for dt in (np.float32, np.complex64, np.complex128):
        M = es.DenseMatrix.from_array(a.astype(dt))
        for r in (es.power_method(M),
                  es.qr_eigenvalues(M, es.QROptions(mode="accelerated"))):
            value = getattr(r, "eigenvalue", None)
            value = r.eigenvalues if value is None else value
            assert value.devices() == {gpu}
