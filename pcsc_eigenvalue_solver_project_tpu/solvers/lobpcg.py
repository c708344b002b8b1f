"""LOBPCG — block top-k eigensolver for symmetric/Hermitian operators.

Locally Optimal Block Preconditioned Conjugate Gradient: the block
counterpart of Lanczos that iterates k vectors simultaneously, so every
step is ONE block SpMM — on a bandwidth-bound operator the diagonals are
read once per k matvecs (the block SpMM of ops/dia.py), and all the small
dense algebra (Rayleigh-Ritz ``eigh`` of the 3k x 3k projection) runs
inside the same jit. Another superset over the reference, whose only spectrum
solver is the dense O(n^3) QR stack (qr_eigenvalues.hpp:131-133).

Built on ``jax.experimental.sparse.linalg.lobpcg_standard`` (the
accelerator-native implementation) with this framework's operator
protocol bridged in: any ``AbstractMatrix`` works, and banded formats
(SparseDIA / InterleavedDIA) route the block apply through their fused
SpMM kernels. ``which="SA"`` (smallest algebraic) maps to largest of
``sigma*I - A`` with ``sigma`` a cheap power-iteration overestimate of
the spectral radius — upstream only supports the top end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import full_precision
from ..core.dtypes import check_scalar_type
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..utils.prng import default_key


def _block_apply(M: AbstractMatrix):
    """Column-block apply X (n, b) -> A X through the fastest kernel the
    operator kind has."""
    from ..matrix.dia import InterleavedDIA, SparseDIA
    from ..ops.dia import dia_matmat
    if isinstance(M, InterleavedDIA):
        def apply(X):
            Xe = jax.vmap(M.encode_vec, in_axes=1)(X)        # (b, R, 128)
            Ye = M.matmat(Xe)
            return jax.vmap(M.decode_vec)(Ye).T              # (n, b)
        return apply
    if isinstance(M, SparseDIA):
        return lambda X: dia_matmat(M.data, M.offsets, X.T).T
    if M.is_dense:
        return lambda X: M.as_dense() @ X
    return jax.vmap(M.matvec, in_axes=1, out_axes=1)


@partial(jax.jit, static_argnames=("iters",))
def _spectral_radius_overestimate(M, x0: jax.Array, iters: int):
    """||A||_2 overestimate: power iteration + a 1.05 safety factor.

    ``M`` rides as a pytree argument (jit cache keyed on its treedef and
    shapes, NOT on a per-call closure id — a static callable here would
    recompile on every call)."""
    apply = _block_apply(M)
    rdt = jnp.zeros((), x0.dtype).real.dtype

    def body(_, carry):
        x, lam = carry
        y = apply(x[:, None])[:, 0]
        nrm = jnp.linalg.norm(y).astype(rdt)
        safe = jnp.where(nrm == 0, 1.0, nrm).astype(x.dtype)
        return (y / safe, nrm)

    _, lam = jax.lax.fori_loop(0, iters, body, (x0, jnp.zeros((), rdt)))
    return 1.05 * lam + 1e-3


@full_precision
def lobpcg_eigenvalues(M: AbstractMatrix, k: int = 4, *,
                       opts: SolverOptions = SolverOptions(),
                       which: str = "LA", dtype=None, key=None,
                       X0=None) -> QRResult:
    """Top-``k`` (``which="LA"``) or bottom-``k`` (``which="SA"``)
    eigenvalues of a symmetric/Hermitian positive-definite-ish operator.

    ``opts.max_iterations`` caps LOBPCG sweeps; ``converged`` applies this
    framework's relative criterion ``||A x - theta x|| <= tol (1+|theta|)``
    to every returned pair (the reference's tolerance shape,
    tolerance.hpp:29-33). Returns a ``QRResult`` with real eigenvalues
    sorted descending ("LA") / ascending ("SA").

    ``which="SA"`` caveat: the spectral-shift mapping gives ABSOLUTE
    accuracy at the scale of ``sigma`` (the spectral-radius overestimate),
    so eigenvalues much smaller than ``sigma`` keep only absolute — not
    relative — precision. For tight smallest eigenvalues of
    ill-conditioned operators use ``lanczos_eigenvalues(which="SA")`` or
    shift-invert via ``shifted_inverse_power_method``.
    """
    if which not in ("LA", "SA"):
        raise ValueError(f"lobpcg_eigenvalues: unknown which={which!r}")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lobpcg_eigenvalues")
    require_square(M, "lobpcg_eigenvalues")
    require_nonempty(M, "lobpcg_eigenvalues")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lobpcg_eigenvalues: k must be >= 1")
    if 5 * k >= n:
        raise ValueError(
            f"lobpcg_eigenvalues: n ({n}) must exceed 5k ({5 * k}) — "
            "use the dense QR solver for small problems")

    from jax.experimental.sparse.linalg import lobpcg_standard

    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if np.dtype(vec_dt).kind == "c":
        raise ValueError("lobpcg_eigenvalues: complex operators are not "
                         "supported by the upstream routine; use "
                         "lanczos_eigenvalues")
    if X0 is None:
        X0 = jax.random.normal(key if key is not None else default_key(),
                               (n, k), vec_dt)
    else:
        X0 = jnp.asarray(X0, vec_dt)
        if X0.shape != (n, k):
            raise ValueError(f"lobpcg_eigenvalues: X0 must be (n, k) = "
                             f"({n}, {k})")

    apply = _block_apply(M)
    if which == "SA":
        if hasattr(M, "spectral_bound"):
            # deterministic Gershgorin bound (banded formats): one pass
            sigma = (1.0 + 1e-6) * M.spectral_bound().astype(vec_dt)
        else:
            sigma = _spectral_radius_overestimate(M, X0[:, 0], 30).astype(vec_dt)
        op = lambda X: sigma * X - apply(X)
    else:
        op = apply

    # run upstream at machine tolerance (its own tol semantics exit too
    # eagerly for loose values) within the user's sweep budget, then apply
    # THIS framework's convergence contract as a post-check: the reference
    # relative criterion on per-pair residuals (tolerance.hpp:29-33 shape).
    theta, U, iters = lobpcg_standard(op, X0, m=int(opts.max_iterations),
                                      tol=None)
    R = op(U) - U * theta[None, :]
    resid = jnp.sqrt(jnp.sum(jnp.abs(R) ** 2, axis=0))
    converged = jnp.all(resid <= opts.tolerance * (1.0 + jnp.abs(theta)))
    if which == "SA":
        vals = jnp.sort(sigma - theta)
    else:
        vals = jnp.sort(theta)[::-1]
    return QRResult(eigenvalues=vals,
                    iterations=jnp.asarray(np.asarray(iters), jnp.int32),
                    converged=converged)
