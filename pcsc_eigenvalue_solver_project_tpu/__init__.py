"""pcsc_eigenvalue_solver_project_tpu — an eigenvalue-solver framework in JAX.

A re-design of the capabilities of
``hugoheziyang/PCSC_Eigenvalue_Solver_Project`` (a C++20/Eigen library):
dense and sparse (CSR/ELL/block-sparse) real and complex matrices with a
text-file reader, power iteration, shifted inverse power iteration, and the
QR eigenvalue algorithm (Hessenberg reduction + QR sweeps, with an
accelerated Wilkinson-shift + deflation mode) — plus the distributed layer
the reference lacks: row-partitioned operators over a ``jax.sharding.Mesh``
with XLA collectives.

Typical usage::

    import pcsc_eigenvalue_solver_project_tpu as eigsol

    A = eigsol.read_matrix_from_file("data/A.txt", dtype=jnp.complex128)
    res = eigsol.power_method(A, eigsol.SolverOptions(tolerance=1e-8))
    print(res.eigenvalue, int(res.iterations), bool(res.converged))
"""

from .core.options import QROptions, ShiftedSolverOptions, SolverOptions
from .core.results import EigenResult, QRResult
from .core.tolerance import is_close_relative
from .matrix.dense import DenseMatrix
from .matrix.protocol import AbstractMatrix
from .matrix.sparse import SparseCSR, SparseELL
from .matrix.gell import SparseGELL
from .io.reader import read_matrix_from_file, read_matrix_from_text
from .io.writer import write_matrix_to_file
from .solvers.power import power_method
from .solvers.inverse_power import (rayleigh_quotient_iteration,
                                    shifted_inverse_power_method)
from .solvers.solve_shifted import solve_shifted
from .solvers.hessenberg import to_hessenberg
from .solvers.qr import qr_decompose
from .solvers.qr_eigenvalues import qr_eigenvalues
from .solvers.arnoldi import (arnoldi_eigenvalues,
                              krylov_schur_eigenvalues)
from .solvers.lanczos import (lanczos_eigenpairs, lanczos_eigenvalues,
                              lanczos_thick_restart)
from .solvers.lobpcg import lobpcg_eigenvalues
from .solvers.subspace import chebyshev_subspace_iteration, subspace_iteration
from .matrix.auto import (LayoutDecision, PermutedOperator,
                          from_coo, suggest_layout)
from .matrix.dia import InterleavedDIA, SparseDIA
from .matrix.split_complex import InterleavedSplitComplexDIA, SplitComplexDIA
from .solvers.power import power_method_ds64, power_method_split_complex

__version__ = "0.1.0"

__all__ = [
    "AbstractMatrix",
    "DenseMatrix",
    "InterleavedDIA",
    "SparseDIA",
    "InterleavedSplitComplexDIA",
    "SplitComplexDIA",
    "LayoutDecision",
    "PermutedOperator",
    "from_coo",
    "power_method_ds64",
    "suggest_layout",
    "arnoldi_eigenvalues",
    "krylov_schur_eigenvalues",
    "lanczos_eigenpairs",
    "lanczos_eigenvalues",
    "lanczos_thick_restart",
    "lobpcg_eigenvalues",
    "chebyshev_subspace_iteration",
    "subspace_iteration",
    "power_method_split_complex",
    "EigenResult",
    "QROptions",
    "QRResult",
    "ShiftedSolverOptions",
    "SolverOptions",
    "SparseCSR",
    "SparseELL",
    "SparseGELL",
    "is_close_relative",
    "power_method",
    "qr_decompose",
    "qr_eigenvalues",
    "rayleigh_quotient_iteration",
    "read_matrix_from_file",
    "to_hessenberg",
    "read_matrix_from_text",
    "shifted_inverse_power_method",
    "solve_shifted",
    "subspace_iteration",
    "write_matrix_to_file",
]
