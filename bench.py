"""Benchmarks of the plain (XLA-compiled) paths on one NVIDIA GPU.

Every record is one JSON line naming the device (platform, device_kind,
count) and the card (name and power limit from nvidia-smi). Times are
wall-clock around calls that end in ``jax.block_until_ready``, best of a
few runs after a warm-up that pays compilation. A run that finds no GPU
fails unless ``--cpu`` asks for a rehearsal on the CPU backend.

Suites (``--suite``, comma-separated):

  spmv     the jitted power loop on the 33-diagonal band (interleaved f32,
           interleaved bf16 values, natural f32), its bytes/s against a
           large device-to-device copy measured in the same process
  general  packed gather-ELL against the plain ELL gather, same operator
           (uniform columns, 33 nnz/row)
  qr       the dense QR engine (eigenvalues f32 and c64, eigenpairs f32)
           against ``jax.lax.linalg.eig`` on the same matrices, with the
           custom-call target the latter lowers to
  ds64     double-single power iteration against native float64
  gmres    banded split-complex shift-invert with the GMRES inner solve
           against host scipy shift-invert Arnoldi

    python bench.py --suite spmv,general --n 1000000
    python bench.py --suite qr --qr-n 512,2048
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BANDWIDTH = 16  # 33 diagonals


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


def emit(record: dict) -> None:
    import jax
    d = jax.devices()[0]
    record = dict(record, device=dict(platform=d.platform, kind=d.device_kind,
                                      count=len(jax.devices())),
                  card=CARD)
    print(json.dumps(record), flush=True)


def power_loop(matvec, x0):
    """Jitted fixed-length power loop: ``run(operand, iters)``."""
    import jax
    import jax.numpy as jnp

    def run(operand, iters):
        def body(_, x):
            y = matvec(operand, x)
            nn2 = jnp.sum(y * y)
            return (y * jax.lax.rsqrt(jnp.where(nn2 == 0, 1.0, nn2))).astype(x.dtype)
        return jax.lax.fori_loop(0, iters, body, x0)

    return jax.jit(run, static_argnums=1)


def copy_rate(gib: float = 1.0) -> float:
    """Bytes/s of a large elementwise pass (read + write) on the device."""
    import jax
    import jax.numpy as jnp
    from pcsc_eigenvalue_solver_project_tpu.utils.timing import timed
    n = int(gib * 2**30) // 4
    x = jnp.ones((n,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    return 2 * 4 * n / timed(f, x, reps=5)


def suite_spmv(args):
    import jax.numpy as jnp
    from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu.ops.dia import (dia_matvec,
                                                             dia_matvec_il,
                                                             interleave_vec)
    from pcsc_eigenvalue_solver_project_tpu.utils.timing import timed

    n, iters = args.n, args.iters
    dia = banded_full(n, bandwidth=BANDWIDTH, dtype=np.float32, seed=0)
    offsets, k, nnz = dia.offsets, len(dia.offsets), dia.nnz
    il = dia.interleaved()
    cases = {
        "dia_il_f32": (lambda v, x: dia_matvec_il(v, offsets, x),
                       il.data_il, interleave_vec(jnp.ones((n,), jnp.float32), il.R)),
        "dia_il_bf16": (lambda v, x: dia_matvec_il(v, offsets, x),
                        il.data_il.astype(jnp.bfloat16),
                        interleave_vec(jnp.ones((n,), jnp.float32), il.R)),
        "dia_natural_f32": (lambda v, x: dia_matvec(v, offsets, x),
                            dia.data, jnp.ones((n,), jnp.float32)),
    }
    copy = copy_rate()
    emit(dict(suite="spmv", metric="device_copy_bytes_per_s", value=copy,
              unit="B/s", note="jit(x + 1) on 1 GiB f32: read + write"))
    for name, (mv, vals, x0) in cases.items():
        run = power_loop(mv, x0)
        t = timed(run, vals, iters, reps=3) / iters
        N = int(np.prod(x0.shape))
        # minimum bytes per loop step: the diagonals, x read, y written,
        # y read and x written by the normalisation
        loop_bytes = k * N * vals.dtype.itemsize + 4 * N * 4
        emit(dict(suite="spmv", metric=f"power_loop_{name}", n=n,
                  diagonals=k, iters=iters, s_per_iter=t,
                  nnz_per_s=nnz / t, loop_bytes=loop_bytes,
                  bytes_per_s=loop_bytes / t,
                  fraction_of_copy=loop_bytes / t / copy))


def suite_general(args):
    import jax.numpy as jnp
    from pcsc_eigenvalue_solver_project_tpu.matrix.sparse import SparseCSR
    from pcsc_eigenvalue_solver_project_tpu.ops.gell import gell_matvec, pack_gell
    from pcsc_eigenvalue_solver_project_tpu.ops.matvec import ell_matvec
    from pcsc_eigenvalue_solver_project_tpu.utils.timing import timed

    n, per_row = args.n, 33
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    vals = rng.standard_normal(n * per_row).astype(np.float32)
    key = rows.astype(np.int64) * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols, vals = rows[uniq], cols[uniq], vals[uniq]
    nnz = len(rows)
    t0 = time.perf_counter()
    pack = pack_gell(rows, cols, vals, (n, n))
    pack_s = time.perf_counter() - t0
    ell = SparseCSR.from_coo(rows, cols, vals, (n, n), dtype=np.float32).to_ell()
    x0 = jnp.ones((n,), jnp.float32)
    iters = max(args.iters // 4, 10)
    for name, mv, operand in (
            ("gell", lambda p, x: gell_matvec(p, x), pack),
            ("ell_gather", lambda o, x: ell_matvec(o[0], o[1], x),
             (ell.indices, ell.data))):
        t = timed(power_loop(mv, x0), operand, iters, reps=3) / iters
        emit(dict(suite="general", metric=f"power_loop_{name}", n=n,
                  nnz=nnz, iters=iters, s_per_iter=t, nnz_per_s=nnz / t,
                  host_pack_s=pack_s if name == "gell" else None))


def _eig_targets(fn, a) -> list:
    import jax
    txt = jax.jit(fn).lower(a).as_text()
    return sorted(set(re.findall(r"custom_call @([\w.]+)", txt)))


def suite_qr(args):
    import jax
    import pcsc_eigenvalue_solver_project_tpu as es
    from chip_smoke import matched_err
    from pcsc_eigenvalue_solver_project_tpu.utils.timing import timed

    for n in (int(v) for v in args.qr_n.split(",")):
        rng = np.random.default_rng(n)
        g = rng.standard_normal((n, n)) / np.sqrt(n)
        h = rng.standard_normal((n, n)) / np.sqrt(n)
        sweeps = args.qr_max_sweeps or 40 * n
        cases = (("eigenvalues_f32", g.astype(np.float32), False),
                 ("eigenvalues_c64", ((g + 1j * h) / np.sqrt(2)).astype(np.complex64), False),
                 ("eigenpairs_f32", g.astype(np.float32), True))
        for name, a, vectors in cases:
            opts = es.QROptions(mode="accelerated", tolerance=1e-6,
                                max_iterations=sweeps, compute_vectors=vectors)
            M = es.DenseMatrix.from_array(a)
            W = es.DenseMatrix.from_array(np.diag(np.arange(1.0, n + 1)).astype(a.dtype))
            t0 = time.perf_counter()
            jax.block_until_ready(es.qr_eigenvalues(W, opts))
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = jax.block_until_ready(es.qr_eigenvalues(M, opts))
            plain_s = time.perf_counter() - t0
            err = matched_err(np.linalg.eigvals(a.astype(np.complex128)),
                              r.eigenvalues, np.linalg.norm(a, 2))

            def lax_eig(x, vectors=vectors):
                return jax.lax.linalg.eig(x, compute_left_eigenvectors=False,
                                          compute_right_eigenvectors=vectors)
            lax_s = timed(jax.jit(lax_eig), a, reps=3)
            emit(dict(suite="qr", metric=f"qr_{name}", n=n,
                      plain_engine_s=plain_s, plain_compile_s=compile_s,
                      plain_sweeps=int(r.iterations),
                      plain_converged=bool(r.converged),
                      plain_eig_err=err, lax_eig_s=lax_s,
                      lax_eig_targets=_eig_targets(lax_eig, a),
                      plain_over_lax=plain_s / lax_s))


def suite_ds64(args):
    import jax
    import jax.numpy as jnp
    import pcsc_eigenvalue_solver_project_tpu as es
    from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full

    n, bw = min(args.n, 100_000), 4   # compile time grows with the band
    dia = banded_full(n, bandwidth=bw, dtype=np.float64, seed=1)
    data = np.asarray(dia.data).copy()
    data[bw, 0] += 40.0
    M = es.SparseDIA(data=jnp.asarray(data), offsets=dia.offsets, shape=(n, n))
    opts = es.SolverOptions(tolerance=1e-13, max_iterations=2000)
    key = jax.random.key(5)
    out = {}
    for name, fn in (("f64", es.power_method), ("ds64", es.power_method_ds64)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(M, es.SolverOptions(max_iterations=1), key=key))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(M, opts, key=key))
        out[name] = (float(np.asarray(r.eigenvalue)), int(r.iterations),
                     time.perf_counter() - t0, compile_s)
    err = abs(out["ds64"][0] - out["f64"][0]) / abs(out["f64"][0])
    emit(dict(suite="ds64", metric="ds64_vs_f64_power", n=n,
              diagonals=2 * bw + 1,
              rel_diff=err, bound=1e-12, passes=err <= 1e-12,
              **{f"{k}_{f}": v[i] for k, v in out.items()
                 for i, f in enumerate(("eigenvalue", "iters", "s", "compile_s"))}))


def suite_gmres(args):
    import jax
    import scipy.sparse.linalg as spla
    import pcsc_eigenvalue_solver_project_tpu as es
    from pcsc_eigenvalue_solver_project_tpu.ops.split_complex import from_planes
    from chip_smoke import _gmres_operator

    n = 4096
    sc, A = _gmres_operator(n)
    t0 = time.perf_counter()
    w0, _ = spla.eigs(A, k=1, sigma=4.0 + 0.3j, tol=1e-10)
    host_s = time.perf_counter() - t0
    shift = complex(w0[0] + 0.01 * (1 + 1j))
    target = complex(spla.eigs(A, k=1, sigma=shift, tol=1e-10)[0][0])
    opts = es.ShiftedSolverOptions(shift=shift, max_iterations=60,
                                   tolerance=1e-5, inner_method="gmres",
                                   inner_tolerance=1e-6)
    key = jax.random.key(7)
    jax.block_until_ready(es.shifted_inverse_power_method(sc, opts, key=key))
    t0 = time.perf_counter()
    r = jax.block_until_ready(es.shifted_inverse_power_method(sc, opts, key=key))
    wall = time.perf_counter() - t0
    lam = complex(from_planes(np.asarray(r.eigenvalue)))
    emit(dict(suite="gmres", metric="gmres_inverse_power_n4096", n=n,
              s=wall, iterations=int(r.iterations), converged=bool(r.converged),
              eig_err=abs(lam - target) / (1 + abs(target)),
              gmres_m=max(2, min(max(30, n // 3), 180, n)),
              host_scipy_shift_invert_s=host_s))


SUITES = dict(spmv=suite_spmv, general=suite_general, qr=suite_qr,
              ds64=suite_ds64, gmres=suite_gmres)
CARD = ""


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="spmv")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--qr-n", default="512")
    ap.add_argument("--qr-max-sweeps", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend (no device numbers)")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    platform = jax.devices()[0].platform
    if platform != ("cpu" if args.cpu else "gpu"):
        print(f"bench: no GPU (default device platform: {platform})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from pcsc_eigenvalue_solver_project_tpu.utils.compile_cache import (
        use_checkout_cache)
    use_checkout_cache(ROOT)
    CARD = card_info()
    for name in args.suite.split(","):
        SUITES[name](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
