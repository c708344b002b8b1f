#!/usr/bin/env python3
"""Smoke test of the eigensolvers on one NVIDIA GPU.

Drives the public API (``import pcsc_eigenvalue_solver_project_tpu``) once
per configuration in BASELINE.json at that configuration's own size, and
checks every result against an independent float64 reference on the host:

  demo                the reference demo flow (data/A.txt, data/B.txt)
  dense_shift_invert  shifted inverse power, dense c64 n=2048 and banded
                      split-complex n=4096 with the GMRES inner solve
  dense_qr            QR eigenvalues 512 f32 / c64 / f64, eigenpairs 512,
                      parity mode 256
  sparse_power        power iteration on the 33-diagonal band at 100K and
                      1M rows (layout from ``from_coo(layout="auto")``),
                      Lanczos and Arnoldi at 1M rows
  ds64                double-single power iteration vs native float64

Each phase prints one line per solve: the device the result lives on, the
compile and solve times (``block_until_ready``), iterations, convergence,
the error against the reference with its bound, and the matmul precision.
Any miss raises, and the script exits non-zero without printing ``ok``.
The last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py               # one GPU (all phases)
    python chip_smoke.py --multichip   # four GPUs: the distributed path only
    python chip_smoke.py --cpu         # small rehearsal on the CPU backend
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_BOUND = 1e-4
F64_BOUND = 1e-10
# The demo's power runs stop when the Rayleigh quotient changes by less
# than 1e-10 (main.cpp), which bounds the error only by 1e-10/(1 - ratio)
# of the two largest eigenvalues; the reference holds such results to 1e-8
# (qr_algorithms_test.cpp:265-266).
DEMO_POWER_BOUND = 1e-8


def card_info() -> str:
    """Name and power limit of the card, read by nvidia-smi (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


class Smoke:
    def __init__(self, platform: str, small: bool):
        import jax
        self.jax = jax
        self.platform = platform
        self.small = small

    def size(self, full: int, small: int) -> int:
        return small if self.small else full

    def check(self, phase: str, what: str, result, value, *, err: float,
              bound: float, precision: str, compile_s=None, solve_s=None,
              iters=None, converged=None):
        """Print one result line; raise if it missed its bound, did not
        converge, or does not live on the expected device."""
        devs = {d.platform for d in value.devices()}
        dev = ",".join(sorted(str(d) for d in value.devices()))
        comp = "n/a" if compile_s is None else f"{compile_s:.3f}s"
        solve = "n/a" if solve_s is None else f"{solve_s:.3f}s"
        print(f"[{phase}] {what}: device={dev} compile={comp} solve={solve} "
              f"iters={iters} converged={converged} err={err:.3e} "
              f"bound={bound:.0e} precision={precision}", flush=True)
        if devs != {self.platform}:
            raise RuntimeError(f"{phase}/{what}: result on {dev}, "
                               f"expected {self.platform}")
        if converged is not None and not converged:
            raise RuntimeError(f"{phase}/{what}: did not converge")
        if not err <= bound:
            raise RuntimeError(f"{phase}/{what}: error {err:.3e} > {bound:.0e}")

    def timed(self, fn, warm=None):
        """(result, compile_s, solve_s): ``warm`` (same shapes, trivial
        content) or a first call of ``fn`` pays the compilation."""
        t0 = time.perf_counter()
        self.jax.block_until_ready(warm() if warm is not None else fn())
        t1 = time.perf_counter()
        out = self.jax.block_until_ready(fn())
        t2 = time.perf_counter()
        solve = t2 - t1
        return out, max((t1 - t0) - (0 if warm is not None else solve), 0.0), solve


def matched_err(ref, got, scale):
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    C = np.abs(ref[:, None] - got[None, :])
    r, c = linear_sum_assignment(C)
    return float(C[r, c].max() / scale)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_demo(s: Smoke):
    import numpy as np
    from pcsc_eigenvalue_solver_project_tpu.demo import run_reference_demo
    t0 = time.perf_counter()
    out = run_reference_demo(os.path.join(ROOT, "data"))
    wall = time.perf_counter() - t0
    a = np.asarray(out["A"].array)
    b = np.asarray(out["B"].to_dense())
    ea, eb = np.linalg.eigvals(a), np.linalg.eigvals(b)
    for name, res, ev, pick, bound in (
            ("power A", out["power_A"], ea, lambda e: e[np.argmax(np.abs(e))],
             DEMO_POWER_BOUND),
            ("power B", out["power_B"], eb, lambda e: e[np.argmax(np.abs(e))],
             DEMO_POWER_BOUND),
            ("shifted A sigma=3.1", out["shifted_A"], ea,
             lambda e: e[np.argmin(np.abs(e - 3.1))], F64_BOUND),
            ("shifted B sigma=2.3", out["shifted_B"], eb,
             lambda e: e[np.argmin(np.abs(e - 2.3))], F64_BOUND)):
        err = abs(complex(res.eigenvalue) - pick(ev)) / np.abs(ev).max()
        s.check("demo", name, res, res.eigenvalue, err=err, bound=bound,
                precision="f64", solve_s=wall, iters=int(res.iterations),
                converged=bool(res.converged))
    qr = out["qr_A"]
    s.check("demo", "qr_eigenvalues A (parity)", qr, qr.eigenvalues,
            err=matched_err(ea, qr.eigenvalues, np.abs(ea).max()),
            bound=F64_BOUND, precision="f64", iters=int(qr.iterations),
            converged=bool(qr.converged))
    print(f"[demo] solve_shifted A residual {out['solve_residual']:.3e} "
          f"bound {F64_BOUND:.0e}; demo wall {wall:.3f}s (compile included)",
          flush=True)
    if not out["solve_residual"] <= F64_BOUND:
        raise RuntimeError("demo: solve_shifted residual too large")


def _gmres_operator(n):
    """The banded split-complex operator of ``bench.py --suite gmres``."""
    import numpy as np
    import jax.numpy as jnp
    from pcsc_eigenvalue_solver_project_tpu import SplitComplexDIA
    rng = np.random.default_rng(0)
    offs = (-3, -1, 0, 2)
    planes = np.zeros((2, len(offs), n), np.float32)
    for d, off in enumerate(offs):
        amp = 1.0 if off == 0 else 0.3
        planes[0, d] = amp * rng.standard_normal(n)
        planes[1, d] = amp * rng.standard_normal(n)
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    planes[0, offs.index(0)] += 4.0 + rng.uniform(-2, 2, n).astype(np.float32)
    sc = SplitComplexDIA(planes=jnp.asarray(planes), offsets=offs, shape=(n, n))
    import scipy.sparse as sp
    rows, cols, vals = [], [], []
    for d, off in enumerate(offs):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append((planes[0, d] + 1j * planes[1, d]).astype(np.complex128)[i])
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsc()
    return sc, A


def phase_dense_shift_invert(s: Smoke):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla
    import pcsc_eigenvalue_solver_project_tpu as es
    from pcsc_eigenvalue_solver_project_tpu.ops.split_complex import from_planes

    n = s.size(2048, 256)
    rng = np.random.default_rng(1)
    d = np.sqrt(rng.uniform(0, 1, n)) * np.exp(2j * np.pi * rng.uniform(0, 1, n))
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    a = ((Qo * d) @ Qo.conj().T).astype(np.complex64)
    target = d[np.argmax(d.real)]
    gap = np.sort(np.abs(d - target))[1]
    shift = complex(target + 0.05 * gap * (1 + 1j) / np.sqrt(2))
    M = es.DenseMatrix.from_array(a)
    opts = es.ShiftedSolverOptions(shift=shift, tolerance=1e-6,
                                   max_iterations=200)
    key = jax.random.key(3)
    r, comp, solve = s.timed(
        lambda: es.shifted_inverse_power_method(M, opts, key=key))
    err = abs(complex(r.eigenvalue) - target) / np.abs(d).max()
    s.check("dense_shift_invert", f"dense c64 n={n} (dense_lu)", r,
            r.eigenvalue, err=err, bound=F32_BOUND, precision="highest",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))

    n = s.size(4096, 512)
    sc, A_sp = _gmres_operator(n)
    w0, _ = spla.eigs(A_sp, k=1, sigma=4.0 + 0.3j, tol=1e-10)
    shift = complex(w0[0] + 0.01 * (1 + 1j))
    wt, _ = spla.eigs(A_sp, k=1, sigma=shift, tol=1e-10)
    target = complex(wt[0])
    opts = es.ShiftedSolverOptions(shift=shift, max_iterations=60,
                                   tolerance=1e-5, inner_method="gmres",
                                   inner_tolerance=1e-6)
    warm = es.ShiftedSolverOptions(shift=shift, max_iterations=1,
                                   tolerance=1e-5, inner_method="gmres",
                                   inner_tolerance=1e-6)
    key = jax.random.key(7)
    r, comp, solve = s.timed(
        lambda: es.shifted_inverse_power_method(sc, opts, key=key),
        warm=lambda: es.shifted_inverse_power_method(sc, warm, key=key))
    lam = complex(from_planes(np.asarray(r.eigenvalue)))
    err = abs(lam - target) / (1 + abs(target))
    s.check("dense_shift_invert", f"banded split-complex n={n} (gmres)", r,
            r.eigenvalue, err=err, bound=F32_BOUND, precision="highest",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))


def phase_dense_qr(s: Smoke):
    import numpy as np
    import jax
    import pcsc_eigenvalue_solver_project_tpu as es

    n = s.size(512, 48)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((n, n)) / np.sqrt(n)
    h = rng.standard_normal((n, n)) / np.sqrt(n)

    def run(what, a, opts, bound, precision, vectors=False):
        M = es.DenseMatrix.from_array(a)
        W = es.DenseMatrix.from_array(np.diag(np.arange(1.0, n + 1)).astype(a.dtype))
        r, comp, solve = s.timed(lambda: es.qr_eigenvalues(M, opts),
                                 warm=lambda: es.qr_eigenvalues(W, opts))
        a64 = a.astype(np.complex128)
        scale = np.linalg.norm(a64, 2)
        err = matched_err(np.linalg.eigvals(a64), r.eigenvalues, scale)
        if vectors:
            V = np.asarray(r.eigenvectors).astype(np.complex128)
            lam = np.asarray(r.eigenvalues).astype(np.complex128)
            res = np.linalg.norm(a64 @ V - V * lam[None, :], axis=0).max() / scale
            err = max(err, res)
            what += f" (eigenvalue err and residual max; residual {res:.3e})"
        s.check("dense_qr", what, r, r.eigenvalues, err=err, bound=bound,
                precision=precision, compile_s=comp, solve_s=solve,
                iters=int(r.iterations), converged=bool(r.converged))

    acc = es.QROptions(mode="accelerated", tolerance=1e-6,
                       max_iterations=40 * n)
    run(f"accelerated f32 n={n}", g.astype(np.float32), acc, F32_BOUND,
        "highest")
    run(f"accelerated c64 n={n}", (g + 1j * h).astype(np.complex64) / np.sqrt(2),
        acc, F32_BOUND, "highest")
    run(f"eigenpairs f32 n={n}", g.astype(np.float32),
        es.QROptions(mode="accelerated", tolerance=1e-6, max_iterations=40 * n,
                     compute_vectors=True), F32_BOUND, "highest", vectors=True)
    run(f"accelerated f64 n={n}", g,
        es.QROptions(mode="accelerated", tolerance=1e-14,
                     max_iterations=40 * n), F64_BOUND, "f64")

    m = s.size(256, 32)
    Qo, _ = np.linalg.qr(rng.standard_normal((m, m)))
    sym = ((Qo * 0.9 ** np.arange(m)) @ Qo.T).astype(np.float32)
    run(f"parity f32 n={m}", sym,
        es.QROptions(mode="parity", tolerance=1e-6, max_iterations=2000),
        F32_BOUND, "highest")


def _planted_band_coo(n, seed, bandwidth=16):
    """COO of the full band (``banded_full``, 33 diagonals by default) with
    a planted dominant diagonal entry, so the dominant eigenvalue is
    isolated."""
    import numpy as np
    from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
    dia = banded_full(n, bandwidth=bandwidth, dtype=np.float32, seed=seed)
    data = np.asarray(dia.data).copy()
    data[bandwidth, 0] += 40.0
    rows, cols, vals = [], [], []
    for d, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(data[d, i])
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals)), data, dia.offsets


def _planted_tridiagonal(n, upper):
    """Tridiagonal operator with planted extremes 14, 10, 8: lower
    off-diagonal 0.1, upper ``upper``. Its eigenvalues are those of the
    symmetric tridiagonal with off-diagonal sqrt(0.1 * upper)."""
    import numpy as np
    import jax.numpy as jnp
    from pcsc_eigenvalue_solver_project_tpu import SparseDIA
    from scipy.linalg import eigvalsh_tridiagonal
    rng = np.random.default_rng(7)
    diag = rng.uniform(0.5, 2.0, n)
    diag[:3] = (14.0, 10.0, 8.0)
    data = np.stack([np.full(n, 0.1), diag, np.full(n, upper)]).astype(np.float32)
    data[0, 0] = 0.0
    data[2, n - 1] = 0.0
    M = SparseDIA(data=jnp.asarray(data), offsets=(-1, 0, 1), shape=(n, n))
    d64 = data[1].astype(np.float64)
    e64 = np.sqrt(data[0, 1:].astype(np.float64) * data[2, :-1])
    top = eigvalsh_tridiagonal(d64, e64, select="i",
                               select_range=(n - 3, n - 1))[::-1]
    return M, top


def phase_sparse_power(s: Smoke):
    import numpy as np
    import jax
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import pcsc_eigenvalue_solver_project_tpu as es

    for n in (s.size(100_000, 20_000), s.size(1_000_000, 40_000)):
        (r_, c_, v_), _, _ = _planted_band_coo(n, seed=0)
        t0 = time.perf_counter()
        M = es.from_coo(r_, c_, v_, (n, n), layout="auto")
        build = time.perf_counter() - t0
        A = sp.csr_matrix((v_.astype(np.float64), (r_, c_)), shape=(n, n))
        ref = complex(spla.eigs(A, k=1, which="LM", tol=1e-12)[0][0])
        opts = es.SolverOptions(tolerance=1e-6, max_iterations=2000)
        key = jax.random.key(0)
        r, comp, solve = s.timed(
            lambda: es.power_method(M, opts, key=key),
            warm=lambda: es.power_method(
                M, es.SolverOptions(max_iterations=1), key=key))
        err = abs(complex(r.eigenvalue) - ref) / abs(ref)
        layout = type(getattr(M, "inner", M)).__name__
        s.check("sparse_power", f"power n={n} layout={layout} "
                f"(host build {build:.1f}s)", r, r.eigenvalue, err=err,
                bound=F32_BOUND, precision="f32 band (no dots)",
                compile_s=comp, solve_s=solve, iters=int(r.iterations),
                converged=bool(r.converged))

    n = s.size(1_000_000, 40_000)
    M, top = _planted_tridiagonal(n, 0.1)
    opts = es.SolverOptions(tolerance=1e-5)
    key = jax.random.key(11)
    r, comp, solve = s.timed(lambda: es.lanczos_eigenvalues(
        M, k=3, m=40, which="LA", opts=opts, key=key))
    err = float(np.abs(np.sort(np.asarray(r.eigenvalues).real)[::-1] - top).max()
                / top[0])
    s.check("sparse_power", f"lanczos top-3 n={n}", r, r.eigenvalues, err=err,
            bound=F32_BOUND, precision="highest", compile_s=comp,
            solve_s=solve, iters=int(r.iterations), converged=bool(r.converged))

    M, top = _planted_tridiagonal(n, 0.05)
    r, comp, solve = s.timed(lambda: es.arnoldi_eigenvalues(
        M, k=3, m=40, opts=es.SolverOptions(tolerance=1e-6), key=key))
    got = np.asarray(r.eigenvalues)
    err = matched_err(top, got, top[0])
    s.check("sparse_power", f"arnoldi top-3 n={n}", r, r.eigenvalues, err=err,
            bound=F32_BOUND, precision="highest", compile_s=comp,
            solve_s=solve, iters=int(r.iterations), converged=bool(r.converged))


def phase_ds64(s: Smoke):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pcsc_eigenvalue_solver_project_tpu as es

    # 9 diagonals: the compensated loop's compile time grows with the band
    n = s.size(100_000, 20_000)
    _, data, offsets = _planted_band_coo(n, seed=1, bandwidth=4)
    M = es.SparseDIA(data=jnp.asarray(data.astype(np.float64)),
                     offsets=offsets, shape=(n, n))
    opts = es.SolverOptions(tolerance=1e-13, max_iterations=2000)
    key = jax.random.key(5)
    ref, _, ref_s = s.timed(lambda: es.power_method(M, opts, key=key))
    r, comp, solve = s.timed(lambda: es.power_method_ds64(M, opts, key=key))
    lam, lam64 = float(np.asarray(r.eigenvalue)), float(ref.eigenvalue)
    err = abs(lam - lam64) / abs(lam64)
    print(f"[ds64] native f64 power n={n}: device="
          f"{','.join(str(d) for d in ref.eigenvalue.devices())} "
          f"solve={ref_s:.3f}s iters={int(ref.iterations)}", flush=True)
    s.check("ds64", f"power_method_ds64 n={n} 9 diagonals vs native f64", r,
            r.eigenvalue, err=err, bound=1e-12, precision="ds64",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))


def phase_multichip(s: Smoke):
    import numpy as np
    import jax
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import pcsc_eigenvalue_solver_project_tpu as es
    from pcsc_eigenvalue_solver_project_tpu.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu.parallel.dia import (
        distributed_dia_il_power_method, partition_dia, partition_dia_il)
    from pcsc_eigenvalue_solver_project_tpu.parallel.lanczos import (
        distributed_lanczos_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--multichip needs 4 devices, have {len(jax.devices())}")
    mesh = make_row_mesh(4)
    n = s.size(1_000_000, 40_000)
    key = jax.random.key(0)

    (r_, c_, v_), data, offsets = _planted_band_coo(n, seed=0)
    A = sp.csr_matrix((v_.astype(np.float64), (r_, c_)), shape=(n, n))
    ref = complex(spla.eigs(A, k=1, which="LM", tol=1e-12)[0][0])
    dia = es.SparseDIA(data=jax.numpy.asarray(data), offsets=offsets,
                       shape=(n, n))
    opts = es.SolverOptions(tolerance=1e-6, max_iterations=2000)
    one = es.power_method(dia.interleaved(), opts, key=key)
    Ail = partition_dia_il(dia, mesh)
    r, comp, solve = s.timed(
        lambda: distributed_dia_il_power_method(Ail, mesh, opts, key=key))
    err = max(abs(complex(r.eigenvalue) - ref) / abs(ref),
              abs(complex(r.eigenvalue) - complex(one.eigenvalue)) / abs(ref))
    s.check("multichip", f"dia_il power n={n} on 4 (vs 1 card "
            f"{complex(one.eigenvalue).real:.7f}, f64 {ref.real:.7f})", r,
            r.eigenvalue, err=err, bound=F32_BOUND, precision="f32 band",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))

    M, top = _planted_tridiagonal(n, 0.1)
    lopts = es.SolverOptions(tolerance=1e-5)
    one = es.lanczos_eigenvalues(M, k=3, m=40, which="LA", opts=lopts, key=key)
    AL = partition_dia_il(M, mesh)
    r, comp, solve = s.timed(lambda: distributed_lanczos_eigenvalues(
        AL, mesh, k=3, m=40, which="LA", opts=lopts, key=key))
    got = np.sort(np.asarray(r.eigenvalues).real)[::-1]
    err = max(float(np.abs(got - top).max() / top[0]),
              float(np.abs(got - np.sort(np.asarray(one.eigenvalues).real)[::-1]).max()
                    / top[0]))
    s.check("multichip", f"lanczos top-3 n={n} on 4 (vs 1 card and exact)",
            r, r.eigenvalues, err=err, bound=F32_BOUND, precision="highest",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))

    M, top = _planted_tridiagonal(n, 0.05)
    aopts = es.SolverOptions(tolerance=1e-6)
    one = es.arnoldi_eigenvalues(M, k=3, m=40, opts=aopts, key=key)
    AA = partition_dia(M, mesh)
    r, comp, solve = s.timed(lambda: distributed_arnoldi_eigenvalues(
        AA, mesh, k=3, m=40, opts=aopts, key=key))
    err = max(matched_err(top, r.eigenvalues, top[0]),
              matched_err(one.eigenvalues, r.eigenvalues, top[0]))
    s.check("multichip", f"arnoldi top-3 n={n} on 4 (vs 1 card and exact)",
            r, r.eigenvalues, err=err, bound=F32_BOUND, precision="highest",
            compile_s=comp, solve_s=solve, iters=int(r.iterations),
            converged=bool(r.converged))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="four GPUs: only the distributed path and its checks")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse at small sizes on the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.multichip:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_force_host_platform_device_count=4")

    import jax
    platform = jax.devices()[0].platform
    if platform != ("cpu" if args.cpu else "gpu"):
        print(f"chip_smoke: no GPU (default device platform: {platform})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from pcsc_eigenvalue_solver_project_tpu.utils.compile_cache import (
        use_checkout_cache)
    use_checkout_cache(ROOT)

    card = card_info()
    print(f"devices: {jax.devices()} | card (name, power limit): {card}",
          flush=True)
    s = Smoke(platform, small=args.cpu)
    t0 = time.perf_counter()
    phases = ([phase_multichip] if args.multichip else
              [phase_demo, phase_dense_shift_invert, phase_dense_qr,
               phase_sparse_power, phase_ds64])
    for phase in phases:
        t = time.perf_counter()
        phase(s)
        print(f"[{phase.__name__[6:]}] phase wall {time.perf_counter() - t:.1f}s",
              flush=True)
    if not args.multichip and os.path.isdir(os.path.join(ROOT, "tests")):
        import pytest
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          os.path.join(ROOT, "tests", "test_gpu_port.py")])
        if rc not in (0, 5):
            raise RuntimeError(f"gpu-marked tests failed (pytest rc {rc})")
    print(f"total wall {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"card: {card}", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
