"""Scaling-report harness (tools/scaling_report.py): the compiled
distributed DIA power step must move O(bandwidth) bytes per halo
exchange — independent of n — and the report's efficiency bound must
clear the BASELINE north star (>= 0.80)."""

import sys
import os

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.scaling_report import PEAKS, build_step, collective_bytes


def _comm(n, bandwidth, n_devices):
    step, A, x0, nnz = build_step(n, bandwidth, n_devices)
    txt = step.lower(A.data, x0).compile().as_text()
    return collective_bytes(txt), A


class TestHaloCommVolume:
    def test_halo_bytes_are_bandwidth_not_n(self):
        comm_small, A_small = _comm(4096, 16, 8)
        comm_big, A_big = _comm(16384, 16, 8)
        # two matvecs/step x two directions x halo entries x 4 bytes
        expect = 2 * 2 * A_small.halo * 4
        assert comm_small["collective-permute"] == expect
        assert comm_big["collective-permute"] == expect  # n-independent

    def test_halo_scales_with_bandwidth(self):
        comm_a, _ = _comm(4096, 8, 8)
        comm_b, _ = _comm(4096, 32, 8)
        assert comm_b["collective-permute"] == 4 * comm_a["collective-permute"]

    def test_reductions_are_scalar(self):
        comm, _ = _comm(4096, 16, 8)
        # psum_norm + psum_vdot: two f32 scalars per step
        assert comm["all-reduce"] == 8

    def test_efficiency_bound_clears_north_star(self):
        comm, A = _comm(65536, 16, 8)
        nnz = 65536 * 33
        local_bytes = nnz * 2 / 8
        t_compute = local_bytes / PEAKS["hbm_bytes_per_s"]
        t_comm = comm["collective-permute"] / PEAKS["link_bytes_per_s"]
        bound = t_compute / (t_compute + t_comm)
        assert bound >= 0.80


class TestGELLPrunedCommVolume:
    def test_plan_matches_hlo_and_is_n_independent(self):
        from tools.scaling_report import build_gell_step
        from pcsc_eigenvalue_solver_project_tpu.parallel.gell_pruned import _args
        comms, plans = [], []
        for n in (16384, 65536):
            step, A, x0, nnz = build_gell_step(n, 16, 2, 8)
            txt = step.lower(*_args(A, x0)).compile().as_text()
            comms.append(collective_bytes(txt))
            plans.append(A.comm_bytes_per_matvec)
        # HLO collective-permute bytes == 2 matvecs x static plan bytes
        assert comms[0]["collective-permute"] == 2 * plans[0]
        assert comms[1]["collective-permute"] == 2 * plans[1]
        # footprint-sized, not n-sized (all_gather would quadruple)
        assert abs(plans[1] - plans[0]) <= 2 * 128 * 4

    def test_efficiency_bound_clears_north_star(self):
        from tools.scaling_report import build_gell_step
        step, A, x0, nnz = build_gell_step(65536, 16, 2, 8)
        local_bytes = nnz * 8 / 8
        t_compute = local_bytes / PEAKS["hbm_bytes_per_s"]
        t_comm = A.comm_bytes_per_matvec / PEAKS["link_bytes_per_s"]
        assert t_compute / (t_compute + t_comm) >= 0.80
