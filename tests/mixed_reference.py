"""Shared by the CPU and the card tests of the mixed-precision
configuration: its plain reference (portbench/reference/
snavely_huber_mixed.py, imported from its file) and the port's mixed S·y
through the Schur prepare and the PCG's matvec. Imports no JAX."""

import importlib
import importlib.util
import os
import sys

import numpy as np
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg.preconditioners import BlockDiagSolver
from ceres_tpu_torch.linalg.schur_kernels import sy_meta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(ROOT, "portbench")
F32 = torch.float32


def reference():
    """portbench/reference/snavely_huber_mixed.py, imported from its file
    as a submodule of the reference package (it imports snavely_huber
    beside it)."""
    name = "portbench_reference"
    if name not in sys.modules:
        path = os.path.join(PORTBENCH, "reference")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.snavely_huber_mixed")


def mixed_options(**kw):
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        dtype=F32, **{"use_mixed_precision_solves": True, "device": "cpu", **kw})


def rows(handles, width, offsets):
    return offsets[handles][:, None] + np.arange(width)


def port_sy(bal, d_f, d_e, y, device="cpu"):
    """The port's mixed S·y [num_cameras, 9] at the start: the schur_prepare
    cache (its bfloat16 copy) and the PCG's matvec, as an ITERATIVE_SCHUR
    step runs them."""
    problem, cams, pts = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile(device)
    assert sy_meta(program) is not None
    _c, _r, jac, _g = Evaluator(program, F32).evaluate_groups(program.state_vector(F32))
    jac_s = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    options = mixed_options(device=device)
    cache = tschur.schur_prepare(program, options, jac_s)
    n_eff = program.num_effective_parameters
    rc = rows(cams, 9, program.t_offsets)
    rp = rows(pts, 3, program.t_offsets)
    dsq = np.zeros(n_eff)
    dsq[rc], dsq[rp] = d_f ** 2, d_e ** 2
    grad = torch.zeros(n_eff, dtype=F32, device=device)
    inter = tschur.schur_finish_rhs(program, options, jac_s, grad,
                                    torch.tensor(dsq, dtype=F32, device=device), cache)
    ete = BlockDiagSolver.from_inverse_tables(program, inter["ete_inv"])
    jac_m = jac_s._with(jac_groups=cache["jac_mv_groups"], col_scale=None,
                        twins=cache["jac_mv_twins"])
    f_set = tschur._pure_class_split(program)[0]
    matvec = tschur._s_apply_t(program, jac_m, ete, inter["dsq_f_tv"], f_set)
    y_flat = np.zeros(n_eff)
    y_flat[rc] = y
    out = matvec(tschur._f_tvec(program, jac_s, torch.tensor(y_flat, dtype=F32, device=device)))
    widths = [cnt + 1 for cnt in program.tangent_class_counts]
    flat = jac_s.tvec_flat(tschur._expand_tvec(out, f_set, widths))
    return flat.double().cpu().numpy()[rc]
