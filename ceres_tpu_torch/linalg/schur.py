"""Schur-complement solves (the bundle-adjustment workhorse).

Port of `ceres_tpu.linalg.schur` (reference: implicit_schur_complement.cc,
iterative_schur_complement_solver.cc, schur_complement_solver.cc): the
ITERATIVE_SCHUR prepare/finish split, and `schur_solve`, the un-split step
that also serves SCHUR_POWER_SERIES_EXPANSION, use_spse_initialization,
use_explicit_schur_complement and DENSE_SCHUR. J = [E F] by signature-group
position (BA: E = d r/d point, F = d r/d camera). The PCG on the reduced
camera system runs on f-only tvecs (e-class tables are zero-width
stand-ins) and its matvec is kernel B4 when the problem has the fusable BA
structure (schur_kernels.sy_meta); the SCHUR_JACOBI blocks are kernel B5 on
the same structure:

    t1 = F y;  t2 = (EᵀE + D_e²)⁻¹ Eᵀ t1;  S y = Fᵀ(t1 − E t2) + D_f² y
    back-substitution: dx_e = −(EᵀE + D_e²)⁻¹ (g_e + EᵀF dx_f)

Not ported: the visibility preconditioners (CLUSTER_JACOBI,
CLUSTER_TRIDIAGONAL) and the mixed-precision branches; they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import LinearSolverType, PreconditionerType
from . import schur_kernels
from .cg import conjugate_gradients
from .preconditioners import BlockDiagSolver


def schur_views(program, jac):
    """Split the (scaled) Jacobian into E and F position views."""
    _, e_positions, f_positions = program.compute_schur_partition()
    return jac.position_view(e_positions), jac.position_view(f_positions)


def _e_classes(program):
    return program.cached("e_classes", _compute_e_classes)


def _compute_e_classes(program):
    e_blocks, _, _ = program.compute_schur_partition()
    cls = program.block_class[np.asarray(e_blocks) & (program.block_class >= 0)]
    return {int(c) for c in np.unique(cls)}


def _pure_class_split(program):
    """(f_classes, e_classes) when every tangent class lies entirely on one
    side of the partition (the BA case), else None."""
    return program.cached("pure_split", _compute_pure_class_split)


def _compute_pure_class_split(program):
    _e_mask, f_mask = program.schur_tangent_masks()
    f_set, e_set = set(), set()
    for cls in range(len(program.tangent_class_sizes)):
        base, cnt, s = program.tangent_class_slice(cls)
        seg = np.asarray(f_mask[base : base + cnt * s], dtype=bool)
        if seg.size == 0 or seg.all():
            f_set.add(cls)
        elif not seg.any():
            e_set.add(cls)
        else:
            return None
    return f_set, e_set


def _shrink_tvec(tv, f_set):
    """Replace e-class tables with zero-width stand-ins [s, 0]."""
    return [t if cls in f_set else t[:, :0] for cls, t in enumerate(tv)]


def _expand_tvec(tv, f_set, widths):
    """Inverse of _shrink_tvec (zero-filled e tables)."""
    return [
        t if cls in f_set else t.new_zeros((t.shape[0], widths[cls]))
        for cls, t in enumerate(tv)
    ]


def _wrap_flat_preconditioner(program, prec, f_set):
    """Adapt a flat-vector preconditioner (the power series) to the f-only
    tvec protocol: the CG state is the camera tables, so the flat <-> tvec
    conversion is a [tf, cnt] transpose."""
    num_eff = program.num_effective_parameters

    def apply_t(tv):
        flat = tv[next(iter(f_set))].new_zeros((num_eff,))
        for cls in f_set:
            base, cnt, s = program.tangent_class_slice(cls)
            flat[base : base + cnt * s] = tv[cls][:, :cnt].T.reshape(-1)
        out_flat = prec(flat)
        out = []
        for cls, t in enumerate(tv):
            if cls not in f_set:
                out.append(t)
                continue
            base, cnt, s = program.tangent_class_slice(cls)
            tbl = out_flat[base : base + cnt * s].reshape(cnt, s).T
            if t.shape[1] > cnt:
                tbl = torch.cat([tbl, tbl.new_zeros((s, t.shape[1] - cnt))], dim=1)
            out.append(tbl)
        return out

    return apply_t


def add_dsq_T(program, tables, dsq):
    """tables[cls] [s*s, cnt] += diag(dsq) per block."""
    from ..evaluator import tangent_tables

    dt = tangent_tables(program, dsq)
    out = []
    for cls, acc in enumerate(tables):
        if acc is None:
            out.append(None)
            continue
        s = program.tangent_class_sizes[cls]
        diag_rows = torch.as_tensor(np.arange(s) * s + np.arange(s), device=acc.device)
        out.append(acc.index_add(0, diag_rows, dt[cls].T))
    return out


def make_ete_solver(program, jac_e, dsq_e):
    """(EᵀE + D_e²)⁻¹ as per-class block inverses."""
    e_classes = _e_classes(program)
    blocks = jac_e.block_diag_jtj(dsq=dsq_e, class_ids=e_classes)
    return BlockDiagSolver(program, blocks, only_classes=e_classes)


def ete_gram_tables(program, jac_e):
    """Per-class EᵀE tables without the LM diagonal (reused across
    rejected steps, where only the radius moves)."""
    e_classes = _e_classes(program)
    tables = jac_e.block_diag_jtj(dsq=None, class_ids=e_classes)
    return [t if cls in e_classes else None for cls, t in enumerate(tables)]


def ete_solver_from_gram(program, gram_tables, dsq_e):
    """(EᵀE + D_e²)⁻¹ from cached grams and the current LM diagonal."""
    blocks = add_dsq_T(program, list(gram_tables), dsq_e)
    return BlockDiagSolver(program, blocks, only_classes=_e_classes(program))


def schur_jacobi_blocks(program, jac_e, jac_f, ete_solver, dsq_f):
    """Block diagonal of S for SCHUR_JACOBI, composed from plain products:
    S_cc = Σ_o F_oᵀF_o + D_f² − Σ_o F_oᵀE_o M_p(o)⁻¹ E_oᵀF_o per f-block c
    (the BA structure; extra cross terms are dropped, which only affects
    preconditioner quality). reference: schur_jacobi_preconditioner.cc.
    The e-side column scale is applied per lane, the f-side one after the
    reduce (every lane of an f-block shares its scale). Returns per-class
    [s*s, count] tables."""
    from ..evaluator import tangent_tables
    from ..jacobian import gather_T, reduce_T

    ftf = jac_f.block_diag_jtj(dsq=dsq_f)
    cs = jac_f.col_scale
    scale_tables = tangent_tables(program, cs, pad_zero_row=True) if cs is not None else None
    corrections = [torch.zeros_like(b) for b in ftf]
    for gi in range(len(jac_f.jac_groups)):
        if not jac_e.jac_groups[gi]:
            continue
        meta = program.groups[gi]
        garr = jac_f.garrs[gi]
        n, r = meta.n, meta.num_residuals
        e_pos = jac_e.positions[gi][0]
        e_pm = meta.positions[e_pos]
        te = e_pm.tangent_size
        e_plan, e_rows = jac_e.plan(gi, e_pos), garr["t_rows"][e_pos]
        minv = gather_T(e_plan, ete_solver.inv_tables[e_pm.t_cls].T, e_rows).reshape(te, te, n)
        ej = jac_e.jac_groups[gi][0].reshape(r, te, n)
        if scale_tables is not None:
            ej = ej * gather_T(e_plan, scale_tables[e_pm.t_cls], e_rows)[None]
        for f_pos, f_jac in zip(jac_f.positions[gi], jac_f.jac_groups[gi]):
            pm = meta.positions[f_pos]
            if pm.t_cls < 0:
                continue
            cnt = program.tangent_class_counts[pm.t_cls]
            tf = pm.tangent_size
            fj = f_jac.reshape(r, tf, n)
            etf = (ej[:, :, None, :] * fj[:, None, :, :]).sum(dim=0)
            minvetf = (minv[:, :, None, :] * etf[None, :, :, :]).sum(dim=1)
            corr = (etf[:, :, None, :] * minvetf[:, None, :, :]).sum(dim=0).reshape(tf * tf, n)
            tbl = reduce_T(
                jac_f.plan(gi, f_pos), corr, garr["t_rows"][f_pos], cnt + 1, garr["csr"].get(f_pos)
            )[:, :cnt]
            if scale_tables is not None:
                stf = scale_tables[pm.t_cls][:cnt].T  # [tf, cnt]
                tbl = tbl * (stf[:, None, :] * stf[None, :, :]).reshape(tf * tf, cnt)
            corrections[pm.t_cls] = corrections[pm.t_cls] + tbl
    return [f - c for f, c in zip(ftf, corrections)]


def _sy_meta(program):
    return program.cached("sy_meta", schur_kernels.sy_meta)


def _p0_tables(program, jac_m, meta, ete):
    """Per-class SCHUR_JACOBI tables without the LM diagonal through B5, from
    the twins of the scale-materialized Jacobian (E's in F's camera order,
    made here once per Jacobian) and the e-class inverse blocks of the
    BlockDiagSolver `ete`."""
    f_pos, e_pos = meta["f_pos"], meta["e_pos"]
    F_twin = jac_m.twin(0, f_pos)
    tbl = schur_kernels.p0_apply(
        meta, F_twin, jac_m.twin(0, e_pos, f_pos),
        program.slot_rows(0, e_pos, f_pos, F_twin.device), jac_m.garrs[0]["csr"][f_pos],
        ete.inv_records(meta["e_cls"]),
    )
    return [
        tbl if cls == meta["f_cls"] else None
        for cls in range(len(program.tangent_class_sizes))
    ]


def ridge_ete_solver(program, e_gram0, colnorm2):
    """(EᵀE + ridge)⁻¹ with ridge = 100·eps·colnorm2 on the e-columns and no
    LM diagonal: the M0⁻¹ of the cached SCHUR_JACOBI correction. Weakly
    observed points would make a bare (EᵀE)⁻¹ explode in float32; since
    corr(ridge) <= corr(0) <= FᵀF, P stays SPD for every later radius."""
    e_mask, _ = _masks(program, colnorm2)
    ridge = 100.0 * torch.finfo(colnorm2.dtype).eps
    return ete_solver_from_gram(program, e_gram0, ridge * colnorm2 * e_mask)


def schur_prepare(program, options, jac_s):
    """J-dependent (radius-independent) half of an ITERATIVE_SCHUR step:
    column norms, the EᵀE grams, the preconditioner's tables (JACOBI: FᵀF
    blocks; SCHUR_JACOBI: FᵀF − FᵀE M0⁻¹ EᵀF blocks, kernel B5) and the
    scale-materialized leaves and their twins (F's, and E's in F's camera
    order) that B5 and the PCG matvec B4 read. Reused while
    steps are rejected (reference: Preconditioner::Update split from
    creation)."""
    precond = options.preconditioner_type
    if precond not in (
        PreconditionerType.SCHUR_JACOBI, PreconditionerType.JACOBI, PreconditionerType.IDENTITY
    ):
        raise NotImplementedError(
            f"schur_prepare takes SCHUR_JACOBI, JACOBI or IDENTITY, not {precond.value} "
            "(schur_solve runs the others)"
        )
    jac_e, jac_f = schur_views(program, jac_s)
    colnorm2 = jac_s.squared_column_norms()
    e_gram0 = ete_gram_tables(program, jac_e)
    jac_m = jac_s.materialize_scale()
    meta = _sy_meta(program)
    if meta is not None:
        # E's twin in F's camera order, read by B4 (every preconditioner)
        # and B5
        jac_m.twin(0, meta["e_pos"], meta["f_pos"])
    p0 = None
    if precond == PreconditionerType.SCHUR_JACOBI:
        minv0 = ridge_ete_solver(program, e_gram0, colnorm2)
        if meta is not None:
            p0 = _p0_tables(program, jac_m, meta, minv0)
        else:
            p0 = schur_jacobi_blocks(program, jac_e, jac_f, minv0, torch.zeros_like(colnorm2))
    elif precond == PreconditionerType.JACOBI:
        p0 = jac_f.block_diag_jtj(dsq=None)
    return {
        "colnorm2": colnorm2,
        "e_gram0": e_gram0,
        "p0": p0,
        "jac_mv_groups": jac_m.jac_groups,
        "jac_mv_twins": jac_m.twins,
    }


def _masks(program, like):
    """(e_mask, f_mask) tangent masks as tensors like `like`."""
    return program.cached(
        ("masks", like.dtype, like.device),
        lambda p: tuple(
            torch.as_tensor(m, dtype=like.dtype, device=like.device)
            for m in p.schur_tangent_masks()
        ),
    )


def schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache):
    """Radius-dependent first half: (EᵀE + D_e²)⁻¹, the preconditioner and
    the reduced-system rhs = −g_f + FᵀE M⁻¹ g_e."""
    e_mask, f_mask = _masks(program, grad_s)
    jac_e, jac_f = schur_views(program, jac_s)
    g_e = grad_s * e_mask
    ete = ete_solver_from_gram(program, cache["e_gram0"], dsq * e_mask)
    prec_inv = None
    if cache["p0"] is not None:
        split = _pure_class_split(program)
        blocks = add_dsq_T(program, list(cache["p0"]), dsq * f_mask)
        prec_inv = BlockDiagSolver(
            program, blocks, only_classes=split[0] if split is not None else None
        ).inv_tables
    rhs = -(grad_s * f_mask) + jac_f.left_multiply(jac_e.right_multiply(ete(g_e)))
    return {"ete_inv": dict(ete.inv_tables), "prec_inv": prec_inv, "rhs": rhs}


def _s_apply_t(program, jac_m, ete, dsq_f_tv, f_set):
    """S·y on (f-only) tvecs from the scale-materialized Jacobian jac_m:
    kernel B4 on the fusable BA structure, else the composed products."""
    meta_sy = _sy_meta(program)
    if meta_sy is None:
        jac_e_mv, jac_f_mv = schur_views(program, jac_m)

        def s_apply_t(y_tv):
            t1 = jac_f_mv.right_multiply_t(y_tv)
            t2 = ete.apply_t(jac_e_mv.left_multiply_t(t1))
            et2 = jac_e_mv.right_multiply_t(t2)
            out = jac_f_mv.left_multiply_t([a - b for a, b in zip(t1, et2)])
            if f_set is not None:
                out = _shrink_tvec(out, f_set)
            return [o + d * y for o, d, y in zip(out, dsq_f_tv, y_tv)]

        return s_apply_t

    f_cls = meta_sy["f_cls"]
    garr = jac_m.garrs[0]
    f_pos, e_pos = meta_sy["f_pos"], meta_sy["e_pos"]
    F, E = jac_m.jac_groups[0][f_pos], jac_m.jac_groups[0][e_pos]
    # the slot pass's camera-ordered inputs: the F and E twins, each slot's
    # point row and the camera layout
    slot_order = (
        jac_m.twin(0, f_pos), jac_m.twin(0, e_pos, f_pos),
        program.slot_rows(0, e_pos, f_pos, F.device), garr["csr"][f_pos],
    )
    minv = ete.inv_tables[meta_sy["e_cls"]]
    dsq = dsq_f_tv[f_cls].contiguous()
    segs = program.cached(
        ("sy_tables", F.device), lambda p: schur_kernels.sy_tables(meta_sy, F.device)
    )

    def s_apply_t(y_tv):
        # + D_f² y, and the dump column stays out of the CG vectors
        out_f = schur_kernels.sy_apply(
            meta_sy, F, E, garr["t_rows"][f_pos], *slot_order, y_tv[f_cls].contiguous(), minv,
            segs, dsq,
        )
        return [out_f if cls == f_cls else torch.zeros_like(y) for cls, y in enumerate(y_tv)]

    return s_apply_t


def _tvec_pcg(program, options, jac_s, jac_m, ete, dsq_f, rhs, prec, x0=None):
    """PCG on the reduced camera system in tvec form. `prec` is a
    BlockDiagSolver, a flat-vector preconditioner or None. Returns the flat
    solution (unmasked) and the iteration count."""
    dsq_f_tv = jac_s.tvec(dsq_f)
    b_tv = jac_s.tvec(rhs)
    x0_tv = None if x0 is None else jac_s.tvec(x0)
    widths = [t.shape[1] for t in b_tv]
    split = _pure_class_split(program)
    f_set = split[0] if split is not None else None
    if f_set is not None:
        dsq_f_tv = _shrink_tvec(dsq_f_tv, f_set)
        b_tv = _shrink_tvec(b_tv, f_set)
        if x0_tv is not None:
            x0_tv = _shrink_tvec(x0_tv, f_set)
    if prec is None:
        prec_t = None
    elif isinstance(prec, BlockDiagSolver):
        prec_t = prec.apply_t
    else:
        prec_t = _wrap_flat_preconditioner(program, prec, f_set)
    result = conjugate_gradients(
        matvec=_s_apply_t(program, jac_m, ete, dsq_f_tv, f_set),
        b=b_tv,
        x0=x0_tv,
        preconditioner=prec_t,
        max_iterations=options.max_linear_solver_iterations,
        min_iterations=options.min_linear_solver_iterations,
        tolerance=0.0,
        q_tolerance=options.eta,
    )
    x_tv = result.x
    if f_set is not None:
        x_tv = _expand_tvec(x_tv, f_set, widths)
    return jac_s.tvec_flat(x_tv), result.iterations


def _back_substitute(jac_e, jac_f, ete, g_e, e_mask, dx_f):
    """dx_f + dx_e with dx_e = −(EᵀE + D_e²)⁻¹ (g_e + EᵀF dx_f)."""
    etfdx = jac_e.left_multiply(jac_f.right_multiply(dx_f))
    return dx_f + (-ete(g_e + etfdx) * e_mask)


def schur_finish_solve(program, options, jac_s, grad_s, dsq, cache, inter):
    """Second half: the tvec PCG on the reduced camera system and the
    e-block back-substitution. Returns (step, pcg iterations)."""
    e_mask, f_mask = _masks(program, grad_s)
    jac_e, jac_f = schur_views(program, jac_s)
    ete = BlockDiagSolver.from_inverse_tables(program, inter["ete_inv"])
    prec = (
        BlockDiagSolver.from_inverse_tables(program, inter["prec_inv"])
        if inter["prec_inv"] is not None
        else None
    )
    jac_m = jac_s._with(
        jac_groups=cache["jac_mv_groups"], col_scale=None, twins=cache["jac_mv_twins"]
    )
    x, iterations = _tvec_pcg(
        program, options, jac_s, jac_m, ete, dsq * f_mask, inter["rhs"], prec
    )
    step = _back_substitute(jac_e, jac_f, ete, grad_s * e_mask, e_mask, x * f_mask)
    return step, iterations


def schur_finish(program, options, jac_s, res_groups, grad_s, dsq, cache):
    """Radius-dependent half: rhs/preconditioner + PCG + back-substitution.
    Returns (step, pcg iterations)."""
    inter = schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache)
    return schur_finish_solve(program, options, jac_s, grad_s, dsq, cache, inter)


def make_power_series_applier(program, jac_e, jac_f, ete, dsq_f, spse_tolerance, max_iterations):
    """y ≈ S⁻¹x by the truncated Neumann series around P = blockdiag(FᵀF + D_f²)
    (reference: power_series_expansion_preconditioner.cc:51-72 with
    implicit_schur_complement.cc:146-172):

        y_0 = P⁻¹x;  term_i = P⁻¹ FᵀE (EᵀE + D_e²)⁻¹ EᵀF term_{i−1}
        y = y_0 + term_1 + ... until i >= max_iterations or
            |term_i| < spse_tolerance·|y_0|

    Serves as the SCHUR_POWER_SERIES_EXPANSION preconditioner and as the
    use_spse_initialization PCG warm start; the norms come to the host."""
    ftf_inv = BlockDiagSolver(program, jac_f.block_diag_jtj(dsq=dsq_f))
    max_iterations = max(0, int(max_iterations))

    def series_term(prev):
        t2 = ete(jac_e.left_multiply(jac_f.right_multiply(prev)))
        return ftf_inv(jac_f.left_multiply(jac_e.right_multiply(t2)))

    def apply(x):
        y = ftf_inv(x)
        threshold = spse_tolerance * float(torch.linalg.norm(y))
        term = y
        for _ in range(max_iterations):
            term = series_term(term)
            y = y + term
            if float(torch.linalg.norm(term)) < threshold:
                break
        return y

    return apply


def _f_positions(program, device):
    return program.cached(
        ("f_positions", device),
        lambda p: torch.as_tensor(np.nonzero(p.schur_tangent_masks()[1])[0], device=device),
    )


def _dense_schur(s_apply, f_pos, like):
    """S restricted to the f-coordinates [nf, nf], materialized column by
    column through the working-precision operator and symmetrized (the
    reduction order leaves S a rounding away from symmetric)."""
    cols = []
    for j in f_pos.tolist():
        e = like.new_zeros(like.shape)
        e[j] = 1.0
        cols.append(s_apply(e)[f_pos])
    s_dense = torch.stack(cols)
    return 0.5 * (s_dense + s_dense.T)


def _schur_jacobi_preconditioner(program, jac_m, jac_e, jac_f, ete, dsq_f):
    """SCHUR_JACOBI from the current (EᵀE + D_e²)⁻¹: kernel B5 on the fusable
    BA structure (read from the scale-materialized jac_m), else
    schur_jacobi_blocks; then + D_f²."""
    meta = _sy_meta(program)
    if meta is None:
        return BlockDiagSolver(program, schur_jacobi_blocks(program, jac_e, jac_f, ete, dsq_f))
    p0 = _p0_tables(program, jac_m, meta, ete)
    return BlockDiagSolver(program, add_dsq_T(program, p0, dsq_f))


def _iterative_schur(program, options, jac_s, ete, dsq_f, rhs, s_apply):
    """The ITERATIVE_SCHUR branch of schur_solve: the preconditioner, the
    optional explicit S and power-series warm start, and the PCG. Returns
    (dx_f unmasked, iterations)."""
    precond = options.preconditioner_type
    jac_e, jac_f = schur_views(program, jac_s)
    jac_m = jac_s.materialize_scale()  # read by B5 and by the tvec PCG
    _, f_mask = _masks(program, rhs)
    explicit = options.use_explicit_schur_complement
    if explicit:
        # S on the f-coordinates, materialized once; each PCG step is then
        # one dense product (reference: use_explicit_schur_complement)
        f_pos = _f_positions(program, rhs.device)
        s_dense = _dense_schur(s_apply, f_pos, rhs)

        def s_apply(y):
            return torch.zeros_like(y).index_copy(0, f_pos, s_dense @ y[f_pos])

    prec = None
    if precond == PreconditionerType.SCHUR_JACOBI:
        prec = _schur_jacobi_preconditioner(program, jac_m, jac_e, jac_f, ete, dsq_f)
    elif precond == PreconditionerType.JACOBI:
        prec = BlockDiagSolver(program, jac_f.block_diag_jtj(dsq=dsq_f))
    elif precond == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION:
        prec = make_power_series_applier(
            program, jac_e, jac_f, ete, dsq_f,
            options.spse_tolerance, max(1, options.max_num_spse_iterations),
        )
    x0 = None
    if options.use_spse_initialization:
        # PCG warm start from a truncated power-series solve of S x = rhs
        # (reference: iterative_schur_complement_solver.cc:95-107)
        x0 = make_power_series_applier(
            program, jac_e, jac_f, ete, dsq_f,
            options.spse_tolerance, options.max_num_spse_iterations,
        )(rhs) * f_mask

    exotic = precond == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION
    if explicit or (exotic and _pure_class_split(program) is None):
        result = conjugate_gradients(
            matvec=s_apply,
            b=rhs,
            x0=x0,
            preconditioner=prec,
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            tolerance=0.0,
            q_tolerance=options.eta,
        )
        return result.x, result.iterations
    return _tvec_pcg(program, options, jac_s, jac_m, ete, dsq_f, rhs, prec, x0)


def schur_solve(program, options, jac_s, res_groups, grad_s, dsq):
    """Solve (JᵀJ + diag(dsq)) step = −grad through the Schur complement:
    the implicit S with PCG (ITERATIVE_SCHUR), or the dense S materialized
    through the implicit operator and factored (DENSE_SCHUR). Returns
    (step [num_eff], linear iterations)."""
    precond = options.preconditioner_type
    iterative = options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR
    if options.use_mixed_precision_solves:
        raise NotImplementedError(
            "use_mixed_precision_solves is not ported yet (ROADMAP Queue A: mixed precision)"
        )
    if iterative and precond in (
        PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL
    ):
        raise NotImplementedError(
            f"{precond.value} is not ported yet (ROADMAP Queue A: visibility preconditioners)"
        )
    e_mask, f_mask = _masks(program, grad_s)
    jac_e, jac_f = schur_views(program, jac_s)
    dsq_f = dsq * f_mask
    g_e = grad_s * e_mask
    ete = make_ete_solver(program, jac_e, dsq * e_mask)

    def s_apply(y):
        t1 = jac_f.right_multiply(y)
        t2 = ete(jac_e.left_multiply(t1))
        et2 = jac_e.right_multiply(t2)
        return jac_f.left_multiply([a - b for a, b in zip(t1, et2)]) + dsq_f * y

    # rhs = -g_f + F^T E M^-1 g_e
    rhs = -(grad_s * f_mask) + jac_f.left_multiply(jac_e.right_multiply(ete(g_e)))
    if iterative:
        x, lin_iters = _iterative_schur(program, options, jac_s, ete, dsq_f, rhs, s_apply)
        dx_f = x * f_mask
    else:
        # DENSE_SCHUR: Cholesky of the dense S (reference:
        # schur_complement_solver.cc dense path); a failed factorization
        # gives a non-finite step, which the trust-region loop rejects
        f_pos = _f_positions(program, grad_s.device)
        chol, info = torch.linalg.cholesky_ex(_dense_schur(s_apply, f_pos, grad_s))
        y = torch.cholesky_solve(rhs[f_pos][:, None], chol)[:, 0]
        y = torch.where(info == 0, y, torch.full_like(y, float("nan")))
        dx_f = torch.zeros_like(grad_s).index_copy(0, f_pos, y)
        lin_iters = 1
    return _back_substitute(jac_e, jac_f, ete, g_e, e_mask, dx_f), lin_iters
