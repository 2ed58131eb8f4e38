// Kernel B4 (S·y, the PCG matvec of the reduced camera system) at the BA
// shape, (r, tf, te) = (2, 9, 3): the library's instantiation of
// schur_sy.cuh, which describes the kernels. Every other shape within
// sy_meta's bounds is built at first use from a source of its own
// (linalg/schur_kernels.py sy_source) that instantiates the same template.

#include "schur_sy.cuh"

CTT_SCHUR_SY_ENTRY(2, 9, 3)
