"""Global numeric constants (the port's own copy of
`gpu_pathtracer_tpu.constants`; `tests/test_torch_host.py` holds the two equal).

Mirrors the semantics of the reference's `src/param.h:5-7` (SMALL_DOUBLE,
MAX_PHONG_N_S) and assorted hard-coded caps surveyed in SURVEY.md §2.6.
"""

# Global geometric / numeric epsilon (reference: SMALL_DOUBLE, param.h:6).
SMALL_EPS = 1e-5

# Phong exponents at or above this behave as perfect mirrors
# (reference: MAX_PHONG_N_S, param.h:7 and vector_util.h:48).
MAX_PHONG_N_S = 1.0e6

# Priority value representing "no material / vacuum" on the nested-dielectric
# stack (reference: get_material_priority returns 9999999 for nullptr,
# material.h:130-136).
VACUUM_PRIORITY = 9999999

# Refractive index of the ambient medium (nullptr material in the reference,
# material.h:138-144).
VACUUM_IOR = 1.0

# Default capacity of the per-ray nested-dielectric material stack.  The
# reference uses a 400-entry pointer list (pathtracing.h:103); real scenes
# nest a handful of media deep, so a small static stack keeps the wavefront
# state cheap.  Configurable per-render.
MATERIAL_STACK_SIZE = 8

# Max lights collected per ray when evaluating the many-light MIS pdf on the
# sparse (light-tree walk) path (reference caps at 400,
# material_operations.h:36; 32 suffices because geom_pdf is zero for every
# emitter the ray misses and a ray rarely stabs >32 emitter AABBs).  Rays
# that DO overflow are counted (collect_hit_leaves' `dropped` output /
# trace_paths' cap stats).
MAX_POTENTIAL_TARGETS = 32

# Emitter-count threshold between the dense many-lights path (one (R, E)
# importance table + (2E-1, E) ancestor matmul — fastest while E is
# small) and the sparse path (stochastic tree descent + bounded pdf walks —
# O(R * log E) memory, required once E reaches thousands).
LIGHT_TREE_DENSE_MAX = 512
