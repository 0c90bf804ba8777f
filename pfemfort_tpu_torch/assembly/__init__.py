from pfemfort_tpu_torch.assembly.pattern import AssemblyPattern, build_pattern
from pfemfort_tpu_torch.assembly.assemble import (
    assemble_dia_values,
    assemble_ell_values,
    assemble_matrix,
    assemble_rhs,
    build_assembly_plan,
    dirichlet_rhs_correction,
)
from pfemfort_tpu_torch.assembly.structured import (
    StructuredPlan,
    assemble_dia_structured,
    assemble_rhs_structured,
    assemble_structured_chunked,
    build_structured_plan,
    reduce_structured_system,
)

__all__ = [
    "AssemblyPattern",
    "build_pattern",
    "assemble_dia_values",
    "assemble_ell_values",
    "assemble_matrix",
    "assemble_rhs",
    "build_assembly_plan",
    "dirichlet_rhs_correction",
    "StructuredPlan",
    "assemble_dia_structured",
    "assemble_rhs_structured",
    "assemble_structured_chunked",
    "build_structured_plan",
    "reduce_structured_system",
]
