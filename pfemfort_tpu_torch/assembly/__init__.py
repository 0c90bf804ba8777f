from pfemfort_tpu_torch.assembly.structured import (
    StructuredPlan,
    assemble_dia_structured,
    assemble_rhs_structured,
    assemble_structured_chunked,
    build_structured_plan,
    reduce_structured_system,
)

__all__ = [
    "StructuredPlan",
    "assemble_dia_structured",
    "assemble_rhs_structured",
    "assemble_structured_chunked",
    "build_structured_plan",
    "reduce_structured_system",
]
