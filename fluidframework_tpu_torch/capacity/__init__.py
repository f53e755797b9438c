"""Fleet-scale capacity soak: seeded open-loop workload models, the
whole-pipeline virtual-clock soak driver, and the SLO capacity grader
(docs/capacity.md; `make e2e-smoke` is the graded entry point)."""

from .fleet import FleetSoak, FleetSpec, SoakResult  # noqa: F401
from .grader import (  # noqa: F401
    CapacityGrader,
    GradeResult,
    GradeSample,
    attribute_bottleneck,
)
from .workload import (  # noqa: F401
    BURSTY,
    POISSON,
    OnOffArrivals,
    OpMix,
    PoissonArrivals,
    TickPlan,
    WorkloadModel,
    WorkloadSpec,
    ZipfPopularity,
    closed_loop_schedule,
    poisson_draw,
)
