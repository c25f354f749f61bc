from .loop import RunResult, host_step, run  # noqa: F401
from .module import (  # noqa: F401
    Dependency,
    HostModule,
    Module,
    PipelineContext,
    StepContext,
    TensorSpec,
)
from .pipeline import Pipeline, PipelineError  # noqa: F401
from .state import state_from_reference, state_to_numpy  # noqa: F401
from .system import DataNotAvailableException, System  # noqa: F401
