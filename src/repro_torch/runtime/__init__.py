from .trainer import PreemptionRequested, Trainer, TrainerConfig  # noqa: F401
from .serve import ServeEngine, Request, Result  # noqa: F401
from .solve_serve import (AdmissionError, SolveEngine,  # noqa: F401
                          SolveOutcome, SolveRequest, operator_fingerprint,
                          tol_bucket)
