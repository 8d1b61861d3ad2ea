from .serve import ServeEngine, Request, Result  # noqa: F401
