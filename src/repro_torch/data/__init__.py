from .pipeline import PipelineState, SyntheticPipeline  # noqa: F401
