from .fftmatvec_paper import FFTMatvecConfig, PAPER_SINGLE  # noqa: F401
