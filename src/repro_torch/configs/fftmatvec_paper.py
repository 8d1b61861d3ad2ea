"""The paper's own workload: the FFTMatvec p2o config.

Single-GPU/figure config: N_m=5,000, N_d=100, N_t=1,000 (Figs. 2-3).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FFTMatvecConfig:
    name: str
    N_t: int = 1000
    N_d: int = 100
    N_m: int = 5000
    precision: str = "sssss"


PAPER_SINGLE = FFTMatvecConfig(name="fftmatvec_paper")
