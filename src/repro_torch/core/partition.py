"""Communication-aware 2-D processor-grid partitioning (paper §2.4 / [44]
§3.7), pure arithmetic copied from the JAX package's twin (the port
imports nothing from it).

FFTMatvec runs on a ``p_r x p_c`` grid.  For small-to-moderate device
counts a single row (``p_r = 1``) is optimal: the F matvec then has only
the Phase-5 reduction and the F* matvec only the Phase-1 broadcast.  At
scale those collectives span several network tiers (racks on Frontier,
pods on TPU) and are *latency-bound* (paper: 0.8 MB data-vector buffers
against a 100 GB/s NIC).  The paper's fix, more grid rows at 1,024+ GPUs
(8 rows at 1-2k, 16 at 4k), is a *hierarchical* blocking of the
reduction: reduce within a row (one fast-domain group) first, then across
rows, instead of one flat log2(p)-deep tree whose every hop pays the slow
tier's latency.

This module models that: a two-tier LogGP-style collective cost, a
hierarchical reduce/broadcast built from the grid, and a brute-force grid
search.  The :class:`NetworkModel` constants are the paper's Frontier
calibration, set so that ``choose_grid`` reproduces the published grids
((1, p) through 512 devices, 8 rows at 1,024-2,048, 16 at 4,096;
``paper_grid``).  They are not times measured on any card: on an H100
host the collectives run over NVLink, whose figures wait for a machine
with more than one card.  ``TPU_POD_NETWORK`` is the TPU analogue (a
256-device fast domain), the default of ``launch.mesh.fftmatvec_grid`` as
in the JAX package, so both packages pick the same grids.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Two-tier collective cost constants.

    ``devices_per_tier`` is the *fast-domain* size: a contiguous group
    larger than this spans the slow tier (cross-rack Slingshot on
    Frontier, DCN on TPU) and pays ``alpha_inter``/``bw_inter`` instead of
    ``alpha_intra``/``bw_intra``.  ``flat_grid_max`` is the measured
    crossover below which the flat 1 x p grid stays optimal regardless of
    the model (the paper reports p_r = 1 through 512 GPUs even though 512
    already spans two racks — the collectives are small enough that grid
    rows cost more in F* parameter-chunk reduction than they save);
    ``choose_grid`` short-circuits there and searches only above it.

    The defaults are Frontier-flavored and *calibrated*, not datasheet
    numbers: ``bw_inter`` is the effective per-device share of the
    cross-tier links for the paper's latency-bound ~0.8 MB data-vector
    collectives (far below the NIC line rate), and the alpha ratio is set
    so the modeled optima reproduce the §4.2.2 grids exactly at the
    published device counts .
    """

    devices_per_tier: int = 256      # fast-domain size (rack / TPU pod)
    flat_grid_max: int = 512         # measured flat-grid crossover (paper)
    alpha_intra: float = 2e-6        # s per hop (intra-rack / ICI)
    alpha_inter: float = 25e-6       # s per hop (cross-rack / DCN)
    bw_intra: float = 5.0e10         # B/s per device (fast fabric)
    bw_inter: float = 2.5e9          # B/s per device (effective cross-tier
                                     # share for small latency-bound msgs)
    overlap_efficiency: float = 0.7  # fraction of a chunk's reduction the
                                     # next chunk's compute hides (DESIGN.md
                                     # §9) — 0 = no hiding (chunking only
                                     # adds latency trees), 1 = all but the
                                     # last chunk's reduction is free
    overlap_calibrated: bool = False  # True when overlap_efficiency came
                                      # from a persisted calibrate_overlap
                                      # measurement rather than the 0.7
                                      # default (backend.calibrated_network)

    def collective_cost(self, group: int, bytes_local: int,
                        spans_tiers: bool, chunks: int = 1,
                        hide_s: float | None = None) -> float:
        """Tree/ring collective over ``group`` devices, ``bytes_local``
        payload per device: log2(g) latency hops + (g-1)/g bandwidth.

        ``chunks > 1`` prices the *pipelined* schedule (DESIGN.md §9/§10):
        the payload splits into K chunk reductions of bytes/K — each still
        pays the FULL log2(g) latency tree (latency replicates per chunk,
        only bandwidth divides) — and all but the last chunk's reduction
        hides under the next chunk's compute::

            cost = K * t_chunk - (K - 1) * hidden
            hidden = overlap_efficiency * t_chunk            (unbounded)
                   = min(eff * t_chunk, hide_s / K)          (bounded)

        The unbounded form is the PR-8 formula rewritten (algebraically
        identical to ``t_chunk * (1 + (1-eff)(K-1))``).  ``hide_s`` — the
        super-stage's total local compute time — bounds the hiding by the
        per-chunk compute window: a reduction cannot hide under less
        compute than actually runs beside it.  The bound is what makes a
        *calibrated* efficiency observable in grid selection: without it,
        eff multiplies every candidate's cost by the same scalar and can
        never change an argmin; with it, grids whose chunk reductions
        outlast the compute window saturate while cheaper-per-chunk grids
        keep hiding.  At ``overlap_efficiency = 0`` chunking is strictly
        worse than the flat collective (K latency trees instead of one),
        which is what keeps the model honest: pipelining pays only when
        the collective is bandwidth-dominated or the overlap is real.
        """
        if group <= 1:
            return 0.0
        alpha = self.alpha_inter if spans_tiers else self.alpha_intra
        bw = self.bw_inter if spans_tiers else self.bw_intra
        chunks = max(1, chunks)
        t_chunk = (math.log2(group) * alpha
                   + bytes_local / chunks * (group - 1) / group / bw)
        hidden = self.overlap_efficiency * t_chunk
        if hide_s is not None:
            hidden = min(hidden, hide_s / chunks)
        return chunks * t_chunk - (chunks - 1) * hidden


# TPU analogue: the fast domain is one ICI pod (256 chips) and grids go
# hierarchical as soon as a collective would leave it — there is no
# Frontier-style measured flat plateau past the pod boundary.
TPU_POD_NETWORK = NetworkModel(devices_per_tier=256, flat_grid_max=256)


def hierarchical_collective_time(p_r: int, p_c: int, bytes_local: int,
                                 net: NetworkModel = NetworkModel(),
                                 chunks: int = 1,
                                 hide_s: float | None = None) -> float:
    """Reduce (or broadcast) of a ``bytes_local`` buffer over all
    p = p_r*p_c devices, blocked by the grid: within rows (contiguous ->
    fast domain when p_c fits a tier) then across rows (slow tier).
    ``p_r = 1`` degenerates to the flat collective; ``chunks > 1`` prices
    the pipelined schedule (both tiers chunk together — the super-stage
    splits the *payload*, and every chunk runs the full staged
    reduction).  ``hide_s`` bounds each tier's hiding by the per-chunk
    compute window (see :meth:`NetworkModel.collective_cost`); applying
    the bound per tier can over-credit by up to one window when both
    tiers saturate, an acceptable slack for an argmin heuristic that the
    end-to-end calibrated efficiency absorbs."""
    row_spans = p_c > net.devices_per_tier
    cross_spans = p_r > 1 and (p_r * p_c) > net.devices_per_tier
    return (net.collective_cost(p_c, bytes_local, row_spans, chunks, hide_s)
            + net.collective_cost(p_r, bytes_local, cross_spans, chunks,
                                  hide_s))


def matvec_comm_time(p_r: int, p_c: int, N_t: int, N_d: int, N_m: int,
                     bytes_per_elem: int = 8,
                     net: NetworkModel = NetworkModel(),
                     chunks: int = 1,
                     hide_s: float | None = None) -> float:
    """Modeled communication of one F matvec + one F* matvec.

    Models the paper's accounting: the *data-vector* collectives (F's
    Phase-5 reduce, F*'s Phase-1 broadcast) are the scaling bottleneck —
    0.8 MB buffers against multi-tier latency, i.e. latency-bound — and
    the grid hierarchically blocks them.  (Our eq.-6 decomposition also
    reduces parameter chunks over the p_r rows in F*; that term favors
    small p_r and is excluded from grid *selection* to match [44] §3.7 —
    see DESIGN.md §6 for the accounting.)  ``chunks`` prices the
    pipelined-collective schedule under ``net.overlap_efficiency``;
    ``hide_s`` is the super-stage's local compute time bounding the
    hiding (None = unbounded, the PR-8 formula)."""
    d_bytes = N_t * math.ceil(N_d / p_r) * bytes_per_elem
    # F: phase-5 reduce of d; F*: phase-1 broadcast of d (same structure)
    return 2.0 * hierarchical_collective_time(p_r, p_c, d_bytes, net, chunks,
                                              hide_s)


def choose_grid(p: int, N_t: int, N_d: int, N_m: int,
                bytes_per_elem: int = 8,
                net: NetworkModel = NetworkModel(),
                chunks: int = 1,
                hide_s: float | None = None) -> tuple[int, int]:
    """Brute-force the divisor pairs of ``p`` for the cheapest modeled
    comm.  Rows are capped at N_d (a row without sensors does no work).
    Up to ``net.flat_grid_max`` devices the flat grid is returned outright
    (the paper's measured regime: p_r = 1 through 512 GPUs — extra rows
    only add the F* parameter-chunk reduction); the search runs above it.
    ``chunks`` costs every candidate under the pipelined schedule.  Note
    pipelining shifts the cost balance toward latency (each chunk pays
    the full log2 tree while bandwidth divides), so the modeled optimum
    under ``chunks > 1`` may legitimately prefer fewer slow-tier hops
    than the serial-schedule grid — selection stays honest rather than
    pinned.  ``hide_s`` (the super-stage's local compute window) bounds
    the hiding per chunk; with it, a *calibrated*
    ``net.overlap_efficiency`` (see ``backend.calibrate_overlap``) can
    legitimately move the argmin — grids whose chunk reductions outlast
    the compute window stop benefiting from a higher efficiency.

    Under the default :class:`NetworkModel` at ``chunks = 1`` this agrees
    with :func:`paper_grid` at every device count the paper reports
    (8/512/1,024/2,048/4,096) — asserted in
    ``tests/test_distributed.py``, alongside the overlap-term consistency
    checks."""
    if p <= net.flat_grid_max:
        return (1, p)
    best, best_t = (1, p), float("inf")
    for p_r in range(1, min(p, N_d) + 1):
        if p % p_r:
            continue
        p_c = p // p_r
        t = matvec_comm_time(p_r, p_c, N_t, N_d, N_m, bytes_per_elem, net,
                             chunks, hide_s)
        if t < best_t - 1e-15:
            best, best_t = (p_r, p_c), t
    return best


def choose_chunks(p_r: int, p_c: int, N_t: int, N_d: int, N_m: int,
                  bytes_per_elem: int = 8,
                  net: NetworkModel = NetworkModel(),
                  max_chunks: int = 8,
                  hide_s: float | None = None) -> int:
    """Model-optimal pipeline depth K for a FIXED grid: the argmin of
    :func:`matvec_comm_time` over ``chunks`` in 1..max_chunks.

    This is where ``net.overlap_efficiency`` is decisive even without a
    compute bound: at eff = 0 every extra chunk only adds a latency tree
    (K* = 1), while a high measured efficiency pushes K toward the cap on
    bandwidth-dominated collectives.  ``launch.mesh.fftmatvec_grid``
    feeds it the calibrated network so the served schedule depth tracks
    the fabric's *measured* overlap instead of the 0.7 default."""
    best_k, best_t = 1, float("inf")
    for k in range(1, max(1, max_chunks) + 1):
        t = matvec_comm_time(p_r, p_c, N_t, N_d, N_m, bytes_per_elem, net,
                             k, hide_s)
        if t < best_t - 1e-15:
            best_k, best_t = k, t
    return best_k


def paper_grid(p: int) -> tuple[int, int]:
    """The grids the paper reports for Frontier (§4.2.2): one row for
    <= 512 GPUs, 8 rows for 1,024-2,048, 16 rows for 4,096.  The
    documented override for :func:`choose_grid` — pass
    ``grid=paper_grid(p)`` to ``FFTMatvec.from_block_column`` to pin the
    published grid instead of the modeled optimum."""
    if p <= 512:
        p_r = 1
    elif p <= 2048:
        p_r = 8
    else:
        p_r = 16
    return p_r, p // p_r
