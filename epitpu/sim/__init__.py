from .tauleap import advance, draw_binomial, event_counts, simulate, substep
from .samplers import exact_binomial, fast_binomial, get_binomial_sampler
from .exact import (
    exact_advance,
    exact_simulate_grid,
    default_max_events,
    simulate_exact_np,
    grid_from_events,
)

__all__ = [
    "advance",
    "draw_binomial",
    "event_counts",
    "simulate",
    "substep",
    "exact_advance",
    "exact_simulate_grid",
    "default_max_events",
    "simulate_exact_np",
    "grid_from_events",
    "exact_binomial",
    "fast_binomial",
    "get_binomial_sampler",
]
