from .solve import (
    integrate,
    discretize_to_integer_grid,
    solve_on_integer_grid,
    sir_rhs,
    seir_rhs,
    make_sir_subgroups_rhs,
    sir_simulate_discrete,
    seir_simulate_discrete,
    sir_subgroups_simulate_discrete,
)

__all__ = [
    "integrate",
    "discretize_to_integer_grid",
    "solve_on_integer_grid",
    "sir_rhs",
    "seir_rhs",
    "make_sir_subgroups_rhs",
    "sir_simulate_discrete",
    "seir_simulate_discrete",
    "sir_subgroups_simulate_discrete",
]
