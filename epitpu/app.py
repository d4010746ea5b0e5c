"""Interactive SIR simulation explorer.

Device counterpart of the reference's Streamlit page (reference
gillespie_app.py:1-75): pick (beta, gamma, S0, I0, t), overlay a batch of
stochastic trajectories on the deterministic ODE solution.  Two front ends
share one compute path:

  * ``streamlit run epitpu/app.py`` — the same sidebar UI as the reference
    (beta/gamma number inputs, S/I sliders, horizon), when streamlit is
    installed (it is not part of this image, so the import is gated);
  * ``python -m epitpu.app --beta 2 --gamma 1 --s0 4800 --i0 20 --t 31``
    — headless fallback that writes the identical figure to a PNG.

Where the reference draws 30 trajectories one at a time from a Python
generator, here the whole batch is ONE vectorized device simulation
(epitpu.sim.simulate over a [n_traj, 3] state batch).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def simulate_overlay(beta, gamma, s0, i0, t_end, n_traj=30, seed=0,
                     steps_per_unit=20):
    """Returns (grid_times [t+1], trajectories [t+1, n_traj, 3],
    ode_times [200], ode_solution [200, 3]).  The trajectory batch is one
    vectorized simulation."""
    import jax
    import jax.numpy as jnp

    from .models import sir_model
    from .ode import integrate, sir_rhs
    from .sim import simulate

    theta = jnp.asarray([beta, gamma], jnp.float32)
    x0 = jnp.broadcast_to(jnp.asarray([s0, i0, 0.0], jnp.float32), (n_traj, 3))
    traj = simulate(
        sir_model(), jax.random.PRNGKey(seed), x0, theta, int(t_end),
        steps_per_unit,
    )
    t_ode = np.linspace(0.0, float(t_end), 200)
    sol = integrate(sir_rhs, np.asarray([s0, i0, 0.0]), theta, t_ode)
    return (
        np.arange(int(t_end) + 1),
        np.asarray(traj),
        t_ode,
        np.asarray(sol),
    )


def make_figure(beta, gamma, s0, i0, t_end, n_traj=30, seed=0):
    """The reference's 3-panel S/I/R figure: stochastic trajectories in
    orange, ODE mean field in black (reference gillespie_app.py:21-73)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    grid, traj, t_ode, sol = simulate_overlay(
        beta, gamma, s0, i0, t_end, n_traj, seed
    )
    fig, axes = plt.subplots(3, 1, figsize=(10, 10), sharex=True)
    labels = ("susceptible individuals", "infected individuals",
              "recovered individuals")
    for c, (ax, label) in enumerate(zip(axes, labels)):
        ax.plot(grid, traj[:, :, c], color="orange", linewidth=0.5)
        ax.plot(t_ode, sol[:, c], color="black")
        ax.set_ylabel(label)
        ax.set_xlim(0, t_end)
    axes[-1].set_xlabel("time (arbitrary units)")
    return fig


def _streamlit_main():
    import streamlit as st

    beta = st.sidebar.number_input("beta", 0.0, 100.0, 1.0, 0.1)
    gamma = st.sidebar.number_input("gamma", 0.0, 100.0, 1.0, 0.1)
    s = st.sidebar.slider("S", 100, 11079, 11068, 1)
    i = st.sidebar.slider("I", 1, 100, 11, 1)
    t_end = st.sidebar.number_input("t", 0, 100, 31, 1)
    st.pyplot(make_figure(beta, gamma, s, i, t_end))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--s0", type=float, default=11068)
    ap.add_argument("--i0", type=float, default=11)
    ap.add_argument("--t", type=int, default=31)
    ap.add_argument("--trajectories", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="sir_overlay.png")
    args = ap.parse_args(argv)
    fig = make_figure(
        args.beta, args.gamma, args.s0, args.i0, args.t,
        args.trajectories, args.seed,
    )
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    print(f"wrote {args.out}")
    return 0


try:  # streamlit runs pages by executing them top-level
    import streamlit as _st  # noqa: F401

    _HAVE_STREAMLIT = True
except ImportError:
    _HAVE_STREAMLIT = False

if _HAVE_STREAMLIT and __name__ != "__main__":
    try:
        from streamlit.runtime.scriptrunner import get_script_run_ctx

        if get_script_run_ctx() is not None:
            _streamlit_main()
    except Exception:
        pass

if __name__ == "__main__":
    sys.exit(main())
