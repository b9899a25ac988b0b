"""PyTorch port vs the JAX package: the receding-horizon MPC
(``algos/mpc.py:mpc_solve``) and its closed loop
(``drivers/closed_loop.py:mpc_sim``) on bench.py's MPC parameters, with
both backends that ``MPCConfig.solver`` takes, in float64 on the CPU.

The dense IPM (the default) agrees to 1e-8 relative to 1 + max |ref|;
the first-order backend (warm-started, Anderson-accelerated) to 1e-8 as
in test_torch_scs.py.
"""

import inspect

import numpy as np
import pytest

from scpp_tpu.configs.algorithms import MPCConfig as JMPCConfig
from scpp_tpu.drivers.closed_loop import mpc_sim as j_mpc_sim
from scpp_tpu.models import Rocket2D as JRocket2D
from scpp_tpu.solver.scs import SolverSettings as JSolverSettings
from scpp_tpu_torch import kernels
from scpp_tpu_torch.algos.mpc import mpc_solve
from scpp_tpu_torch.configs.algorithms import MPCConfig
from scpp_tpu_torch.drivers.closed_loop import mpc_sim
from scpp_tpu_torch.models import Rocket2D
from scpp_tpu_torch.solver.scs import SolverSettings
from test_torch_conic import (jax_mpc_params, port_mpc_params,
                              reference_mpc_solve)

CONFIGS = {"ipm": (JMPCConfig(), MPCConfig()),
           "scs": (JMPCConfig(solver=JSolverSettings(warm_start=True)),
                   MPCConfig(solver=SolverSettings(warm_start=True)))}
# closed-loop steps of 0.01 s per backend
SIM_STEPS = {"ipm": 5, "scs": 3}


def rel(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / (1 + np.max(np.abs(ref))))


@pytest.mark.parametrize("backend", list(CONFIGS))
def test_mpc_solve_matches_reference(backend):
    ref = reference_mpc_solve(backend)
    p = port_mpc_params()
    kernels.reset_launches()
    X, U, res = mpc_solve(Rocket2D, p, p.x_init, CONFIGS[backend][1],
                          device="cpu")
    assert X.shape == (1, 7, 6) and U.shape == (1, 6, 2)
    assert rel(X[0], ref["X"]) <= 1e-8
    assert rel(U[0], ref["U"]) <= 1e-8
    for n in ("res_pri", "res_dua", "res_gap"):
        assert rel(getattr(res, n)[0], ref[n]) <= 1e-8, n
    iters = CONFIGS[backend][1].solver.iters
    assert kernels.solver_calls["soc_projection"] == \
        (0 if backend == "ipm" else iters + 1)


@pytest.mark.parametrize("backend", list(CONFIGS))
def test_mpc_sim_matches_reference(backend):
    """The closed loop: the plant moves first, each step re-solves from
    the step's start state (warm-started on scs, the carry gated on a
    finite, solved result)."""
    jcfg, cfg = CONFIGS[backend]
    steps = SIM_STEPS[backend]
    sim_time = steps * 0.01 + 1e-9
    ref = j_mpc_sim(JRocket2D, jax_mpc_params(), jcfg, sim_time, 0.01)
    hist = mpc_sim(Rocket2D, port_mpc_params(), cfg, sim_time, 0.01,
                   device="cpu")
    assert hist.X.shape == (1, steps, 6) and hist.U.shape == (1, steps, 2)
    assert rel(hist.X[0], ref.X) <= 1e-8
    assert rel(hist.U[0], ref.U) <= 1e-8
    np.testing.assert_allclose(hist.t[0].numpy(), np.asarray(ref.t),
                               rtol=1e-15)
    assert int(hist.steps[0]) == int(ref.steps)
    assert bool(hist.reached_end[0]) == bool(ref.reached_end)


def test_entry_points_default_to_the_card():
    for fn in (mpc_solve, mpc_sim):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_config_defaults_match_reference():
    """MPCConfig has every field of the reference's, with the stock
    defaults, and the dense IPM as its solver."""
    ref, got = JMPCConfig(), MPCConfig()
    names = [f for f in ref.__dataclass_fields__]
    assert names == [f for f in got.__dataclass_fields__]
    for n in names:
        if n != "solver":
            assert getattr(got, n) == getattr(ref, n), n
    assert type(got.solver).__name__ == "IPMSettings"
    assert got.solver.iters == ref.solver.iters == 20
