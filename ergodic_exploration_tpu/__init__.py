"""Batched ergodic-exploration MPC engine for the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the C++/ROS
reference ``bostoncleek/ergodic_exploration`` (receding-horizon ergodic
control; see SURVEY.md at the repo root for the capability map). Instead of
one robot replanning at 10 Hz on a CPU core, this engine batches thousands of
(map, start-pose) scenarios per step across a device mesh.

Layer map (mirrors SURVEY.md section 2's L0-L5, redesigned for batching):

- L0 numerics  -> :mod:`ergodic_exploration_tpu.utils.numerics`
- L1 world     -> :mod:`ergodic_exploration_tpu.grid`,
                  :mod:`ergodic_exploration_tpu.ops.distance`,
                  :mod:`ergodic_exploration_tpu.ops.collision`
- L2 models    -> :mod:`ergodic_exploration_tpu.models` (cart, omni) +
                  :mod:`ergodic_exploration_tpu.ops.integrator` (RK4 scans)
- L3 ergodic   -> :mod:`ergodic_exploration_tpu.ops.basis`,
                  :mod:`ergodic_exploration_tpu.ops.target`,
                  :mod:`ergodic_exploration_tpu.ops.buffer`,
                  :mod:`ergodic_exploration_tpu.controller`
- L4 safety    -> :mod:`ergodic_exploration_tpu.ops.dwa`
- L5 app       -> :mod:`ergodic_exploration_tpu.engine` (batched array API
                  replacing the ROS node), :mod:`ergodic_exploration_tpu.node`
"""

from ergodic_exploration_tpu.config import (
    CartParams,
    DwaConfig,
    EngineConfig,
    OmniParams,
    default_config,
    load_yaml_config,
)
from ergodic_exploration_tpu.grid import Domain, GridMap

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: the controller/engine pull in the full op stack; keep light
    # imports (config, grid) cheap.
    if name == "ErgodicController":
        from ergodic_exploration_tpu.controller import ErgodicController

        return ErgodicController
    if name == "Engine":
        from ergodic_exploration_tpu.engine import Engine

        return Engine
    if name == "ExplorationNode":
        from ergodic_exploration_tpu.node import ExplorationNode

        return ExplorationNode
    if name == "GaussianMixture":
        from ergodic_exploration_tpu.ops.target import GaussianMixture

        return GaussianMixture
    if name == "make_scenario_mesh":
        from ergodic_exploration_tpu.engine import make_scenario_mesh

        return make_scenario_mesh
    if name == "make_mesh":
        from ergodic_exploration_tpu.engine import make_mesh

        return make_mesh
    raise AttributeError(name)

__all__ = [
    "CartParams",
    "OmniParams",
    "DwaConfig",
    "EngineConfig",
    "default_config",
    "load_yaml_config",
    "Domain",
    "GridMap",
    "ErgodicController",
    "Engine",
    "ExplorationNode",
    "GaussianMixture",
    "make_scenario_mesh",
    "make_mesh",
]
