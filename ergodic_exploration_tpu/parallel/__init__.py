"""Multi-host launch + mesh helpers (SURVEY.md section 3, build-side
parallelism inventory).

The engine's parallelism is expressed entirely through ``jax.sharding``:
- ``scenario`` axis: independent (map, pose) solves — DP-analog, zero
  cross-scenario communication; spans the cards of a host and the hosts.
- ``sample`` axis: the 10k-grid-sample ergodic reduction sharded within a
  solve — the project's sequence-parallelism analog, combined with psum
  (Engine.phik_from_gmm_sample_sharded).

There is deliberately NO pipeline/tensor/expert parallelism here: the
workload has no deep network to split (see README, "Parallelism").
"""

from __future__ import annotations

from typing import Optional

import jax

from ergodic_exploration_tpu.engine import Engine, make_mesh, make_scenario_mesh

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "make_scenario_mesh",
    "global_scenario_mesh",
    "process_scenario_slice",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Bring up the multi-process SPMD runtime.

    Thin wrapper over ``jax.distributed.initialize``; pass the coordinator
    (``host:port``), the process count and this process's id (nothing
    detects them on a plain GPU host). ``local_device_ids`` limits this
    process to some of its host's cards — e.g. ``[process_id]`` for one
    process per card on one host. After this, ``jax.devices()`` spans every
    process and the same Engine code shards over the global device set;
    XLA routes the collectives (NCCL on the GPU) with no transport code here
    (the build-side replacement for the reference's ROS TCPROS boundary).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_scenario_mesh():
    """1-D scenario mesh over every device of every host."""
    return make_scenario_mesh(devices=jax.devices())


def process_scenario_slice(n_scenarios: int):
    """(start, stop) of this host's scenario shard for data feeding.

    Each host materializes only its slice of the batch;
    ``Engine.shard_scenarios`` then forms the global sharded array.
    """
    p = jax.process_index()
    n = jax.process_count()
    per = n_scenarios // n
    if n_scenarios % n:
        raise ValueError(f"scenario count {n_scenarios} not divisible by {n} hosts")
    return p * per, (p + 1) * per
