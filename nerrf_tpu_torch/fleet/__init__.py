"""Fleet control plane: headroom-driven autoscaling, deterministic
stream placement, and SLO-aware shedding over a set of serve replicas.

Three legs (docs/fleet.md):

  * `FleetController` (fleet/controller.py) — a poll loop over every
    replica's ``/metrics`` + ``/readyz`` that scales the replica set on
    the capacity plane's predicted headroom (hysteresis band + sustain
    counters + cooldown, so noise never flaps the fleet) and reconciles
    stream placement through the deterministic `slot_map`.  Every
    decision is a typed journal record (``fleet_scale``,
    ``fleet_rebalance``) carrying the evidence snapshot, exported as
    ``nerrf_fleet_*`` metrics.
  * `ReplicaSet` / `ReplicaProcess` (fleet/replica.py) — replicas as
    managed child processes (``python -m nerrf_tpu_torch.fleet.replica``,
    each on the card unless ``--device cpu``); the controller's actuation
    surface.  The port has no compile cache yet (ROADMAP A.7), so every
    replica warms its buckets live.
  * SLO-aware shedding lives in the serve plane itself
    (serve/service.py `_shed_one`, journaled as ``fleet_shed``): under
    capacity pressure the admission victim is the stream burning the
    most SLO budget, not the admitting stream's oldest window.

The controller and the manager half are host-side: no device state, no
device work; each replica child runs its own service on its device.  The
port of ``nerrf_tpu/fleet/``.
"""

_CONTROLLER_EXPORTS = ("FleetConfig", "FleetController", "parse_gauge",
                       "slot_map", "stable_slot")
_REPLICA_EXPORTS = ("ReplicaProcess", "ReplicaSet", "replica_args")


def __getattr__(name: str):
    # lazy so `python -m nerrf_tpu_torch.fleet.replica` (the child entrypoint)
    # and `python -m nerrf_tpu_torch.fleet.controller` (the daemon) do not
    # import their module twice through the package __init__
    if name in _CONTROLLER_EXPORTS:
        from nerrf_tpu_torch.fleet import controller

        return getattr(controller, name)
    if name in _REPLICA_EXPORTS:
        from nerrf_tpu_torch.fleet import replica

        return getattr(replica, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "FleetConfig",
    "FleetController",
    "ReplicaProcess",
    "ReplicaSet",
    "parse_gauge",
    "replica_args",
    "slot_map",
    "stable_slot",
]
