"""Deterministic fault-injection plane (see faultlab/core.py): the port's
own copy of the JAX package's, with the same schedule."""

from .core import (                                        # noqa: F401
    ENV_RATE,
    ENV_SEED,
    ENV_SITES,
    SITES,
    FaultPlan,
    InjectedDeviceLoss,
    InjectedFault,
    TargetedPlan,
    activate,
    deactivate,
    from_env,
    injections_total,
    site,
    snapshot,
)
