"""Device time a step, in ms, of the operations launched inside
``train.optimizer`` (the zero-fill of missing gradients, the global
gradient norm and fused AdamW), over the phase window of
``portbench/phases.py``; nothing where the program emits no such span."""

from portbench import phases


def read(run):
    got = phases.of(run)
    return None if got is None else got["ms_per_step"].get("optimizer")
