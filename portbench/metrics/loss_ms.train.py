"""Device time a step, in ms, of the operations launched inside
``lm.loss`` (the f32 cross-entropy over the logits), over the phase window of
``portbench/phases.py``; nothing where the program emits no such span."""

from portbench import phases


def read(run):
    got = phases.of(run)
    return None if got is None else got["ms_per_step"].get("loss")
