"""Device time a step, in ms, of the operations launched inside
``train.backward`` (``backward()``: the recomputation under remat, the
gradient GEMMs, K1-K3 and autograd's accumulation into the leaves), over
the phase window of ``portbench/phases.py``; nothing where the program
emits no such span."""

from portbench import phases


def read(run):
    got = phases.of(run)
    return None if got is None else got["ms_per_step"].get("backward")
