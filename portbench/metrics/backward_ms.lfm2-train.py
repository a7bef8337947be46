"""Device time a step, in ms, of the operations launched inside
``train.backward`` but outside the MoE's and the conv's spans (the rest of
each layer's recompute, K1 among it, the gradient GEMMs, K2-K3 and
autograd's accumulation into the leaves), over the LFM2 driver's own
phase window; nothing where the program emits no such span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    return None if not got else got["ms_per_step"].get("backward")
