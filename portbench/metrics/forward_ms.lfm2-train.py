"""Device time a step, in ms, of the operations launched inside
``lm.forward`` but outside the MoE's and the conv's spans (the embedding,
attention with K1, the dense SwiGLU, the norms, the residual adds and the
tied head), over the LFM2 driver's own phase window; nothing where the
program emits no such span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    return None if not got else got["ms_per_step"].get("forward")
