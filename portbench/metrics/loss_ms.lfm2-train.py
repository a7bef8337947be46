"""Device time a step, in ms, of the operations launched inside
``lm.loss`` (the f32 cross-entropy over the vocabulary), over the LFM2
driver's own phase window; nothing where the program emits no such
span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    return None if not got else got["ms_per_step"].get("loss")
