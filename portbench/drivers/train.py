"""The training driver: the port's train step at the configuration's widths,
fed a fresh batch every step, for a fixed window.

Set-up builds one step object (``training.make_train_step`` over
``transformer.lm_loss``, the model's weights made from the seed, AdamW's
state), drives it through the first ``check_steps`` steps of the run's feed
and hands that same object to the window, which runs steps until
``--seconds`` have passed and closes on a synchronise. Those first steps are
the ones checked: their losses, the first gradient as AdamW holds it after
one step (its first moment over ``1 - b1``), and each leaf's change after the
last of them, against the plain reference run over the same weights and
batches once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

from portbench import check, weights
from portbench.drivers import port_config
from portbench.traffic import train as traffic


def _norms(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_norms(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def optimizer(mix: Dict) -> Dict:
    return {"lr": mix["lr"], "weight_decay": mix["weight_decay"],
            "b1": 0.9, "b2": 0.999, "eps": 1e-8}


def run(r, *, make_step=None) -> None:
    """Drive cell ``r`` (a ``portbench.run.Run``). ``make_step`` replaces
    ``training.make_train_step``: the tests plant their faults there."""
    import torch
    from ray_tpu_torch.models import training, transformer
    from ray_tpu_torch.ops import flash_attention as fa

    from portbench.reference import gpt2
    from portbench.trace import Window

    cfg, mix, dev = r.cfg, r.mix, r.device
    if dev == "cuda":
        r.extra["device_name"] = torch.cuda.get_device_name()
    tcfg = port_config(cfg, torch, remat=mix["remat"])
    opt = optimizer(mix)
    made = weights.make(cfg, r.seed, dev, tcfg.param_dtype)
    bundle = (make_step or training.make_train_step)(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, tcfg),
        init_params_fn=lambda seed: made,
        optimizer=training.adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                                 eps=opt["eps"],
                                 weight_decay=opt["weight_decay"]),
        device=dev)
    params, state = bundle.init(r.seed)
    del made

    def feed(i):
        return {"tokens": traffic.batch(mix, r.seed, i, dev)}

    n_check = mix["check_steps"]
    losses, prog = [], {}
    for i in range(n_check):
        params, state, m = bundle.step(params, state, feed(i))
        losses.append(m["loss"])
        if i == 0:
            mu = training.adamw_state_tree(state, params)[0].mu
            prog["grad_norms"] = {n: float(t.float().norm()) / (1 - opt["b1"])
                                  for n, t in _norms(mu).items()}
            del mu
    with torch.no_grad():
        p0 = _norms(weights.make(cfg, r.seed, dev, tcfg.param_dtype))
        prog["change_norms"] = {n: float((t - p0[n]).float().norm())
                                for n, t in _norms(params).items()}
        del p0
    prog["losses"] = [float(x) for x in losses]

    window = Window(torch) if r.trace and dev == "cuda" else None
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = (fa.forward_launches, fa.dq_launches, fa.dkv_launches)
    r.setup_done()
    if window:
        window.start()
    t0 = time.perf_counter()
    steps, window_losses = 0, []
    while True:
        params, state, m = bundle.step(params, state, feed(n_check + steps))
        window_losses.append(m["loss"])
        steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync()
    r.window_s = time.perf_counter() - t0
    if window:
        window.stop()
        r.trace_window = window
    launches1 = (fa.forward_launches, fa.dq_launches, fa.dkv_launches)
    r.extra["launches"] = dict(zip(("forward", "dq", "dkv"), (
        b - a for a, b in zip(launches0, launches1))))
    r.extra.update(steps=steps, batch=mix["batch"], seq=mix["seq"])
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    if dev == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()

    del params, state, bundle, m, window_losses
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    p0 = weights.make(cfg, r.seed, dev, tcfg.param_dtype)
    ref = gpt2.train(p0, [feed(i)["tokens"] for i in range(n_check)], cfg,
                     opt, rows_per_pass=mix["reference_rows"])
    numbers, detail = check.train_numbers(prog, ref)
    r.extra["check_detail"] = detail
    ok, r.checks = check.judge(numbers, r.limits)
    r.correct = ok and r.failed == 0
