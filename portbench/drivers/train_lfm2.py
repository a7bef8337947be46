"""The LFM2-MoE training driver: the port's train step over
``models/lfm2.py`` at the configuration's widths, fed a fresh batch every
step, for a fixed window.

Set-up builds one step object (``training.make_train_step`` over
``lfm2.lm_loss``, the weights made from the seed by
``portbench/weights_lfm2.py``, AdamW's state, and ``lfm2.end_step`` as the
post-step hook that moves the expert bias), drives it through the first
``check_steps`` steps of the run's feed and hands that same object to the
window, as ``portbench/drivers/train.py`` does. Those first steps are the
ones checked (``portbench/check.py``'s numbers: the losses, the first
gradient as AdamW holds it, each leaf's change) against the plain reference
``portbench/reference/lfm2_moe.py`` over the same weights and batches, once
the window has closed and the program's state is freed. Beside them,
``route_gap``: the share of (token, MoE layer) top-k sets on which the
program's first forward (the first ``reference_rows`` rows of the first
batch, the initial weights) and the reference's differ, order aside (the
detail's ``route_agreement`` is the rest).

The MoE counters (``lfm2.moe_stats``) are read before and after the
window: the assignments to the experts held and the largest held load over
the mean. Traced runs on the card also run a phase window of their own
after the check, as ``portbench/phases.py`` runs GPT-2's, with the MoE's
and the conv's spans among the phases.

``control=True`` (``python3 -m portbench.calibrate``) also runs the
reference in float8, on half of each batch, and with a learning rate of 0
against the reference, ``route_gap`` among their numbers, under
``extra["calibration"]``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Dict, List, Optional
from unittest import mock

from portbench import check, weights_lfm2
from portbench.drivers.train import _norms, optimizer
from portbench.traffic import train_lfm2 as traffic

WARM = 1
STEPS = 3
# The spans of models/lfm2.py and ops/moe.py, as phases: an op launched
# inside one goes to it, not to the forward or backward around it.
TAGS = {"moe.route": "moe.route", "moe.experts": "moe.experts",
        "moe.combine": "moe.combine", "conv.mix": "conv.mix"}


def port_config(cfg: Dict, remat: str = "none"):
    """The port's ``LFM2Config`` for configuration file ``cfg``."""
    from ray_tpu_torch.models import lfm2

    return lfm2.config_from_dict(
        cfg, remat=remat != "none",
        remat_policy=remat if remat != "none" else "full")


def _build(r, c, state):
    """The step object and its state, built as the cell builds it."""
    from ray_tpu_torch.models import lfm2, training

    opt = optimizer(r.mix)
    made = weights_lfm2.make(r.cfg, r.seed, r.device, c.param_dtype)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: lfm2.lm_loss(p, b, c, state),
        init_params_fn=lambda seed: made,
        optimizer=training.adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                                 eps=opt["eps"],
                                 weight_decay=opt["weight_decay"]),
        device=r.device, after_step=lambda: lfm2.end_step(state, c))
    params, opt_state = bundle.init(r.seed)
    del made
    return bundle, params, opt_state


def _feed(r, i):
    return {"tokens": traffic.batch(r.mix, r.cfg["vocab_size"], r.seed, i,
                                    r.device)}


def _agreement(prog, ref) -> float:
    """Share of (layer, token) top-k sets that two [layers, tokens, k]
    picks agree on, order aside."""
    a = prog.sort(dim=-1).values
    b = ref.sort(dim=-1).values
    return float((a == b).all(dim=-1).float().mean())


def _program_routes(r, c, rows: int):
    """The program's picks [moe layers, rows * seq, k] in a forward of the
    first ``rows`` rows of batch 0 at the initial weights, no gradient."""
    import torch
    from ray_tpu_torch.models import lfm2

    p0 = weights_lfm2.make(r.cfg, r.seed, r.device, c.param_dtype)
    tokens = _feed(r, 0)["tokens"][:rows]
    state = lfm2.LFM2State(c, r.device)
    state.routes = torch.zeros(c.n_moe, tokens.numel(), c.num_experts_per_tok,
                               dtype=torch.int64, device=r.device)
    with torch.no_grad():
        lfm2.forward(p0, tokens, c, state)
    return state.routes


def _phases(r, c) -> Optional[Dict]:
    """Device time a step by phase, the MoE's and the conv's spans among
    them, over ``STEPS`` steps after ``WARM`` (``phases.split_events`` and
    ``phases.attribute``); None where the program emits no span on the
    profiler's clock."""
    import torch
    from ray_tpu_torch.models import lfm2
    from ray_tpu_torch.util import tracing

    from portbench import phases

    if r.device != "cuda" or not phases._spans_on_the_clock(tracing):
        return None
    state = lfm2.LFM2State(c, r.device)
    bundle, params, opt_state = _build(r, c, state)
    for i in range(WARM):
        params, opt_state, _ = bundle.step(params, opt_state, _feed(r, i))
    torch.cuda.synchronize()
    spans: List[Dict] = []
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    tracing.set_sink(spans.append)
    prof.__enter__()
    try:
        with tracing.span("portbench.phases"):
            for i in range(STEPS):
                params, opt_state, _ = bundle.step(params, opt_state,
                                                   _feed(r, WARM + i))
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
        tracing.set_sink(None)
    ops, launches = phases.split_events(prof.profiler.kineto_results.events(),
                                        torch.autograd.DeviceType.CUDA)
    del prof, params, opt_state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    with mock.patch.dict(phases.TAGS, TAGS):
        got = phases.attribute(ops, launches, spans)
    got["span_counts"] = {n: sum(s["name"] == n for s in spans)
                          for n in list(phases.TAGS) + list(TAGS)}
    if not got["steps"]:
        return None
    print(f"phases {json.dumps(got)}", file=sys.stderr, flush=True)
    return got


def run(r, *, control: bool = False) -> None:
    """Drive cell ``r`` (a ``portbench.run.Run``)."""
    import torch
    from ray_tpu_torch.models import lfm2, training
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import moe

    from portbench.reference import lfm2_moe
    from portbench.trace import Window

    cfg, mix, dev = r.cfg, r.mix, r.device
    if dev == "cuda":
        r.extra["device_name"] = torch.cuda.get_device_name()
    c = port_config(cfg, remat=mix["remat"])
    opt = optimizer(mix)
    state = lfm2.LFM2State(c, dev)
    bundle, params, opt_state = _build(r, c, state)

    n_check = mix["check_steps"]
    losses, prog = [], {}
    for i in range(n_check):
        params, opt_state, m = bundle.step(params, opt_state, _feed(r, i))
        losses.append(m["loss"])
        if i == 0:
            mu = training.adamw_state_tree(opt_state, params)[0].mu
            prog["grad_norms"] = {n: float(t.float().norm()) / (1 - opt["b1"])
                                  for n, t in _norms(mu).items()}
            del mu
    with torch.no_grad():
        p0 = _norms(weights_lfm2.make(cfg, r.seed, dev, c.param_dtype))
        prog["change_norms"] = {n: float((t - p0[n]).float().norm())
                                for n, t in _norms(params).items()}
        del p0
    prog["losses"] = [float(x) for x in losses]
    bias_checked = state.expert_bias.clone()

    window = Window(torch) if r.trace and dev == "cuda" else None
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stats0 = lfm2.moe_stats(state, c)
    launches0 = (fa.forward_launches, fa.dq_launches, fa.dkv_launches,
                 moe.topk_calls)
    r.setup_done()
    if window:
        window.start()
    t0 = time.perf_counter()
    steps, window_losses = 0, []
    while True:
        params, opt_state, m = bundle.step(params, opt_state,
                                           _feed(r, n_check + steps))
        window_losses.append(m["loss"])
        steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync()
    r.window_s = time.perf_counter() - t0
    if window:
        window.stop()
        r.trace_window = window
    launches1 = (fa.forward_launches, fa.dq_launches, fa.dkv_launches,
                 moe.topk_calls)
    counts = [b - a for a, b in zip(launches0, launches1)]
    r.extra["launches"] = dict(zip(("forward", "dq", "dkv"), counts[:3]))
    stats1 = lfm2.moe_stats(state, c)
    r.extra["lfm2"] = {
        "held_assignments": stats1["held_total"] - stats0["held_total"],
        "load_max": ((stats1["load_max_sum"] - stats0["load_max_sum"])
                     / max(stats1["steps"] - stats0["steps"], 1)),
        "topk_calls": counts[3], "moe_layers": c.n_moe}
    r.extra.update(steps=steps, batch=mix["batch"], seq=mix["seq"])
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    if dev == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()

    del params, opt_state, bundle, m, window_losses, state
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    rows = mix["reference_rows"]
    prog_routes = _program_routes(r, c, rows)
    p0 = weights_lfm2.make(cfg, r.seed, dev, c.param_dtype)
    batches = [_feed(r, i)["tokens"] for i in range(n_check)]

    def reference(batch_rows=None, lr=opt["lr"], **kw):
        return lfm2_moe.train(p0, [b[:batch_rows] for b in batches], cfg,
                              dict(opt, lr=lr), rows_per_pass=rows, **kw)

    ref = reference(route_rows=rows)

    def numbers_of(got, routes):
        numbers, detail = check.train_numbers(got, ref)
        numbers["route_gap"] = 1.0 - _agreement(routes, ref["routes"])
        return numbers, detail

    numbers, detail = numbers_of(prog, prog_routes)
    detail["route_agreement"] = 1.0 - numbers["route_gap"]
    detail["bias_gap"] = float((bias_checked - ref["bias"]).abs().max())
    r.extra["check_detail"] = detail
    ok, r.checks = check.judge(numbers, r.limits)
    r.correct = ok and r.failed == 0
    if control:
        half = mix["batch"] // 2
        r.extra["calibration"] = {"program": numbers,
                                  "ref_losses": ref["losses"]}
        for name, kw in (("control_fp8", {"fp8": True}),
                         ("fault_half_batch", {"batch_rows": half}),
                         ("fault_state_unchanged", {"lr": 0.0})):
            got = reference(route_rows=rows, **kw)
            r.extra["calibration"][name] = numbers_of(got, got["routes"])[0]
            del got
        r.extra["check_sample"] = detail
    del p0, batches, ref, prog_routes
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    if r.trace:
        r.extra["lfm2_phases"] = _phases(r, c)
