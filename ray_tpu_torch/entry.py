"""Entry points of the port, the twins of ``__graft_entry__.py``.

``entry()`` returns ``(fn, args)``: the GPT-2 124M forward at
``max_seq_len=512`` on the card, with random weights from a seed.

``dryrun_multichip(n)`` runs one sharded train step per mesh layout on
``n`` ranks: the composed data/fsdp/tensor/seq meshes, pipeline-parallel
training held to a non-pipelined oracle, and a Switch-MoE step with
experts on ``expert``. It is a dry run of the mesh's semantics and runs on
CPU ranks over gloo (``parallel/launch.py``): it is not a fallback for the
card, which runs the mesh path through ``chip_smoke.py``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def entry():
    """(fn, example_args) for one forward step on the card."""
    from ray_tpu_torch.models import transformer

    cfg = transformer.gpt2_small(max_seq_len=512)
    params = transformer.init_params(cfg, 0)
    tokens = torch.zeros((1, cfg.max_seq_len), dtype=torch.int64,
                         device=params["tok_embed"].device)

    def fn(params, tokens):
        return transformer.forward(params, tokens, cfg)

    return fn, (params, tokens)


# Mesh layouts by rank count, as ``__graft_entry__``: the main step must
# compose data parallelism WITH the model-sharding axes; 8 ranks cannot fit
# data x fsdp x seq x tensor all at 2, so they run two composed phases.
PHASE_SPECS = {
    16: [dict(data=2, fsdp=2, seq=2, tensor=2)],
    8: [dict(data=2, fsdp=2, tensor=2), dict(fsdp=2, seq=2, tensor=2)],
    4: [dict(data=2, tensor=2)],
    2: [dict(data=2)],
    1: [dict()],
}


DRYRUN_DEADLINE_S = 600.0     # the whole world's, start-up included


def dryrun_multichip(n_devices: int) -> List[str]:
    """One sharded train step per layout on ``n_devices`` gloo CPU ranks;
    prints and returns rank 0's report lines. Raises if a rank fails."""
    from ray_tpu_torch.parallel.launch import run_world

    lines = run_world(_dryrun_rank, n_devices,
                      timeout_s=DRYRUN_DEADLINE_S)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def _dryrun_rank(rank: int, n_devices: int) -> List[str]:
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.training import adamw, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, cpu_mesh, mesh_shape
    from ray_tpu_torch.parallel.sharding import ShardingRules

    lines = []
    cfg = transformer.tiny(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=256,
        max_seq_len=128, vocab_multiple=128, attn_impl="dense")
    rules = ShardingRules()

    def bundle_for(mesh, loss_fn):
        return make_train_step(
            loss_fn=loss_fn,
            init_params_fn=lambda seed: transformer.init_params(
                cfg, seed, device="cpu"),
            logical_params=transformer.logical_axes(cfg), mesh=mesh,
            rules=rules, optimizer=adamw(1e-3),
            batch_logical=("batch", "seq_act"))

    for spec in PHASE_SPECS.get(n_devices, [dict(data=-1, tensor=2)]):
        mesh = cpu_mesh(MeshSpec(**spec))
        bundle = bundle_for(mesh, lambda p, b, m=mesh: transformer.lm_loss(
            p, b, cfg, mesh=m, rules=rules))
        params, opt = bundle.init(0)
        batch = {"tokens": torch.ones((4, cfg.max_seq_len), dtype=torch.int64)}
        _, _, metrics = bundle.step(params, opt, batch)
        loss = metrics["loss"].item()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss in dryrun: {loss}")
        lines.append(f"dryrun_multichip({n_devices}): mesh="
                     f"{mesh_shape(mesh)} loss={loss:.4f}")

    # Pipeline-parallel TRAINING of the real model, held to the
    # non-pipelined step on a data=2 mesh: pipe x data x fsdp, then
    # pipe x seq x tensor (ring attention and megatron reductions inside
    # the pipeline's per-rank region).
    if n_devices >= 8 and n_devices % 8 == 0:
        pbatch = {"tokens": torch.ones((8, cfg.max_seq_len),
                                       dtype=torch.int64)}
        oracle_mesh = cpu_mesh(MeshSpec(data=2))
        o_loss = None
        if oracle_mesh.get_coordinate() is not None:
            oracle = bundle_for(oracle_mesh, lambda p, b: transformer.lm_loss(
                p, b, cfg, mesh=oracle_mesh, rules=rules))
            oparams, oopt = oracle.init(0)
            o_loss = oracle.step(oparams, oopt, pbatch)[2]["loss"].item()
        for pp_spec in (dict(pipe=2, data=2, fsdp=n_devices // 4),
                        dict(pipe=2, seq=2, tensor=n_devices // 4)):
            pmesh = cpu_mesh(MeshSpec(**pp_spec))
            pp = bundle_for(pmesh, lambda p, b, m=pmesh: transformer.pp_lm_loss(
                p, b, cfg, mesh=m, rules=rules, num_microbatches=2))
            pparams, popt = pp.init(0)
            pp_loss = pp.step(pparams, popt, pbatch)[2]["loss"].item()
            if rank == 0:
                if not abs(pp_loss - o_loss) < 5e-3 * max(1.0, abs(o_loss)):
                    raise RuntimeError(f"pp loss {pp_loss} vs oracle "
                                       f"{o_loss} on {pp_spec}")
                desc = " ".join(f"{k}={v}" for k, v in pp_spec.items())
                lines.append(f"dryrun pp-train: {desc} loss={pp_loss:.4f} "
                             f"oracle={o_loss:.4f} OK")

    # Expert parallelism composed into a train step: the Switch FFN with
    # experts on 'expert', mlp dims on 'tensor', batch on 'data'.
    if n_devices >= 2 and n_devices % 2 == 0:
        from ray_tpu_torch.ops import moe

        ep = 2
        tp = 2 if n_devices % 4 == 0 else 1
        emesh = cpu_mesh(MeshSpec(expert=ep, tensor=tp,
                                  data=n_devices // (ep * tp)))
        mcfg = moe.MoEConfig(d_model=16, d_ff=32, num_experts=ep,
                             capacity_factor=2.0)
        tgt = torch.tensor(np.random.default_rng(2).standard_normal(
            (4, 8, 16)), dtype=torch.float32)

        def moe_loss(p, b):
            y, m = moe.moe_ffn(p, b["x"], mcfg)
            return ((y - b["tgt"]) ** 2).mean() + 0.01 * m["aux_loss"]

        mb = make_train_step(
            loss_fn=moe_loss,
            init_params_fn=lambda seed: moe.init_params(mcfg, seed,
                                                        device="cpu"),
            logical_params=moe.logical_axes(mcfg), mesh=emesh, rules=rules,
            optimizer=adamw(1e-3), batch_logical=None)
        mparams, mopt = mb.init(1)
        mbatch = {"x": torch.ones((4, 8, 16)), "tgt": tgt}
        losses = []
        for _ in range(3):
            mparams, mopt, mm = mb.step(mparams, mopt, mbatch)
            losses.append(mm["loss"].item())
        l0, l1 = losses[0], losses[-1]
        if not (math.isfinite(l1) and l1 < l0):
            raise RuntimeError(f"moe dryrun loss did not fall: {losses}")
        lines.append(f"dryrun moe-train: expert={ep} tensor={tp} "
                     f"data={n_devices // (ep * tp)} loss {l0:.4f}->"
                     f"{l1:.4f} OK")
    return lines
