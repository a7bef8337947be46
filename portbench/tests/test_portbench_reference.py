"""The plain reference against the port's ``tiny()`` model on the CPU, and
its float8 control."""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import gpt2
from portbench.tests.conftest import TINY

PORT_TINY = dict(TINY, n_embd=64, n_head=4, n_inner=128, vocab_size=256,
                 padded_vocab=256)


def _port_config():
    from ray_tpu_torch.models import transformer

    c = transformer.tiny()
    assert (c.d_model, c.n_layers, c.n_heads, c.d_ff, c.vocab_size,
            c.max_seq_len, c.padded_vocab) == (64, 2, 4, 128, 256, 64, 256)
    return c


def test_forward_matches_the_port_tiny():
    from ray_tpu_torch.models import transformer

    c = _port_config()
    params = weights.make(PORT_TINY, 5, "cpu", torch.float32)
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    port = transformer.forward(params, tokens, c).float()
    ref = gpt2.forward(params, tokens, PORT_TINY)
    assert torch.allclose(port, ref, atol=2e-5, rtol=1e-5), float(
        (port - ref).abs().max())


def test_loss_and_gradients_match_the_port_tiny():
    from ray_tpu_torch.models import training, transformer

    c = _port_config()
    params = weights.make(PORT_TINY, 6, "cpu", torch.float32)
    tokens = torch.randint(0, 256, (4, 48), generator=torch.Generator()
                           .manual_seed(2))
    opt = {"lr": 3e-4, "weight_decay": 0.1, "b1": 0.9, "b2": 0.999,
           "eps": 1e-8}
    ref = gpt2.train(params, [tokens], PORT_TINY, opt, rows_per_pass=3)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, c),
        init_params_fn=lambda s: {k: (v.clone() if not isinstance(v, dict)
                                      else {kk: vv.clone()
                                            for kk, vv in v.items()})
                                  for k, v in params.items()},
        optimizer=training.adamw(3e-4, weight_decay=0.1), device="cpu")
    p, st = bundle.init(0)
    p, st, m = bundle.step(p, st, {"tokens": tokens})
    assert abs(float(m["loss"]) - ref["losses"][0]) < 1e-5
    mu = training.adamw_state_tree(st, p)[0].mu
    names = gpt2.leaf_names(params)
    flat_mu = dict(gpt2._leaf_items(mu))
    flat_p = dict(gpt2._leaf_items(p))
    flat_0 = dict(gpt2._leaf_items(params))
    med = sorted(ref["grad_norms"].values())[len(names) // 2]
    for n in names:
        g = float(flat_mu[n].norm()) / 0.1
        assert abs(g - ref["grad_norms"][n]) <= 1e-4 * max(
            ref["grad_norms"][n], 1e-3), n
        if ref["grad_norms"][n] < 1e-3 * med:
            continue            # moved by round-off alone (check.STILL)
        d = float((flat_p[n] - flat_0[n]).detach().norm())
        assert abs(d - ref["change_norms"][n]) <= 1e-3 * max(
            ref["change_norms"][n], 1e-6), n


def test_next_token_logits_are_the_forward_rows():
    params = weights.make(PORT_TINY, 7, "cpu", torch.float32)
    seq = list(range(10, 40))
    rows = gpt2.next_token_logits(params, seq, 12, PORT_TINY)
    full = gpt2.forward(params, torch.tensor([seq]), PORT_TINY)[0]
    assert rows.shape == (18, 256)
    assert torch.equal(rows, full[11:29, :256])


def test_float8_control_departs_from_float32():
    params = weights.make(PORT_TINY, 8, "cpu", torch.float32)
    t = torch.randint(0, 256, (2, 32), generator=torch.Generator()
                      .manual_seed(3))
    a = gpt2.forward(params, t, PORT_TINY)
    b = gpt2.forward(params, t, PORT_TINY, fp8=True)
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5
