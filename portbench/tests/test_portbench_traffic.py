"""Seeded traffic is reproducible byte for byte, and the seed changes the
tokens and the order, never the set of sizes."""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import torch

from portbench.tests.conftest import REPO, SERVE_MIX, TRAIN_MIX
from portbench.traffic import serve, train

BIG = 2**40 + 12345


# Independent requests (no file of the benchmark uses this mode yet): the
# decode-heavy chat mix that PERF.md keeps for a later cell.
DECODE_MIX = {
    "kind": "serve", "mode": "independent", "clients": 64, "slots": 64,
    "pool_blocks": 6145, "prefill_tokens": 2048, "sizes_seed": 0,
    "pool": 4096,
    "prompt": {"median": 160, "sigma": 0.8, "min": 32, "max": 512},
    "output": {"median": 256, "sigma": 0.6, "min": 128, "max": 512},
    "greedy_share": 0.75, "temperature": 0.8,
}


def _mix(name):
    if name == "chat-decode":
        return DECODE_MIX
    return json.loads((REPO / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


def test_train_batches_repeat_and_differ():
    a = train.batch(TRAIN_MIX, BIG, 0, "cpu")
    assert torch.equal(a, train.batch(TRAIN_MIX, BIG, 0, "cpu"))
    assert not torch.equal(a, train.batch(TRAIN_MIX, BIG, 1, "cpu"))
    assert not torch.equal(a, train.batch(TRAIN_MIX, BIG + 1, 0, "cpu"))
    assert a.shape == (TRAIN_MIX["batch"], TRAIN_MIX["seq"])
    assert a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) <= TRAIN_MIX["eos"]
    # packed documents: EOS separators in every row, rows all differ
    assert bool((a == TRAIN_MIX["eos"]).any(dim=1).all())
    assert len({tuple(r.tolist()) for r in a}) == a.shape[0]


def test_cell_train_mix_shape():
    mix = _mix("packed-16x1024")
    b = train.batch(mix, BIG, 7, "cpu")
    assert b.shape == (16, 1024)
    eos = (b == mix["eos"]).sum(dim=1).float()
    # lognormal documents of median 512 tokens: about two EOS a row
    assert 0.5 < float(eos.mean()) < 5


def _stream(mix, seed, n, clients=4):
    g = serve.Generator(mix, seed, 50257, clients, 16)
    out = []
    for _ in range(n):
        s, known = g.next_session()
        out.append((None if s.system is None else s.system.tobytes(),
                    tuple((t.user.tobytes(), t.max_new, t.temperature, t.seed)
                          for t in s.turns), known))
    return out


def _sizes(stream):
    return Counter((None if s is None else len(s), tuple(
        (len(u), m) for u, m, _, _ in turns)) for s, turns, _ in stream)


def test_serve_streams_repeat_byte_for_byte():
    for name in ("chat-decode", "sessions", "sessions-unshared"):
        mix = _mix(name)
        a = _stream(mix, BIG, 64, clients=mix["clients"])
        assert a == _stream(mix, BIG, 64, clients=mix["clients"])
        b = _stream(mix, BIG + 1, 64, clients=mix["clients"])
        assert a != b
        # one group of `clients` requests: the same sizes, another order
        assert _sizes(a) == _sizes(b)


def test_decode_mix_lengths_and_sampling():
    mix = _mix("chat-decode")
    g = serve.Generator(mix, BIG, 50257, 64, 16)
    sessions = [g.next_session()[0] for _ in range(mix["pool"])]
    assert all(len(s.turns) == 1 and s.system is None for s in sessions)
    p = np.array([len(s.turns[0].user) for s in sessions])
    o = np.array([s.turns[0].max_new for s in sessions])
    assert p.min() >= 32 and p.max() <= 512
    assert o.min() >= 128 and o.max() <= 512
    greedy = np.mean([s.turns[0].temperature == 0.0 for s in sessions])
    assert abs(greedy - 0.75) < 1e-3


def test_sessions_share_system_prompts_and_fit():
    mix = _mix("sessions")
    g = serve.Generator(mix, BIG, 50257, 64, 16)
    systems, knowns = set(), []
    for _ in range(200):
        s, known = g.next_session()
        systems.add(s.system.tobytes())
        knowns.append(known)
        hist = len(s.system)
        for t in s.turns:
            hist += len(t.user)
            assert hist + mix["output_len"][1] <= mix["max_len"]
            assert 32 <= t.max_new <= 128 and 16 <= len(t.user) <= 128
            hist += t.max_new
    assert len(systems) == mix["system_prompts"]
    assert knowns[0] == 0 and all(k % 16 == 0 for k in knowns)
    assert sum(k > 0 for k in knowns) >= 200 - mix["system_prompts"]


def test_unshared_keeps_the_sessions_lengths():
    shared, fresh = _mix("sessions"), _mix("sessions-unshared")
    g = serve.Generator(shared, BIG, 50257, 64, 16)
    want = Counter()
    for idx in range(shared["pool"]):
        s = g._sizes[idx]
        hist = int(g._sys_lens[g._sys_of[idx]])
        for u, o in s:
            want[(hist + u, o)] += 1
            hist += u + o
    f = serve.Generator(fresh, BIG, 50257, 64, 16)
    got = Counter((p, o) for [(p, o)] in f._sizes)
    assert got == want
    s, known = f.next_session()
    assert s.system is None and known == 0 and len(s.turns) == 1


def test_tiny_serve_mix_fits_its_model():
    g = serve.Generator(SERVE_MIX, BIG, 4096, 4, 16)
    for _ in range(20):
        s, _ = g.next_session()
        top = max(s.system.max(), max(t.user.max() for t in s.turns))
        assert int(top) < 4096
