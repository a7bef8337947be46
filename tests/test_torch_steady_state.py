"""The steady-state guard (``ray_tpu_torch.devtools.jitcheck``), the port's
twin of ``ray_tpu/devtools/jitcheck.py``'s runtime half.

One violation of each kind is provoked on the CPU: every implicit read of a
tensor's value (``item``, ``tolist``, ``__bool__``, ``__float__``,
``__int__``, ``__index__``), ``cpu``/``numpy`` of a CUDA tensor (here a
tensor that reports ``is_cuda``; the real one runs in ``test_torch_gpu``),
and a kernel library loaded inside the scope. ``device_get`` is the one
sanctioned read; the scope is thread-local and reentrant; ``strict=True``
raises. Then the warm steps of the paged, slotted and speculative engines
record none.
"""

import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.devtools import jitcheck
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.ops import _build
from ray_tpu_torch.serve.llm import LLMEngine, PagedLLMEngine


@pytest.fixture
def guard():
    was = jitcheck.installed()
    jitcheck.install()
    jitcheck.clear_violations()
    yield jitcheck
    jitcheck.clear_violations()
    if not was:
        jitcheck.uninstall()


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the guard's CUDA-only
    reads see it as a CUDA tensor. Its ops return plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _reads():
    t = torch.tensor([3])
    return {
        "item": lambda: t.item(),
        "tolist": lambda: t.tolist(),
        "__bool__": lambda: bool(t),
        "__float__": lambda: float(t),
        "__int__": lambda: int(t),
        "__index__": lambda: [10, 11, 12, 13][t[0]],
    }


@pytest.mark.parametrize("kind", list(_reads()))
def test_each_implicit_read_is_a_violation(guard, kind):
    read = _reads()[kind]
    read()                                   # outside the scope: allowed
    assert guard.violations() == []
    with guard.steady_state():
        read()
    (v,) = guard.violations()
    assert f"({kind})" in v and "test_torch_steady_state.py" in v


@pytest.mark.parametrize("kind", ["cpu", "numpy"])
def test_cuda_host_copies_are_violations(guard, kind):
    fake = torch.Tensor._make_subclass(_ReportsCuda, torch.arange(4.0))
    plain = torch.arange(4.0)
    with guard.steady_state():
        getattr(plain, kind)()               # a CPU tensor: no copy, no read
        assert guard.violations() == []
        getattr(fake, kind)()
    (v,) = guard.violations()
    assert f"({kind})" in v


def test_kernel_load_inside_the_scope_is_a_violation(guard, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", lambda names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load("paged_attention")           # warmup: counted, allowed
    assert guard.violations() == []
    monkeypatch.setattr(_build, "_libs", {})
    with guard.steady_state():
        _build.load("flash_attention")
    (v,) = guard.violations()
    assert "kernel library flash_attention" in v
    assert guard.build_counts() == {"paged_attention": 1,
                                    "flash_attention": 1}


def test_device_get_is_the_sanctioned_read(guard):
    fake = torch.Tensor._make_subclass(_ReportsCuda, torch.arange(3))
    with guard.steady_state():
        host = guard.device_get(fake)
        both = guard.device_get((fake, torch.ones(2)))
    assert guard.violations() == []
    assert host.tolist() == [0, 1, 2] and len(both) == 2


def test_scope_is_thread_local_and_strict_raises(guard):
    t = torch.tensor([1])
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(10)
        t.item()                             # this thread is not in scope
        release.set()

    th = threading.Thread(target=other)
    th.start()
    with guard.steady_state():
        with guard.steady_state():           # reentrant
            entered.set()
            assert release.wait(10)
    th.join(10)
    assert guard.violations() == []
    with pytest.raises(guard.SteadyStateViolation, match="item"):
        with guard.steady_state(strict=True):
            t.item()


def test_uninstalled_scope_is_a_noop():
    was = jitcheck.installed()
    jitcheck.uninstall()
    try:
        n0 = len(jitcheck.violations())
        with jitcheck.steady_state(strict=True):
            torch.tensor([2]).item()
        assert len(jitcheck.violations()) == n0
        assert torch.Tensor.item is torch._C.TensorBase.item
    finally:
        if was:
            jitcheck.install()


@pytest.mark.parametrize("engine", ["paged", "slotted", "spec"])
def test_warm_engine_steps_record_no_violation(guard, engine):
    cfg = ttf.tiny(max_seq_len=64)
    params = ttf.init_params(cfg, 0, device="cpu")
    geom = dict(prompt_buckets=(16, 32), chunk=4, slots=2)
    if engine == "slotted":
        eng = LLMEngine(params, cfg, device="cpu", **geom)
    else:
        extra = (dict(draft_params=params, draft_config=cfg, spec_tokens=3)
                 if engine == "spec" else {})
        eng = PagedLLMEngine(params, cfg, device="cpu", block_tokens=8,
                             pool_blocks=129, **geom, **extra)
    eng.warmup()
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 12).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 7, 1)]
    outs, errs = [], []

    def client(p, temp):
        try:
            outs.append(eng.generate(p, max_new_tokens=10, temperature=temp,
                                     seed=3))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(p, temp))
               for p, temp in zip(prompts, (0.0, 0.8, 0.0))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errs and len(outs) == 3
    assert eng._steady
    assert guard.violations() == []
