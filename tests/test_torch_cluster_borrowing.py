"""Distributed borrower-protocol tests (reference_count.h:61).

The owner of an object must defer cluster-wide frees while any other
process holds a live borrow — whether the ref crossed in task args, inside
a returned object, or sits in actor state — and must collect borrows from
processes that die without deregistering. The model test drives random
borrow/forward/drop sequences against a live multiprocess cluster and
checks both directions: no premature free (every read from a live holder
succeeds) and no leak (owner-side borrower/contained state fully drains
once every holder is gone).

JAX's ``tests/test_borrowing.py`` on a ``ray_tpu_torch`` Cluster.
"""

import gc
import random
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core import runtime as runtime_mod


@pytest.fixture(scope="module")
def mp_cluster():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield cluster
    cluster.shutdown()


@pytest.fixture()
def driver(mp_cluster):
    core = connect(mp_cluster.gcs_address)
    yield core
    core.shutdown()
    runtime_mod._global_runtime = None


@ray_tpu_torch.remote
class Holder:
    def __init__(self):
        self.refs = {}

    def store(self, name, boxed_ref):
        self.refs[name] = boxed_ref
        return True

    def read(self, name):
        return ray_tpu_torch.get(self.refs[name][0], timeout=60)

    def fetch_box(self, name):
        """Forward the ref onward (still boxed) without dereferencing."""
        return self.refs[name]

    def drop(self, name):
        self.refs.pop(name)
        gc.collect()
        return True


def _drained(core, timeout=30.0):
    """Owner-side borrower/contained state fully empty."""
    deadline = time.time() + timeout
    rc = core.reference_counter
    while time.time() < deadline:
        gc.collect()
        with rc._lock:
            if not rc._borrowers and not rc._contained:
                return True
        time.sleep(0.25)
    return False


def test_actor_state_borrow_survives_driver_drop(driver):
    h = Holder.remote()
    ref = ray_tpu_torch.put({"v": 7})
    assert ray_tpu_torch.get(h.store.remote("a", [ref]), timeout=120)
    del ref
    gc.collect()
    time.sleep(0.5)
    assert ray_tpu_torch.get(h.read.remote("a"), timeout=60) == {"v": 7}
    ray_tpu_torch.get(h.drop.remote("a"), timeout=60)
    assert _drained(driver)


def test_ref_returned_inside_object(driver):
    @ray_tpu_torch.remote
    def make():
        inner = ray_tpu_torch.put("inner-payload")
        return {"ref": inner}

    box = ray_tpu_torch.get(make.remote(), timeout=120)
    assert ray_tpu_torch.get(box["ref"], timeout=60) == "inner-payload"


def test_forwarding_chain(driver):
    """driver -> A (stored) -> driver drops -> A forwards to B -> A drops:
    B must still read the value; then B drops and the owner drains."""
    a, b = Holder.remote(), Holder.remote()
    ref = ray_tpu_torch.put(list(range(32)))
    ray_tpu_torch.get(a.store.remote("x", [ref]), timeout=120)
    del ref
    gc.collect()
    time.sleep(0.5)
    box = ray_tpu_torch.get(a.fetch_box.remote("x"), timeout=60)
    ray_tpu_torch.get(b.store.remote("x", box), timeout=60)
    del box
    ray_tpu_torch.get(a.drop.remote("x"), timeout=60)
    time.sleep(0.5)
    assert ray_tpu_torch.get(b.read.remote("x"), timeout=60) == list(range(32))
    ray_tpu_torch.get(b.drop.remote("x"), timeout=60)
    assert _drained(driver)


def test_kill_borrower_mid_use(driver):
    """A borrower dying without deregistering must not leak the object
    forever (sweep collects it), and must not affect other borrowers."""
    a, doomed = Holder.remote(), Holder.remote()
    ref = ray_tpu_torch.put({"big": list(range(500))})
    ray_tpu_torch.get(a.store.remote("k", [ref]), timeout=120)
    ray_tpu_torch.get(doomed.store.remote("k", [ref]), timeout=60)
    del ref
    gc.collect()
    time.sleep(0.5)
    ray_tpu_torch.kill(doomed)
    time.sleep(1.0)
    # surviving borrower still reads
    out = ray_tpu_torch.get(a.read.remote("k"), timeout=60)
    assert out == {"big": list(range(500))}
    ray_tpu_torch.get(a.drop.remote("k"), timeout=60)
    # the dead borrower's registration is swept (<= ~2 sweep periods)
    assert _drained(driver, timeout=60.0)


def test_borrow_model_random_sequences(driver):
    """Model-based: random put/store/forward/drop ops; after every op a
    random live holder must read the true value (no premature free), and
    at the end the owner's borrower/contained state drains (no leak)."""
    rng = random.Random(1234)
    actors = [Holder.remote() for _ in range(3)]
    # model: name -> {"value": v, "holders": set of actor idx, "driver": ref or None}
    model = {}
    next_id = 0

    for step in range(60):
        op = rng.choice(["put", "store", "forward", "drop_driver",
                         "drop_actor", "read"])
        if op == "put" or not model:
            name = f"obj{next_id}"
            next_id += 1
            value = {"name": name, "data": [rng.random() for _ in range(8)]}
            model[name] = {"value": value,
                           "holders": set(),
                           "driver": ray_tpu_torch.put(value)}
        elif op == "store":
            name = rng.choice(list(model))
            ent = model[name]
            if ent["driver"] is None:
                continue
            idx = rng.randrange(len(actors))
            ray_tpu_torch.get(actors[idx].store.remote(name, [ent["driver"]]),
                        timeout=120)
            ent["holders"].add(idx)
        elif op == "forward":
            candidates = [(n, e) for n, e in model.items() if e["holders"]]
            if not candidates:
                continue
            name, ent = rng.choice(candidates)
            src = rng.choice(sorted(ent["holders"]))
            dst = rng.randrange(len(actors))
            box = ray_tpu_torch.get(actors[src].fetch_box.remote(name), timeout=60)
            ray_tpu_torch.get(actors[dst].store.remote(name, box), timeout=60)
            del box
            ent["holders"].add(dst)
        elif op == "drop_driver":
            name = rng.choice(list(model))
            model[name]["driver"] = None
            gc.collect()
        elif op == "drop_actor":
            candidates = [(n, e) for n, e in model.items() if e["holders"]]
            if not candidates:
                continue
            name, ent = rng.choice(candidates)
            idx = rng.choice(sorted(ent["holders"]))
            ray_tpu_torch.get(actors[idx].drop.remote(name), timeout=60)
            ent["holders"].discard(idx)
        elif op == "read":
            candidates = [(n, e) for n, e in model.items() if e["holders"]]
            if not candidates:
                continue
            name, ent = rng.choice(candidates)
            idx = rng.choice(sorted(ent["holders"]))
            got = ray_tpu_torch.get(actors[idx].read.remote(name), timeout=60)
            assert got == ent["value"], f"step {step}: {name} corrupted"
        # prune fully-dropped entries from the model
        for name in [n for n, e in model.items()
                     if e["driver"] is None and not e["holders"]]:
            model.pop(name)

    # teardown: drop everything, owner state must drain
    for name, ent in model.items():
        for idx in sorted(ent["holders"]):
            ray_tpu_torch.get(actors[idx].drop.remote(name), timeout=60)
        ent["driver"] = None
    model.clear()
    gc.collect()
    assert _drained(driver, timeout=60.0)
