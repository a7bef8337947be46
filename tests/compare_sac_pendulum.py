"""SAC on Pendulum-v1 in both packages at the settings of the JAX package's
``tests/test_rllib.py::test_sac_learns_pendulum`` (1-step returns, the
default tau), seed by seed: the first, best and last episode-return means
of 30 iterations, and whether that test's gate holds.

Not a test: it shows that the two packages' returns are drawn from one
distribution at those settings. Each run is a process of its own, on the
CPU:

    JAX_PLATFORMS=cpu python tests/compare_sac_pendulum.py [--seeds 8] [-j 4]
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(pkg: str, seed: int) -> dict:
    import numpy as np
    import gymnasium as gym

    if pkg == "jax":
        import ray_tpu as rt
        from ray_tpu.rllib import SACConfig
        rt.init(resources={"CPU": 4, "TPU": 8})
    else:
        import torch
        torch.set_num_threads(1)
        import ray_tpu_torch as rt
        from ray_tpu_torch.rllib import SACConfig
        rt.init(resources={"CPU": 4, "GPU": 8})
    algo = (SACConfig()
            .environment(lambda: gym.make("Pendulum-v1"))
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4)
            .training(rollout_fragment_length=64, train_batch_size=128,
                      updates_per_iteration=48,
                      num_steps_sampled_before_learning=512,
                      hidden=(64, 64), lr=3e-3, n_step=1, seed=seed)
            .build())
    rets = []
    try:
        for _ in range(30):
            r = algo.train()["episode_return_mean"]
            if not np.isnan(r):
                rets.append(float(r))
    finally:
        algo.stop()
        rt.shutdown()
    # The test's gate, read where the test stops (best >= -300) or at 30.
    best = -np.inf
    for r in rets:
        best = max(best, r)
        if best >= -300.0:
            break
    gate = best >= rets[0] + 200.0 or best >= -400.0
    return {"pkg": pkg, "seed": seed, "first": rets[0], "best": max(rets),
            "last": rets[-1], "gate": bool(gate)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("-j", type=int, default=4, help="runs at once")
    ap.add_argument("--one", nargs=2, metavar=("PKG", "SEED"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one[0], int(args.one[1]))))
        return

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)

    def spawn(job):
        out = subprocess.run(
            [sys.executable, __file__, "--one", job[0], str(job[1])],
            env=env, capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    jobs = [(p, s) for s in range(args.seeds) for p in ("jax", "torch")]
    with ThreadPoolExecutor(args.j) as pool:
        rows = list(pool.map(spawn, jobs))
    print("package  seed    first     best     last  gate")
    for r in sorted(rows, key=lambda r: (r["pkg"], r["seed"])):
        print(f"{r['pkg']:>7} {r['seed']:5d} {r['first']:8.1f} "
              f"{r['best']:8.1f} {r['last']:8.1f}  {r['gate']}")
    from scipy.stats import mannwhitneyu
    for k in ("first", "best", "last"):
        j = [r[k] for r in rows if r["pkg"] == "jax"]
        t = [r[k] for r in rows if r["pkg"] == "torch"]
        print(f"{k}: mean jax {sum(j) / len(j):.1f} torch "
              f"{sum(t) / len(t):.1f}, Mann-Whitney p "
              f"{mannwhitneyu(j, t).pvalue:.2f}")


if __name__ == "__main__":
    main()
