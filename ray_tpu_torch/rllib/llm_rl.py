"""LLM post-training RL — the RLAX-style actor-learner split.

The workload that ties the serving and training stacks together:
**generation actors** sample completions for a prompt dataset from the paged
continuous-batching engine (``serve/llm.py PagedLLMEngine`` over
``models/generate.py`` — on the card its attention is the paged-attention
kernel; repeated prompts hit the prefix cache), a **pluggable reward
function** scores them into the replay buffer (``rllib/replay.py``), and a
**policy-gradient learner** updates the transformer with the APPO loss
shape — clipped surrogate over per-token sequence log-probs, advantage =
reward − batch baseline. Its forward over sequences padded to
``max_seq_len`` takes flash attention from 1024 tokens on, as the train
step does. Weights flow back learner→generators every
``weight_sync_interval`` iterations (the staleness knob); each sync resets
the generators' KV pool, since cached K/V computed under old params would
otherwise leak into new rollouts.

The whole loop repeats under a fixed seed: request seeds are a counter over
the base seed, prompts round-robin the dataset, and the driver consumes
generator results in fixed order.

Counterpart of ``ray_tpu/rllib/llm_rl.py``. Differences by design:
``GenerationActor.set_weights`` casts and moves the new parameters once, as
the engine's construction does, where the JAX package swaps the tree; the
learner takes the port's ``Learner`` device policy, where the JAX package
pins it on the host: ``LLMRLConfig.learner_device`` defaults to ``"auto"``
(the host below 1M parameters, else the card, raising without one); log-probs
are taken in f32 from the compute-dtype logits (the JAX package takes them in
the compute dtype — the same on the f32 ``tiny`` configurations); and the
generators run on the card unless ``generator_device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models import transformer
from ray_tpu_torch.rllib.learner import Learner, device_for
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.rl_module import tree_leaves, tree_map
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger(__name__)


def _default_reward(prompt: Sequence[int], completion: Sequence[int],
                    target: int = 3) -> float:
    """Toy dense reward: fraction of completion tokens equal to ``target``.
    Trivially gameable by design — a smoke test only needs a signal the
    policy gradient can climb deterministically."""
    if not len(completion):
        return 0.0
    return float(np.mean(np.asarray(completion) == target))


def _tensor(x) -> torch.Tensor:
    """A weight leaf as a tensor: shared with a writable array, copied from
    a read-only one (an object-store view)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def token_logps(params, tokens: torch.Tensor,
                config: transformer.TransformerConfig) -> torch.Tensor:
    """tokens [B, L] → per-position log p(tokens[t] | tokens[<t]), [B, L]
    in f32 (position 0 is a dummy 0; masks never select it): one forward
    over the padded sequences."""
    tokens = tokens.to(torch.int64)
    logits = transformer.forward(params, tokens, config)
    logp_all = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    logp = logp_all.gather(-1, tokens[:, 1:, None])[..., 0]
    return torch.cat([torch.zeros_like(logp[:, :1]), logp], dim=1)


@dataclass
class LLMRLConfig:
    # Transformer shape (models/transformer.py tiny() overrides).
    # vocab_size stays a multiple of vocab_multiple so sampled ids < vocab.
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    # Prompt dataset: token-id lists. None = a small synthetic set.
    prompts: Optional[List[List[int]]] = None
    # reward_fn(prompt_tokens, completion_tokens) -> float
    reward_fn: Callable[[Sequence[int], Sequence[int]], float] = _default_reward
    num_generators: int = 2
    rollouts_per_iter: int = 16       # completions sampled per iteration
    max_new_tokens: int = 8
    temperature: float = 1.0
    train_batch: int = 32             # sequences per learner update
    updates_per_iter: int = 8
    buffer_capacity: int = 1024
    lr: float = 1e-2
    clip_param: float = 0.3
    grad_clip: float = 1.0
    # Iterations between learner→generator weight broadcasts (staleness).
    weight_sync_interval: int = 1
    engine_slots: int = 2
    seed: int = 0
    # The learner's device: "auto" (the host below 1M parameters, else the
    # card), "cpu", or a device.
    learner_device: str = "auto"
    # The generators' engines: the card unless "cpu".
    generator_device: Optional[str] = None

    def build(self) -> "LLMRL":
        return LLMRL(self)


class GenerationActor:
    """Samples completions from a private paged LLM engine and returns the
    padded columnar rollout (tokens / mask / behavior log-probs).

    ``params`` (a tree of tensors or arrays) starts it on given weights;
    else they are drawn from ``seed``, as the learner's are."""

    def __init__(self, model_config, *, slots: int = 2, seed: int = 0,
                 params=None, device=None,
                 attention_kernel: Optional[str] = None):
        from ray_tpu_torch.serve.llm import PagedLLMEngine

        self.model_config = model_config
        if params is None:
            params = transformer.init_params(model_config, seed,
                                             device="cpu")
        else:
            params = tree_map(_tensor, params)
        self._engine = PagedLLMEngine(
            params, model_config, slots=slots,
            max_len=model_config.max_seq_len, chunk=4, name="llm-rl-gen",
            device=device, attention_kernel=attention_kernel)
        self._max_len = int(model_config.max_seq_len)

    @property
    def device(self) -> torch.device:
        return self._engine.device

    def _token_logps(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # Behavior log-probs under the params that SAMPLED the tokens (the
        # importance-ratio denominator): one extra forward over the padded
        # [1, max_len] sequence.
        with torch.no_grad():
            return token_logps(params, tokens, self.model_config)

    def set_weights(self, params) -> bool:
        """Load new weights: cast and moved once, and the KV pool reset
        (``PagedLLMEngine.set_params``). No requests are in flight between
        ``rollout()`` calls, so the reset is safe."""
        self._engine.set_params(tree_map(_tensor, params))
        return True

    def ping(self) -> bool:
        return True

    def rollout(self, prompts: List[List[int]], seeds: List[int],
                max_new_tokens: int, temperature: float) -> Dict[str, np.ndarray]:
        """Generate one completion per (prompt, seed); returns fixed-width
        columns padded to the engine max_len."""
        B, L = len(prompts), self._max_len
        tokens = np.zeros((B, L), np.int32)
        gen_mask = np.zeros((B, L), np.float32)
        behavior_logp = np.zeros((B, L), np.float32)
        prompt_len = np.zeros(B, np.int32)
        gen_len = np.zeros(B, np.int32)
        for b, (prompt, seed) in enumerate(zip(prompts, seeds)):
            completion = self._engine.generate(
                prompt, max_new_tokens=max_new_tokens,
                temperature=temperature, seed=int(seed))
            seq = list(prompt) + list(completion)
            n, p = len(seq), len(prompt)
            tokens[b, :n] = seq
            gen_mask[b, p:n] = 1.0
            prompt_len[b] = p
            gen_len[b] = n - p
            logp = self._token_logps(
                self._engine.params,
                torch.as_tensor(tokens[b][None], device=self.device))
            behavior_logp[b] = logp[0].cpu().numpy() * gen_mask[b]
        return {
            "tokens": tokens,
            "gen_mask": gen_mask,
            "behavior_logp": behavior_logp,
            "prompt_len": prompt_len,
            "gen_len": gen_len,
        }

    def kv_stats(self) -> Dict[str, float]:
        return self._engine.stats()

    def stop(self) -> None:
        close = getattr(self._engine, "close", None)
        if close is not None:
            close()


class LLMRLLearner(Learner):
    """Clipped-surrogate policy gradient over sequence log-probs — the
    APPO loss shape (appo.py ``_pg_loss``) applied per completion token,
    on the base Learner's optimizer machinery (``clip_grad_norm_`` +
    ``torch.optim.Adam``, optax's ``chain(clip, adam)``)."""

    def __init__(self, model_config, config: Dict[str, Any], seed: int = 0):
        self.spec = None
        self.module = None
        self.model_config = model_config
        self.config = dict(config)
        # Drawn on the host (init_params draws there for every device),
        # counted, then placed by the Learner's device policy.
        params = transformer.init_params(model_config, seed, device="cpu")
        self.device = device_for(transformer.param_count(params),
                                 self.config.get("device", "auto"))
        self.params = tree_map(
            lambda t: t.to(self.device).requires_grad_(True), params)
        self._leaves = tree_leaves(self.params)
        self.grad_clip = float(self.config.get("grad_clip", 1.0))
        self.optimizer = torch.optim.Adam(
            self._leaves, lr=self.config.get("lr", 3e-3), eps=1e-8)

    def loss_fn(self, params, batch) -> torch.Tensor:
        clip = self.config.get("clip_param", 0.3)
        logp = token_logps(params, batch["tokens"], self.model_config)[:, 1:]
        mask = batch["gen_mask"][:, 1:]
        behavior = batch["behavior_logp"][:, 1:]
        adv = batch["advantage"][:, None]          # [B, 1] per-sequence
        ratio = torch.exp(logp - behavior)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        denom = torch.clamp(mask.sum(), min=1.0)
        return -torch.sum(surrogate * mask) / denom


class LLMRL:
    """The end-to-end post-training loop (Tune-compatible ``train()``)."""

    def __init__(self, config: LLMRLConfig):
        self.config = config
        kw = dict(config.model_kwargs)
        self.model_config = transformer.tiny(**kw)
        assert (self.model_config.padded_vocab
                == self.model_config.vocab_size), \
            "vocab must pad to itself or sampled ids could exceed vocab"
        self.learner = LLMRLLearner(
            self.model_config,
            {"lr": config.lr, "clip_param": config.clip_param,
             "grad_clip": config.grad_clip, "device": config.learner_device},
            seed=config.seed)
        gen_cls = ray_tpu_torch.remote(GenerationActor)
        self._generators = [
            gen_cls.remote(self.model_config, slots=config.engine_slots,
                           seed=config.seed, device=config.generator_device)
            for _ in range(max(1, config.num_generators))
        ]
        self.prompts = config.prompts or self._default_prompts()
        self.buffer = PrioritizedReplayBuffer(
            config.buffer_capacity, alpha=0.0, seed=config.seed)
        self._iteration = 0
        self._rollouts = 0
        self._updates = 0
        # Generators start from the same seed as the learner, so their
        # params are already in sync; the first broadcast happens after the
        # first weight_sync_interval.

    @property
    def generators(self) -> list:
        return list(self._generators)

    def _default_prompts(self) -> List[List[int]]:
        rng = np.random.default_rng(self.config.seed + 7)
        V = self.model_config.vocab_size
        return [list(rng.integers(1, V, size=4)) for _ in range(8)]

    def _next_prompt_batches(self) -> List[List[List[int]]]:
        """Deterministic round-robin split of this iteration's prompts
        across generators."""
        cfg = self.config
        batches: List[List[List[int]]] = [[] for _ in self._generators]
        for j in range(cfg.rollouts_per_iter):
            idx = (self._rollouts + j) % len(self.prompts)
            batches[j % len(self._generators)].append(self.prompts[idx])
        return batches

    def sync_weights(self) -> float:
        """Broadcast the learner's weights to every generator (each resets
        its KV pool); returns the seconds it took."""
        t0 = time.perf_counter()
        weights = self.learner.get_weights()
        ray_tpu_torch.get([g.set_weights.remote(weights)
                           for g in self._generators])
        return time.perf_counter() - t0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        sync_s = 0.0
        # Staleness sync at iteration start: generators run the whole
        # iteration under these weights.
        if self._iteration > 0 and cfg.weight_sync_interval > 0 \
                and self._iteration % cfg.weight_sync_interval == 0:
            sync_s = self.sync_weights()

        t_roll = time.perf_counter()
        batches = self._next_prompt_batches()
        seed0 = cfg.seed + 100_000
        refs = []
        offset = 0
        for g, prompt_batch in zip(self._generators, batches):
            if not prompt_batch:
                continue
            seeds = [seed0 + self._rollouts + offset + j
                     for j in range(len(prompt_batch))]
            offset += len(prompt_batch)
            refs.append((g, prompt_batch,
                         g.rollout.remote(prompt_batch, seeds,
                                          cfg.max_new_tokens,
                                          cfg.temperature)))
        self._rollouts += cfg.rollouts_per_iter

        rewards: List[float] = []
        gen_tokens = 0
        # Fixed consumption order keeps the run deterministic even though
        # the generators sample concurrently.
        for g, prompt_batch, ref in refs:
            out = ray_tpu_torch.get(ref)
            B = len(prompt_batch)
            batch_rewards = np.zeros(B, np.float32)
            for b in range(B):
                p, n = int(out["prompt_len"][b]), int(out["gen_len"][b])
                completion = out["tokens"][b, p:p + n].tolist()
                batch_rewards[b] = cfg.reward_fn(prompt_batch[b], completion)
                gen_tokens += n
            rewards.extend(batch_rewards.tolist())
            self.buffer.add_batch({
                "tokens": out["tokens"],
                "gen_mask": out["gen_mask"],
                "behavior_logp": out["behavior_logp"],
                "reward": batch_rewards,
            })
        rollout_s = time.perf_counter() - t_roll

        t_upd = time.perf_counter()
        losses = []
        for _ in range(cfg.updates_per_iter):
            if len(self.buffer) < cfg.train_batch:
                break
            sampled = self.buffer.sample(cfg.train_batch)
            batch = {
                "tokens": sampled["tokens"],
                "gen_mask": sampled["gen_mask"],
                "behavior_logp": sampled["behavior_logp"],
                # Advantage = reward − batch baseline (the RLAX-style
                # leave-nothing-to-a-critic estimator for bandit-style
                # sequence rewards).
                "advantage": (sampled["reward"]
                              - float(np.mean(sampled["reward"]))),
            }
            losses.append(self.learner.update(batch)["loss"])
            self._updates += 1
        update_s = time.perf_counter() - t_upd

        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "reward_mean": float(np.mean(rewards)) if rewards else float("nan"),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "num_updates": self._updates,
            "num_rollouts": self._rollouts,
            "buffer_size": len(self.buffer),
            "rollout_tokens": gen_tokens,
            "time_weight_sync_s": sync_s,
            "time_rollout_s": rollout_s,
            "time_update_s": update_s,
        }

    def stop(self) -> None:
        for g in self._generators:
            try:
                ray_tpu_torch.get(g.stop.remote(), timeout=10.0)
            except Exception:  # noqa: BLE001
                log_swallowed(logger, "generation actor stop")
            try:
                ray_tpu_torch.kill(g)
            except Exception:  # noqa: BLE001
                log_swallowed(logger, "generation actor kill")
