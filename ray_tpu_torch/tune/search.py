"""Search spaces + searchers.

Analog of the reference's ``python/ray/tune/search/`` — sample-space API
(``tune.uniform/loguniform/choice/randint/grid_search`` from
``tune/search/sample.py``) and the default ``BasicVariantGenerator``
(grid × random sampling). Third-party searchers (optuna/hyperopt/...) plug in
through the same ``Searcher`` interface (``suggest``/``on_trial_complete``).

The port's copy of ``ray_tpu/tune/search.py``.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float
    base: float = 10.0

    def sample(self, rng):
        lo, hi = math.log(self.low, self.base), math.log(self.high, self.base)
        return self.base ** rng.uniform(lo, hi)


@dataclass
class QUniform(Domain):
    low: float
    high: float
    q: float

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


@dataclass
class Randint(Domain):
    low: int
    high: int  # exclusive

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class RandnDomain(Domain):
    mean: float = 0.0
    sd: float = 1.0

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


@dataclass
class GridSearch:
    """Marker: expand every value as its own variant (reference:
    ``tune.grid_search``)."""

    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float, base: float = 10.0) -> LogUniform:
    return LogUniform(low, high, base)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(list(categories))


def randn(mean: float = 0.0, sd: float = 1.0) -> RandnDomain:
    return RandnDomain(mean, sd)


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


def sample_from(fn: Callable[[Dict], Any]) -> "SampleFrom":
    return SampleFrom(fn)


@dataclass
class SampleFrom(Domain):
    fn: Callable[[Dict], Any]

    def sample(self, rng):  # resolved against the partial config by the generator
        raise RuntimeError("SampleFrom is resolved by the variant generator")


# ---------------------------------------------------------------------------
# Searchers
# ---------------------------------------------------------------------------

class Searcher:
    """Pluggable search algorithm (reference: ``tune/search/searcher.py``).

    ``suggest`` returns a config dict, ``None`` when the search is
    exhausted, or :data:`Searcher.DEFER` when it cannot suggest *right now*
    (e.g. a ConcurrencyLimiter at capacity, or a sequential model-based
    searcher waiting for results) — the controller retries later.
    """

    DEFER = object()

    # Sequential searchers (model-based: each suggestion should see prior
    # results) are suggested LAZILY by the controller as slots free up,
    # instead of having every config pre-generated before the first result.
    sequential = False

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict] = None, error: bool = False
    ) -> None:
        pass


def _split_grid(space: Dict, prefix: Tuple = ()) -> Tuple[List[Tuple[Tuple, List]], Dict]:
    """Collect (key_path, values) grid axes; return (grids, space)."""
    grids: List[Tuple[Tuple, List]] = []

    def rec(node, path):
        if isinstance(node, GridSearch):
            grids.append((path, node.values))
        elif isinstance(node, dict):
            for k, v in node.items():
                rec(v, path + (k,))

    rec(space, prefix)
    return grids, space


def _assign(config: Dict, path: Tuple, value: Any) -> None:
    node = config
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _resolve(space: Any, rng: random.Random, partial: Dict) -> Any:
    """Resolve a (sub)space. Within each dict level, plain values and Domains
    resolve first and SampleFrom callbacks run last against the
    partially-built config, so ``sample_from(lambda c: c["a"] * 2)`` sees
    sibling ``a`` (including grid-chosen values pre-seeded by the
    generator)."""
    if isinstance(space, dict):
        out: Dict = dict(partial) if partial else {}
        deferred = []
        for k, v in space.items():
            if k in out:
                continue  # pre-seeded by a grid assignment
            if isinstance(v, SampleFrom):
                deferred.append((k, v))
            else:
                out[k] = _resolve(v, rng, {})
        for k, v in deferred:
            out[k] = v.fn(out)
        return out
    if isinstance(space, SampleFrom):
        return space.fn(partial)
    if isinstance(space, Domain):
        return space.sample(rng)
    if isinstance(space, GridSearch):
        return None  # placeholder; the generator overwrites via _assign
    return space


class BasicVariantGenerator(Searcher):
    """Grid expansion × random sampling (reference:
    ``tune/search/basic_variant.py``). ``num_samples`` repeats the full grid;
    pure-random spaces yield ``num_samples`` variants."""

    def __init__(self, space: Dict, num_samples: int = 1, seed: Optional[int] = None):
        super().__init__()
        self.space = space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = self._generate()
        self._next = 0

    def _generate(self) -> List[Dict]:
        grids, _ = _split_grid(self.space)
        variants: List[Dict] = []
        for _ in range(self.num_samples):
            if grids:
                for combo in itertools.product(*(vals for _, vals in grids)):
                    seed_cfg: Dict = {}
                    for (path, _), value in zip(grids, combo):
                        _assign(seed_cfg, path, value)
                    # top-level grid keys pre-seed resolution so sample_from
                    # callbacks can read them; nested grids are assigned after
                    cfg = _resolve(self.space, self.rng, seed_cfg)
                    for (path, _), value in zip(grids, combo):
                        _assign(cfg, path, value)
                    variants.append(cfg)
            else:
                variants.append(_resolve(self.space, self.rng, {}))
        return variants

    @property
    def total_variants(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


# ---------------------------------------------------------------------------
# Model-based search: TPE
# ---------------------------------------------------------------------------

def _flatten_domains(space: Dict, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    out: List[Tuple[Tuple, Any]] = []
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.extend(_flatten_domains(v, path))
        else:
            out.append((path, v))
    return out


def _get(config: Dict, path: Tuple) -> Any:
    node = config
    for k in path:
        node = node[k]
    return node


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator — the native model-based searcher
    (role of the reference's optuna/hyperopt integrations,
    ``python/ray/tune/search/optuna/optuna_search.py`` — implemented here
    rather than wrapped since the image carries neither library).

    Standard TPE (Bergstra et al., NeurIPS 2011): observations split into a
    good set (top ``gamma`` quantile by the objective) and a bad set; each
    dimension models l(x) (KDE over good values) and g(x) (over bad);
    candidates are drawn from l and scored by the density ratio l/g —
    maximizing it is equivalent to maximizing expected improvement.
    Dimensions are modeled independently (the classic simplification).

    Numeric domains use truncated Gaussian KDEs (log-space for
    ``loguniform``); ``choice``/``randint`` use smoothed categorical
    frequencies. ``grid_search`` / ``sample_from`` are not model-able —
    use the BasicVariantGenerator for those spaces.
    """

    sequential = True

    def __init__(self, space: Dict, *, metric: Optional[str] = None,
                 mode: str = "max", n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode)
        self.space = space
        self.dims = _flatten_domains(space)
        for path, dom in self.dims:
            if isinstance(dom, (GridSearch, SampleFrom)):
                raise ValueError(
                    f"TPESearcher cannot model {type(dom).__name__} at "
                    f"{'.'.join(path)}; use BasicVariantGenerator")
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._live: Dict[str, Dict] = {}     # trial_id -> config
        self._obs: List[Tuple[Dict, float]] = []  # (config, score-to-MAXIMIZE)

    # -- observation plumbing -------------------------------------------------

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None,
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._obs.append((cfg, v if self.mode == "max" else -v))

    # -- modeling -------------------------------------------------------------

    def _split(self) -> Tuple[List[Dict], List[Dict]]:
        ranked = sorted(self._obs, key=lambda cv: cv[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        return good, bad

    @staticmethod
    def _kde_logpdf(x: float, centers: List[float], bw: float,
                    lo: float, hi: float) -> float:
        # Mixture of Gaussians at the observed values, floor-mixed with the
        # uniform prior so unexplored regions keep non-zero mass.
        p_prior = 1.0 / max(hi - lo, 1e-12)
        p = 0.0
        for c in centers:
            z = (x - c) / bw
            p += math.exp(-0.5 * z * z) / (bw * 2.5066282746310002)
        p = p / len(centers) if centers else 0.0
        return math.log(0.8 * p + 0.2 * p_prior + 1e-300)

    def _numeric_axis(self, dom, good_vals, bad_vals):
        """Sample candidates from l, score by log l - log g; returns the
        best candidate in the ORIGINAL domain units."""
        logspace = isinstance(dom, LogUniform)
        if logspace:
            f = lambda v: math.log(v, dom.base)
            lo, hi = f(dom.low), f(dom.high)
            gvals = [f(v) for v in good_vals]
            bvals = [f(v) for v in bad_vals]
        else:
            lo, hi = float(dom.low), float(dom.high)
            gvals = [float(v) for v in good_vals]
            bvals = [float(v) for v in bad_vals]
        span = max(hi - lo, 1e-12)
        bw_g = max(span / max(len(gvals), 1) ** 0.5, span * 0.05)
        bw_b = max(span / max(len(bvals), 1) ** 0.5, span * 0.05)

        best_x, best_score = None, -float("inf")
        for _ in range(self.n_candidates):
            if gvals and self.rng.random() < 0.8:
                c = self.rng.choice(gvals)
                x = min(max(self.rng.gauss(c, bw_g), lo), hi)
            else:
                x = self.rng.uniform(lo, hi)
            s = (self._kde_logpdf(x, gvals, bw_g, lo, hi)
                 - self._kde_logpdf(x, bvals, bw_b, lo, hi))
            if s > best_score:
                best_x, best_score = x, s
        v = dom.base ** best_x if logspace else best_x
        if isinstance(dom, QUniform):
            v = round(v / dom.q) * dom.q
        return v

    def _categorical_axis(self, categories, good_vals, bad_vals):
        def probs(vals):
            # Jeffreys (+0.5) smoothing: keeps every category drawable while
            # leaving the density ratio informative on the SMALL good sets a
            # γ-split produces (+1 washed the ratio out to ~flat).
            counts = {i: 0.5 for i in range(len(categories))}
            for v in vals:
                try:
                    counts[categories.index(v)] += 1.0
                except ValueError:
                    pass
            total = sum(counts.values())
            return [counts[i] / total for i in range(len(categories))]

        pg, pb = probs(good_vals), probs(bad_vals)
        scores = [pg[i] / pb[i] for i in range(len(categories))]
        # Sample candidates ∝ l (the smoothed good-set frequencies), then
        # take the density-ratio argmax among THAT candidate set — the
        # stochastic draw keeps exploration alive when suggestions are made
        # back-to-back with no new observations (ConcurrencyLimiter with
        # max_concurrent > 1); a deterministic argmax over all categories
        # would emit the identical value every time.
        k = max(1, min(self.n_candidates, len(categories)))
        candidates = self.rng.choices(range(len(categories)), weights=pg, k=k)
        best_i = max(candidates, key=lambda i: scores[i])
        return categories[best_i]

    def _model_suggest(self) -> Dict:
        good, bad = self._split()
        cfg: Dict = {}
        for path, dom in self.dims:
            gv = [_get(c, path) for c in good]
            bv = [_get(c, path) for c in bad]
            if isinstance(dom, Choice):
                val = self._categorical_axis(dom.categories, gv, bv)
            elif isinstance(dom, Randint):
                val = int(round(self._numeric_axis(
                    Uniform(dom.low, dom.high - 1), gv, bv)))
            elif isinstance(dom, (Uniform, LogUniform, QUniform)):
                val = self._numeric_axis(dom, gv, bv)
            elif isinstance(dom, RandnDomain):
                # Unbounded: approximate with a wide uniform around the data.
                allv = [float(v) for v in gv + bv] or [dom.mean]
                lo = min(allv) - 3 * dom.sd
                hi = max(allv) + 3 * dom.sd
                val = self._numeric_axis(Uniform(lo, hi), gv, bv)
            elif isinstance(dom, Domain):
                val = dom.sample(self.rng)
            else:
                val = dom  # constant
            _assign(cfg, path, val)
        return cfg

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if len(self._obs) < self.n_initial:
            cfg = _resolve(self.space, self.rng, {})
        else:
            cfg = self._model_suggest()
        self._live[trial_id] = cfg
        return cfg


class ConcurrencyLimiter(Searcher):
    """Caps how many of a searcher's suggestions are unfinished at once
    (reference: ``tune/search/concurrency_limiter.py``) — a sequential
    model-based searcher under a limiter of 1 sees every result before its
    next suggestion even when the cluster could run more trials."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(metric=searcher.metric, mode=searcher.mode)
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    # metric/mode assignments made by the Tuner must reach the inner searcher.
    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name in ("metric", "mode") and "searcher" in self.__dict__:
            setattr(self.searcher, name, value)

    @property
    def sequential(self):  # type: ignore[override]
        return True

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return Searcher.DEFER
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg is not Searcher.DEFER:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None,
                          error: bool = False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result=result, error=error)
