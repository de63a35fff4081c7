"""Multirun / hyperparameter sweep entry of the port.

The counterpart of ``scripts/sweep.py`` (the reference's hydra ``-m``
multirun and its optuna sweeper, ``configs/hparams_search/``), with its
pure-Python search code copied here: the same trial lists for the same
arguments and seed, and the same TPE proposals from the same history.

Grid multirun over comma-separated override values (commas inside
brackets stay in one value)::

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.sweep \
        datamodule=synthetic "model.lr_args.gen_lr=1e-4,4e-4" "seed=0,1"

Random search with ``--random N`` over ``key=low:high(:log)`` ranges, TPE
(the Tree-structured Parzen Estimator, optuna's ``TPESampler``) with
``--tpe N`` (comma lists are then categorical choices), ``--monitor`` the
metric to rank by (default ``total/val``) and ``--mode min|max``.

Each trial is one :func:`..tasks.train` in this process (which starts one
process per rank itself where the trial asks for more than one device);
a failed trial is logged and the sweep goes on. The best trial is printed
last. Runs on the card unless the overrides say ``trainer.platform=cpu``.
"""
from __future__ import annotations

import itertools
import math
import random
import sys

from .tasks import train
from .utils.config import compose
from .utils.logging import get_logger

__all__ = ["main"]

log = get_logger("sweep")


def _split_grid(val: str) -> list[str]:
    """Split on commas OUTSIDE brackets ('[1,4,4]' is one value;
    '1e-4,4e-4' is two)."""
    parts, depth, cur = [], 0, ""
    for ch in val:
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    return parts


def _grid_trials(overrides):
    fixed, grids = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = _split_grid(val)
        if len(parts) > 1:
            grids.append([(key, v) for v in parts])
        else:
            fixed.append(ov)
    for combo in itertools.product(*grids) if grids else [()]:
        yield fixed + [f"{k}={v}" for k, v in combo]


def _random_trials(overrides, n, seed=0):
    rng = random.Random(seed)
    fixed, ranges = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = val.split(":")
        if len(parts) >= 2:
            ranges.append((key, float(parts[0]), float(parts[1]),
                           len(parts) > 2 and parts[2] == "log"))
        else:
            fixed.append(ov)
    for _ in range(n):
        trial = list(fixed)
        for key, lo, hi, is_log in ranges:
            if is_log:
                v = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                v = rng.uniform(lo, hi)
            trial.append(f"{key}={v:.6g}")
        yield trial


class _TPESampler:
    """Minimal Tree-structured Parzen Estimator (the optuna TPESampler's
    algorithm: Bergstra et al. 2011) over independent 1-D Parzen windows.

    Minimizes. Observations are split into the best ``gamma`` fraction
    ("good", l(x)) and the rest ("bad", g(x)); candidates are drawn from
    l(x) and ranked by log l(x) - log g(x). Numeric dims get Gaussian
    mixtures (one component per observation + a uniform-prior component,
    bandwidth range/sqrt(n)); categorical dims get Laplace-smoothed
    frequency ratios. The first ``n_startup`` trials are uniform random
    (mnist_optuna.yaml sets n_startup_trials; default kept small for the
    in-process use here).
    """

    def __init__(self, specs, seed=0, gamma=0.25, n_startup=5,
                 n_candidates=24):
        self.specs = specs          # list of (key, kind, data)
        self.rng = random.Random(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.history = []           # list of (value, {key: raw})

    # -- per-dim helpers (numeric dims work in u-space: log(x) if flagged)
    @staticmethod
    def _to_u(x, lo, hi, is_log):
        return math.log(x) if is_log else x

    @staticmethod
    def _from_u(u, is_log):
        return math.exp(u) if is_log else u

    def _num_bounds(self, lo, hi, is_log):
        return ((math.log(lo), math.log(hi)) if is_log else (lo, hi))

    def _sample_num(self, obs_u, lo_u, hi_u):
        """Draw from the Parzen mixture over ``obs_u`` + uniform prior."""
        span = hi_u - lo_u
        sigma = span / math.sqrt(len(obs_u) + 1) if obs_u else span
        # components: each observation + one uniform-prior slot
        k = self.rng.randrange(len(obs_u) + 1)
        if k == len(obs_u):
            return self.rng.uniform(lo_u, hi_u)
        u = self.rng.gauss(obs_u[k], sigma)
        return min(max(u, lo_u), hi_u)

    @staticmethod
    def _logpdf_num(u, obs_u, lo_u, hi_u):
        span = max(hi_u - lo_u, 1e-12)
        sigma = span / math.sqrt(len(obs_u) + 1) if obs_u else span
        # mixture of N(obs, sigma) + uniform prior, equal weights
        logs = [-0.5 * ((u - o) / sigma) ** 2
                - math.log(sigma * math.sqrt(2 * math.pi)) for o in obs_u]
        logs.append(-math.log(span))
        m = max(logs)
        return m + math.log(sum(math.exp(x - m) for x in logs)) \
            - math.log(len(logs))

    def suggest(self):
        """Next parameter dict {key: raw_value}."""
        done = [h for h in self.history if h[0] == h[0]]  # drop NaNs
        if len(done) < self.n_startup:
            return self._random_params()
        done.sort(key=lambda h: h[0])
        n_good = max(1, math.ceil(self.gamma * len(done)))
        good = [h[1] for h in done[:n_good]]
        bad = [h[1] for h in done[n_good:]] or good
        best_cand, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand, score = {}, 0.0
            for key, kind, data in self.specs:
                if kind == "num":
                    lo, hi, is_log = data
                    lo_u, hi_u = self._num_bounds(lo, hi, is_log)
                    gu = [self._to_u(p[key], lo, hi, is_log) for p in good]
                    bu = [self._to_u(p[key], lo, hi, is_log) for p in bad]
                    u = self._sample_num(gu, lo_u, hi_u)
                    score += (self._logpdf_num(u, gu, lo_u, hi_u)
                              - self._logpdf_num(u, bu, lo_u, hi_u))
                    cand[key] = self._from_u(u, is_log)
                else:
                    choices = data
                    cg = [sum(1 for p in good if p[key] == c) + 1
                          for c in choices]
                    cb = [sum(1 for p in bad if p[key] == c) + 1
                          for c in choices]
                    idx = self.rng.choices(range(len(choices)),
                                           weights=cg)[0]
                    score += (math.log(cg[idx] / sum(cg))
                              - math.log(cb[idx] / sum(cb)))
                    cand[key] = choices[idx]
            if score > best_score:
                best_cand, best_score = cand, score
        return best_cand

    def _random_params(self):
        out = {}
        for key, kind, data in self.specs:
            if kind == "num":
                lo, hi, is_log = data
                lo_u, hi_u = self._num_bounds(lo, hi, is_log)
                out[key] = self._from_u(self.rng.uniform(lo_u, hi_u),
                                        is_log)
            else:
                out[key] = self.rng.choice(data)
        return out

    def tell(self, params, value):
        self.history.append((value, params))


def _parse_tpe_space(overrides):
    """Split overrides into fixed assignments and a TPE search space:
    `key=lo:hi(:log)` -> numeric, `key=a,b,c` -> categorical."""
    fixed, specs = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = val.split(":")
        cats = _split_grid(val)
        if len(parts) >= 2 and all(_is_float(p) for p in parts[:2]):
            specs.append((key, "num", (float(parts[0]), float(parts[1]),
                                       len(parts) > 2 and parts[2] == "log")))
        elif len(cats) > 1:
            specs.append((key, "cat", cats))
        else:
            fixed.append(ov)
    return fixed, specs


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _fmt(v) -> str:
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def main(argv: list[str] | None = None) -> int:
    """Parse the sweep's arguments, run its trials, print the best."""
    args = sys.argv[1:] if argv is None else list(argv)
    n_random = 0
    n_tpe = 0
    monitor = "total/val"
    mode = "min"
    rest = []
    it = iter(args)
    for a in it:
        if a == "--random":
            n_random = int(next(it))
        elif a == "--tpe":
            n_tpe = int(next(it))
        elif a == "--monitor":
            monitor = next(it)
        elif a == "--mode":
            mode = next(it)
        else:
            rest.append(a)

    results = []

    def run_trial(i, trial):
        log.info("=== trial %d: %s", i, trial)
        try:
            cfg = compose("train", trial)
            metrics = train(cfg)
            val = metrics.get(monitor, float("nan"))
            results.append((val, i, trial))
            log.info("trial %d -> %s=%s", i, monitor, val)
            return val
        except Exception as e:  # survive failed trials like the reference
            log.error("trial %d failed: %s", i, e)
            return float("nan")

    if n_tpe:
        fixed, specs = _parse_tpe_space(rest)
        sampler = _TPESampler(specs)
        sign = 1.0 if mode == "min" else -1.0
        for i in range(n_tpe):
            params = sampler.suggest()
            trial = fixed + [f"{k}={_fmt(v)}" for k, v in params.items()]
            val = run_trial(i, trial)
            sampler.tell(params, sign * val)
    else:
        trials = (_random_trials(rest, n_random) if n_random
                  else _grid_trials(rest))
        for i, trial in enumerate(trials):
            run_trial(i, trial)

    if results:
        best = (min if mode == "min" else max)(
            (r for r in results if r[0] == r[0]), default=None)
        if best:
            print(f"best trial {best[1]}: {monitor}={best[0]:.6g} "
                  f"overrides={best[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
