"""Data parallel against one rank: the same global batch, N ranks and one.

The contract of ROADMAP item [16]: an N-rank step equals the one-rank step
on the same global batch, up to the order of an f32 sum. Each case below
runs once per rank inside a process group (:func:`run_cases`, started by
:func:`..parallel.distributed.run_ranks`), each rank on its rows of the
global batch, and once in a process without a group on the whole batch
(:func:`one_rank`); :func:`compare` holds the two to the tolerances below.

* ``codebook_stats``: K6 on each rank's rows with its statistics summed
  over the ranks (``nearest_code_stats_sharded``) against K6 on all rows;
* ``codebook``: the EMA codebook alone, its first (initialising) step and a
  second, both with restarts of unused codes, from the same ``z``;
* ``stage1``: stage-1 training steps (BatchNorm on global statistics, the
  codebook's init and restarts), the losses, every averaged gradient, the
  running statistics and the codebook's buffers after each step;
* ``stage2``: stage-2 training steps (the loss's draws made for the global
  batch), the losses, every averaged gradient, the Lt and telemetry
  buffers after each step;
* ``sampling``: argmax sampling with the batch split over the ranks, the
  gathered tokens against one rank's, bit for bit;
* ``dryrun``: a ``Stage2Trainer`` built and stepped once under the group
  (the counterpart of ``__graft_entry__.dryrun_multichip``): a finite loss
  and the same weights on every rank.

One limit of the comparison, of f32 arithmetic and not of the port: a
bias just before a BatchNorm has no effect on any loss, so its exact
gradient is 0 and its f32 gradient is noise of either sign; Adam divides
by that noise's own size and moves the bias by about the learning rate in
the noise's direction, which the order of a sum decides. That moves the
next BatchNorm's running mean, but not its variance or any loss: so the
running means are held after the first step only, the running variances
after every step.

On the card a case's ``held`` (default: every step) limits the steps held:
K6 sums each code's rows (``encode_sum``) in an order that varies from run
to run (one rank against itself differs by ~1e-7 in the EMA sums after a
step), and at a stage-1 step with 65536 rows some rows lie that close to
two codes, so from the second step on even one rank against itself can
assign rows to other codes. ``chip_smoke.py`` therefore holds stage 1's
first step there (the codebook's init and its restarts both happen in it)
and prints the one-rank run against itself beside it.

Each case takes its sizes from a spec (a plain dict: ``device``, and per
case the config and the global batch; ``timed``: more training steps after
the compared ones, each timed between two device synchronisations, their
median in ``step_ms``); the CPU tests run small ones, and
``chip_smoke.py`` phase 18 the job scripts' widths on the card (two ranks
on ``cuda:0`` over gloo). A case's ``kind`` (by default its name) says
which of the cases above it runs, so a spec may hold two of one kind. A
case's ``given`` replaces its seeded weights,
inputs and draws with ones made elsewhere (the CPU tests make them with
the JAX package, and hold the results to its ``pjit`` steps on a
``data=2`` mesh): ``state`` / ``z`` / ``draws`` (``init_rows``,
``restart_rows``) for the codebook; ``vqvae`` (a state dict), ``video``
and per-step ``draws`` for stage 1; ``generator`` and ``vqvae`` (state
dicts), ``batch`` and per-step ``draws`` (``t``, ``pt``, ``noise`` for the
global batch, each rank taking its rows) for stage 2; ``generator``,
``vqvae`` and ``labels`` for sampling. The steps past a ``draws`` list
draw from the case's generator.
"""
from __future__ import annotations

import copy
import statistics
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from ..parallel.distributed import (all_gather_rows, all_reduce_sum,
                                    is_distributed, local_rank, rank,
                                    world_size)
from ..parallel.mesh import create_mesh, shard_batch, shard_rows

__all__ = ["run_cases", "one_rank", "compare", "LOSS_RTOL", "GRAD_TOL",
           "BN_TOL", "EMA_RTOL", "launch_counts"]

# the tolerances of ROADMAP item [16]'s contract (tests/test_torch_ddp.py)
LOSS_RTOL = 1e-6      # losses, relative
GRAD_TOL = 1e-5       # gradients, of the step's largest |gradient|
BN_TOL = 1e-6         # BatchNorm running statistics, absolute
EMA_RTOL = 1e-6       # encode_sum / EMA sums and embeddings, relative


def launch_counts() -> dict[str, int]:
    """The launches of the CUDA kernels the cases reach (K2 to K6)."""
    from ..ops.attention import fused_mha, fused_mha_bwd
    from ..ops.codebook_kernel import nearest_code_stats
    from ..ops.megakernel import megakernel_step
    return {"K2": fused_mha.launches, "K5": fused_mha_bwd.launches,
            "K6": nearest_code_stats.launches,
            "K3": megakernel_step.launches_k3,
            "K4": megakernel_step.launches_k4}


def _rows(n: int) -> slice:
    return shard_rows(n, create_mesh())


def _global_mean(values: Mapping[str, torch.Tensor]) -> dict[str, float]:
    stacked = torch.stack([v.detach().float() for v in values.values()])
    return dict(zip(values, (all_reduce_sum(stacked) / world_size())
                    .tolist()))


def _timed_steps(step, n: int, device) -> float | None:
    """The median wall time of ``n`` calls of ``step``, in ms, each between
    two synchronisations of ``device``."""
    ms = []
    for _ in range(n):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms) if ms else None


def _step_draws(given: Mapping[str, Any] | None, step: int, device,
                rows: bool = False) -> dict:
    """The given draws of training step ``step`` on ``device`` (``rows``:
    this rank's rows of each), or none."""
    draws = (given or {}).get("draws", [])
    if step >= len(draws):
        return {}
    out = {k: torch.as_tensor(v).to(device) for k, v in draws[step].items()}
    return shard_batch(out, create_mesh()) if rows else out


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def _case_codebook_stats(spec: Mapping[str, Any], device) -> dict:
    from ..ops.codebook_kernel import (nearest_code_stats,
                                       nearest_code_stats_sharded)
    n, k, d = spec["n"], spec["k"], spec["d"]
    g = torch.Generator().manual_seed(spec.get("seed", 0))
    x = torch.randn((n, d), generator=g).to(device)
    e = torch.randn((k, d), generator=g).to(device)
    idx, n_total, encode_sum = nearest_code_stats_sharded(
        x[_rows(n)].contiguous(), e, nearest_code_stats)
    return {"indices": all_gather_rows(idx), "n_total": n_total,
            "encode_sum": encode_sum}


def _case_codebook(spec: Mapping[str, Any], device) -> dict:
    from ..models.vqvae import Codebook
    k, d, b = spec["k"], spec["d"], spec["b"]
    grid = tuple(spec.get("grid", (2, 2, 2)))
    given = spec.get("given")
    g = torch.Generator().manual_seed(spec.get("seed", 0))
    cb = Codebook(k, d).to(device)
    with torch.no_grad():
        cb.embeddings.copy_(torch.randn((k, d), generator=g))
        cb.ema_count.zero_()
        cb.ema_sum.copy_(cb.embeddings)
        cb.initialized.fill_(False)
    if given:
        cb.load_state_dict({n: torch.as_tensor(v)
                            for n, v in given["state"].items()})
        zs = [torch.as_tensor(z).to(device) for z in given["z"]]
    else:
        zs = [torch.randn((b, *grid, d), generator=g).to(device)
              for _ in range(spec.get("steps", 2))]
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for i, z in enumerate(zs):
        res = cb(z[_rows(b)], train=True, generator=gen,
                 **_step_draws(given, i, device))
        out.append({"perplexity": float(res["perplexity"]),
                    "encodings": all_gather_rows(res["encodings"]),
                    **{n: t.clone() for n, t in cb.named_buffers()}})
    return {"steps": out}


def _case_stage1(spec: Mapping[str, Any], device) -> dict:
    from ..train import stage1
    config = copy.deepcopy(spec["config"])
    b = spec["b"]
    given = spec.get("given")
    state = stage1.build_stage1(config, device,
                                torch.Generator().manual_seed(0))
    if given:
        state.vqvae.load_state_dict(given["vqvae"])
        batch = {"video": given["video"]}
    else:
        batch = stage1.synthetic_batch(config, b)
    batch = shard_batch(batch, create_mesh())
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for i in range(spec.get("steps", 2)):
        values = stage1.train_step(state, batch, gen,
                                   **_step_draws(given, i, device))
        out.append({
            "values": _global_mean(values),
            "grads": {n: p.grad for n, p in state.vqvae.named_parameters()},
            "buffers": dict(state.vqvae.named_buffers())})
        out[-1] = _cpu(out[-1])
    step_ms = _timed_steps(lambda: stage1.train_step(state, batch, gen),
                           spec.get("timed", 0), device)
    return {"steps": out, "step_ms": step_ms,
            "held": spec.get("held", len(out))}


def _case_stage2(spec: Mapping[str, Any], device) -> dict:
    from ..train import stage2
    config = copy.deepcopy(spec["config"])
    b = spec["b"]
    given = spec.get("given")
    state = stage2.build_stage2(config, device,
                                torch.Generator().manual_seed(0))
    if given:
        state.generator.load_state_dict(given["generator"])
        state.vqvae.load_state_dict(given["vqvae"])
        batch = dict(given["batch"])
    else:
        batch = stage2.synthetic_batch(config, b,
                                       torch.Generator().manual_seed(1))
    batch = shard_batch(batch, create_mesh())
    gen = torch.Generator(device=device).manual_seed(2)
    out = []
    for i in range(spec.get("steps", 2)):
        values = stage2.train_step(state, batch, gen,
                                   **_step_draws(given, i, device, True))
        d = state.generator.diffusion
        out.append(_cpu({
            "values": _global_mean(values),
            "grads": {n: p.grad for n, p in
                      state.generator.named_parameters()
                      if p.grad is not None},
            "buffers": {n: getattr(d, n) for n in
                        ("lt_history", "lt_count", "diffusion_acc",
                         "diffusion_keep")}}))
    step_ms = _timed_steps(lambda: stage2.train_step(state, batch, gen),
                           spec.get("timed", 0), device)
    return {"steps": out, "step_ms": step_ms,
            "held": spec.get("held", len(out))}


def _case_sampling(spec: Mapping[str, Any], device) -> dict:
    from ..generate import build_models, sample_token_grid
    config = copy.deepcopy(spec["config"])
    b = spec["b"]
    given = spec.get("given")
    models = build_models(config, device, torch.Generator().manual_seed(0))
    n_classes = int(config["generator"]["textencoder"]["n_classes"])
    labels = torch.randint(0, n_classes, (b,),
                           generator=torch.Generator().manual_seed(1))
    if given:
        models.generator.load_state_dict(given["generator"])
        models.vqvae.load_state_dict(given["vqvae"])
        labels = torch.as_tensor(given["labels"])
    batch = shard_batch({"label": labels.to(device)}, create_mesh())
    tokens = sample_token_grid(models, batch,
                               torch.Generator().manual_seed(3),
                               sample=False, sampler=spec["sampler"])
    return {"tokens": tokens}


def _case_dryrun(spec: Mapping[str, Any], device) -> dict:
    import tempfile

    from ..data.synthetic import SyntheticVideoDataModule
    from ..train.loop import device_batch
    from ..train.stage2 import Stage2Trainer
    cfg = copy.deepcopy(spec["cfg"])
    b = spec["b"]
    dm = SyntheticVideoDataModule(batch_size=b, sequence_length=2,
                                  resolution=16, num_train=b, num_val=b)
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = Stage2Trainer(cfg, dm, run_dir)
        batch = next(iter(trainer.datamodule.train_batches(0)))
        trainer.build(batch)
        trainer._replicate()
        _, values = trainer.train_step(trainer.state,
                                       device_batch(batch, trainer.device),
                                       trainer.next_rng())
        flat = torch.cat([p.detach().reshape(-1) for p in
                          trainer.state.generator.parameters()])
        spread = (all_gather_rows(flat[None]) - flat[None]).abs().max()
    return {"rows": len(batch["label"]), "values": _global_mean(values),
            "weights_spread": float(spread)}


_CASES = {"codebook_stats": _case_codebook_stats, "codebook": _case_codebook,
          "stage1": _case_stage1, "stage2": _case_stage2,
          "sampling": _case_sampling, "dryrun": _case_dryrun}


def _run(spec: Mapping[str, Any]) -> dict:
    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", local_rank())
        # both sides in the JAX package's arithmetic: f32 products in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, case in spec["cases"].items():
        before = launch_counts()
        kind = case.get("kind", name)
        out[name] = {"kind": kind, **_cpu(_CASES[kind](case, device))}
        if device.type == "cuda":
            torch.cuda.synchronize()
        after = launch_counts()
        out[name]["launches"] = {k: after[k] - before[k] for k in after}
    return out


def run_cases(spec: Mapping[str, Any], out_dir: str) -> dict:
    """Run the spec's cases on this rank; write the results (on the CPU) to
    ``<out_dir>/rank<r>.pt`` and return them."""
    out = _run(spec)
    torch.save(out, Path(out_dir) / f"rank{rank()}.pt")
    return out


def one_rank(spec: Mapping[str, Any]) -> dict:
    """The spec's cases in this process without a group: the whole batch."""
    if is_distributed():
        raise RuntimeError("one_rank runs outside a process group")
    return _run(spec)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def compare(got: Mapping[str, Any], want: Mapping[str, Any],
            strict: bool = True, every_step: bool = False) -> dict:
    """Hold ``got`` (rank 0's results) to ``want`` (one rank's): returns
    each case's largest deviation of each kind, with the tensor and step
    where it is largest, and ``failed``, the kinds past their tolerance
    (indices, counts and tokens must be equal); ``strict`` raises
    AssertionError with the whole report where one failed. The training
    cases hold their ``held`` first steps (``every_step``: all)."""
    report: dict[str, dict] = {}
    failed: list[str] = []

    def check(case, what, err, tol, where=""):
        kinds = report.setdefault(case, {})
        if what not in kinds or err > kinds[what][0]:
            kinds[what] = (err, where)
        if not err <= tol and f"{case}: {what}" not in failed:
            failed.append(f"{case}: {what}")

    def equal(case, what, a, b, where=""):
        same = torch.equal(a, b)
        differ = 0 if same else int((a != b).sum())
        check(case, what, differ, 0, where)

    for case, w in want.items():
        g = got[case]
        kind = w.get("kind", case)
        if kind == "codebook_stats":
            equal(case, "indices", g["indices"], w["indices"])
            equal(case, "n_total", g["n_total"], w["n_total"])
            check(case, "encode_sum", _rel(g["encode_sum"], w["encode_sum"]),
                  EMA_RTOL)
        elif kind == "codebook":
            for i, (gs, ws) in enumerate(zip(g["steps"], w["steps"])):
                equal(case, "encodings", gs["encodings"], ws["encodings"],
                      f"step {i}")
                equal(case, "ema_count", gs["ema_count"], ws["ema_count"],
                      f"step {i}")
                for n in ("ema_sum", "embeddings"):
                    check(case, n, _rel(gs[n], ws[n]), EMA_RTOL, f"step {i}")
                check(case, "perplexity", abs(gs["perplexity"]
                                              / ws["perplexity"] - 1),
                      LOSS_RTOL, f"step {i}")
        elif kind in ("stage1", "stage2"):
            held = len(w["steps"]) if every_step else w["held"]
            for i, (gs, ws) in enumerate(zip(g["steps"][:held],
                                             w["steps"][:held])):
                for n, v in ws["values"].items():
                    check(case, "loss " + n, abs(gs["values"][n] - v)
                          / max(abs(v), 1e-30), LOSS_RTOL, f"step {i}")
                if set(gs["grads"]) != set(ws["grads"]):
                    check(case, "gradient names", 1, 0, f"step {i}")
                    continue
                largest = max(float(v.abs().max())
                              for v in ws["grads"].values())
                for n, v in ws["grads"].items():
                    check(case, "gradients", float(
                        (gs["grads"][n] - v).abs().max()) / largest,
                        GRAD_TOL, f"step {i} {n}")
                for n, v in ws["buffers"].items():
                    if n.endswith("running_mean") and i > 0:
                        continue        # module docstring
                    where = f"step {i} {n}"
                    if n.endswith(("running_mean", "running_var")):
                        check(case, "BatchNorm running statistics",
                              float((gs["buffers"][n] - v).abs().max()),
                              BN_TOL, where)
                    elif n.endswith(("ema_count", "lt_count",
                                     "initialized")):
                        equal(case, n.rsplit(".", 1)[-1], gs["buffers"][n],
                              v, where)
                    else:
                        check(case, n.rsplit(".", 1)[-1],
                              _rel(gs["buffers"][n], v), EMA_RTOL, where)
        elif kind == "sampling":
            equal(case, "tokens", g["tokens"], w["tokens"])
    report = {case: {what: (f"{err:.3g}" if isinstance(err, float)
                            else ("equal" if err == 0 else
                                  f"{err} differ")) + (f" ({where})"
                                                       if where else "")
                     for what, (err, where) in kinds.items()}
              for case, kinds in report.items()}
    report["failed"] = failed
    if strict and failed:
        import json
        raise AssertionError("past a tolerance: " + ", ".join(failed)
                             + "; " + json.dumps(report))
    return report
