"""Tensor parallelism over ``trainer.mesh.model`` (ROADMAP item [16b]) on the
CPU: gloo ranks against one rank and against the JAX package's steps on a
``(data=1, model=2)`` mesh of its CPU devices.

The contract: the port shards exactly the tensors JAX's ``shard_state``
shards, along the same dimensions (a dimension that does not divide is
kept whole); a step over a ``model=2`` mesh equals the one-rank step on
the same global batch up to the order of an f32 sum, and equals JAX's
step on its ``(1, 2)`` mesh; the codebook's indices are one rank's
exactly (ties across the shard boundary to the lower index, as
``jnp.argmin``); argmax sampling gives one rank's tokens; a checkpoint
holds whole tensors, so it restores bitwise on any mesh. The two-rank runs
go through ``probes/ddp_parity.py`` with a spec whose ``mesh`` is
``{"model": 2}`` (four ranks: ``{"data": 2, "model": 2}``); the tolerances
are the probe's (losses 1e-6 relative, gradients 1e-5 of the largest, EMA
buffers 1e-6 relative, indices, counts and tokens exactly) and, for the
bf16 denoiser, ``tests/test_torch_stage2.py``'s ``BF16_TOL``; against JAX
those of the one-process parity tests.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import make_discrete_diffusion as jax_make_dd
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.parallel.mesh import (
    create_mesh as jax_mesh, shard_batch as jax_shard_batch,
    shard_state as jax_shard_state)
from gif_synthesis_with_discrete_diffusion_tpu.train import (
    stage1 as jax_stage1, stage2 as jax_stage2)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.vqvae import (
    make_vqvae)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    codebook_kernel as cbk)
from gif_synthesis_with_discrete_diffusion_tpu_torch.parallel import mesh
from gif_synthesis_with_discrete_diffusion_tpu_torch.parallel.distributed \
    import is_distributed, run_ranks
from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
    ddp_parity)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
    stage2_config)
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
    compose)
from tests import test_torch_ddp as ddp_test
from tests import test_torch_slice as slice_test
from tests import test_torch_stage1 as s1_test
from tests import test_torch_stage2 as s2_test
from tests.test_torch_tasks import STAGE1 as TASK1, STAGE2 as TASK2, _run

TP = {"model": 2}
BF16 = copy.deepcopy(ddp_test.SMALL2)
BF16["generator"]["diffusion_model"]["transformer"]["dtype"] = "bfloat16"
# 15 codes: the token table's 16 rows divide over two shards
EVEN_TABLE = copy.deepcopy(ddp_test.SMALL2)
EVEN_TABLE["vqvae"]["n_codes"] = 15


def _ckpt_cfg(model: int) -> dict:
    cfg = copy.deepcopy(ddp_test.DRYRUN)
    cfg["trainer"]["mesh"] = {"model": model}
    return cfg


# ---- (a) the layout ------------------------------------------------------
def _jax_state_shapes(stage: int, model_cfg):
    """The JAX trainer's state for a composed ``model`` node, as shapes."""
    key = jax.random.key(0)
    if stage == 1:
        model = jax_stage1.make_vqvae(model_cfg)
        video = jnp.zeros((1, model.sequence_length, model.resolution,
                           model.resolution, 3))

        def init():
            v = model.init({"params": key, "codebook": key},
                           {"video": video}, train=True)
            return jax_stage1.VQVAEState(
                step=jnp.zeros((), jnp.int32), params=v["params"],
                batch_stats=v["batch_stats"], codebook=v["codebook"],
                opt_state=optax.adam(1e-4).init(v["params"]))
        return jax.eval_shape(init)
    ae = jax_stage1.make_vqvae({"generator": model_cfg["autoencoder"]})
    gen = jax_make_dd(model_cfg, num_embed=ae.n_codes,
                      latent_shape=ae.latent_shape)
    video = jnp.zeros((1, ae.sequence_length, ae.resolution, ae.resolution,
                       3))
    tokens = jnp.zeros((1, int(np.prod(ae.latent_shape))), jnp.int32)

    def init():
        av = ae.init({"params": key, "codebook": key}, {"video": video},
                     train=True)
        gv = gen.init({"params": key, "diffusion": key}, {}, tokens,
                      train=True)
        return jax_stage2.Stage2State(
            step=jnp.zeros((), jnp.int32), gen_params=gv["params"],
            diffusion=gv["diffusion"], ae_params=av["params"],
            ae_batch_stats=av["batch_stats"], ae_codebook=av["codebook"],
            opt_state=optax.adam(1e-4).init(gv["params"]))
    return jax.eval_shape(init)


# the JAX state's collections -> the port's modules
_OWNER = {"params": "vqvae", "codebook": "vqvae", "gen_params": "generator",
          "ae_params": "vqvae", "ae_codebook": "vqvae"}


def _jax_placement(stage: int, model_cfg):
    """{port name: dimension} of every leaf JAX's ``shard_state`` splits
    over ``model`` on a (1, 2) mesh (names through the flax bridge: a 2-D
    ``kernel`` is the transposed ``weight``), and the same for the Adam
    moments, apart."""
    shapes = _jax_state_shapes(stage, model_cfg)
    state = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    placed = jax_shard_state(state, jax_mesh(data=1, model=2,
                                             devices=jax.devices()[:2]))
    params, moments = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        dims = [i for i, a in enumerate(leaf.sharding.spec) if a == "model"]
        if not dims:
            continue
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        *scope, name = keys
        dim = dims[0]
        if name == "kernel":
            name, dim = "weight", leaf.ndim - 1 - dim
        elif name == "embedding":
            name = "weight"
        if keys[0] == "opt_state":
            # .../mu|nu/<param path>: the moment of a parameter
            at = max(i for i, k in enumerate(scope) if k in ("mu", "nu"))
            moments.setdefault(".".join(["generator", *scope[at + 1:],
                                         name]), set()).add(dim)
        else:
            params[".".join([_OWNER[keys[0]], *scope[1:], name])] = dim
    return params, moments


def _port_placement(stage: int, model_cfg):
    with torch.device("meta"):
        if stage == 1:
            modules = {"vqvae": make_vqvae(model_cfg)}
        else:
            cfg = stage2_config(model_cfg)
            from gif_synthesis_with_discrete_diffusion_tpu_torch.models \
                .discrete_diffusion import make_discrete_diffusion
            vqvae = make_vqvae(cfg["vqvae"])
            modules = {"vqvae": vqvae, "generator": make_discrete_diffusion(
                cfg, int(cfg["vqvae"]["n_codes"]), vqvae.latent_shape)}
    return {f"{k}.{n}": d for k, m in modules.items()
            for n, d in mesh.sharded_names(m, mesh.Mesh(model=2)).items()}


@pytest.mark.parametrize("overrides", [[], ["model=discrete_diffusion"]],
                         ids=["stage1", "stage2"])
def test_sharded_tensors_are_jax_shard_states(overrides):
    model_cfg = compose("train", overrides)["model"]
    stage = int(model_cfg["stage"])
    want, moments = _jax_placement(stage, model_cfg)
    got = _port_placement(stage, model_cfg)
    assert got == want
    if stage == 1:
        assert set(got) == {f"vqvae.codebook.{n}" for n in
                            ("embeddings", "ema_sum", "ema_count")}
        assert not moments
    else:
        t = "generator.diffusion.transformer"
        # JAX's fallback: 2049 token rows do not divide; no rule for the
        # MLP's output bias
        assert f"{t}.content_emb.emb.weight" not in got
        assert f"{t}.block0.mlp_proj.bias" not in got
        assert {f"{t}.to_logits.weight", f"{t}.block18.mlp_proj.weight",
                "vqvae.codebook.ema_count"} <= set(got)
        # Adam's moments: those of the sharded parameters, each as its
        # parameter (the port's Adam keeps its moments in its parameters'
        # local shapes)
        assert moments == {n: {d} for n, d in got.items()
                           if n.startswith("generator.")}


def test_rules_fall_back_to_whole_where_a_dimension_does_not_divide():
    m = mesh.Mesh(model=2)
    with torch.device("meta"):
        odd = make_vqvae({"n_codes": 15, "embedding_dim": 8})
    assert mesh.sharded_names(odd, m) == {}
    assert mesh.sharded_names(odd, mesh.Mesh(model=1)) == {}
    with pytest.raises(RuntimeError, match="process group"):
        mesh.shard_module_(make_vqvae({"n_codes": 16, "embedding_dim": 8,
                                       "n_hiddens": 8, "n_res_layers": 1}),
                           m)


# ---- (e) the global nearest code, ties across the shard boundary ----------
def test_new_k6_entries_plain_versions_equal_the_reference():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((64, 8), generator=g)
    e = torch.randn((12, 8), generator=g)
    e[6:] = e[:6]                       # every code again in the other half
    idx, n_total, encode_sum = cbk.nearest_code_stats_reference(x, e)
    assert int(idx.max()) < 6           # the first copy wins
    local = []
    for r in range(2):
        li, ld = cbk.nearest_code_dist_reference(x, e[6 * r:6 * (r + 1)])
        local.append((li + 6 * r, ld))
    shard = torch.argmin(torch.stack([d for _, d in local]), dim=0)
    got = torch.stack([i for i, _ in local]).gather(0, shard[None])[0]
    assert torch.equal(got, idx)
    for lo in (0, 6):
        n, s = cbk.code_stats_range_reference(x, got, lo, 6)
        assert torch.equal(n, n_total[lo:lo + 6])
        torch.testing.assert_close(s, encode_sum[lo:lo + 6], rtol=0,
                                   atol=0)
    # the CPU wrappers take the plain versions
    assert torch.equal(cbk.nearest_code_dist(x, e)[0], idx)
    assert torch.equal(cbk.code_stats(x, idx, 0, 12)[0], n_total)


# ---- (b), (c), (e), (f): two ranks at model=2 ------------------------------
@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    s1, s2 = ddp_test._stage1_inputs(rng), ddp_test._stage2_inputs(rng)
    v = s1["variables"]
    s2_weights = ddp_test._port_weights(s2)
    spec = {"device": "cpu", "mesh": TP, "cases": {
        "codebook_stats": {"n": 96, "k": 24, "d": 8, "seed": 5},
        "codebook_ties": {"kind": "codebook_stats", "n": 96, "k": 24,
                          "d": 8, "seed": 6, "repeat": True},
        "codebook": {"k": 32, "d": 8, "b": 2, "grid": (1, 2, 2),
                     "steps": 2},
        "stage1": {"config": ddp_test.STAGE1, "b": 4, "steps": 2},
        "stage2": {"config": ddp_test.SMALL2, "b": 4, "steps": 2},
        "stage2_bf16": {"kind": "stage2", "config": BF16, "b": 4,
                        "steps": 1},
        "stage2_even_table": {"kind": "stage2", "config": EVEN_TABLE,
                              "b": 4, "steps": 1},
        "sampling": {"config": ddp_test.SMALL2, "b": 4, "sampler": "model"},
        "sampling_megakernel": {"kind": "sampling",
                                "config": ddp_test.SMALL2, "b": 4,
                                "sampler": "megakernel"},
        "stage1_jax": {"kind": "stage1", "config": s1_test.CONFIG, "b": 4,
                       "steps": 1, "given": {
                           "vqvae": vqvae_state_dict(
                               v["params"], v["batch_stats"],
                               v["codebook"]),
                           "video": s1["video"], "draws": s1["draws"]}},
        "stage2_jax": {"kind": "stage2", "config": slice_test.CONFIG,
                       "b": 4, "steps": 1, "given": {
                           **s2_weights, "draws": s2["draws"], "batch": {
                               "video": s2["video"],
                               "label": s2["labels"]}}},
    }}
    return {"stage1": s1, "stage2": s2, "spec": spec,
            "mesh": jax_mesh(data=1, model=2, devices=jax.devices()[:2])}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ranks")
    spec = inputs["spec"]
    rank0 = run_ranks(ddp_parity.run_cases, 2, "cpu", spec, str(out))
    rank1 = torch.load(out / "rank1.pt", weights_only=False)
    assert not is_distributed()
    return rank0, rank1, ddp_parity.one_rank(spec)


def _case(runs, name):
    rank0, rank1, one = runs
    report = ddp_parity.compare({name: rank0[name]}, {name: one[name]})
    # the two shards hand back the same whole results
    ddp_parity.compare({name: rank1[name]}, {name: rank0[name]})
    return rank0[name], one[name], report.get(name, {})


@pytest.mark.parametrize("name", ["codebook_stats", "codebook_ties"])
def test_sharded_codebook_lookup_equals_one_rank(runs, name):
    got, one, report = _case(runs, name)
    assert report["indices"] == report["n_total"] == "equal"
    if name == "codebook_ties":
        # every row's nearest code has a copy in the other shard: the
        # lower one won
        assert int(got["indices"].max()) < 12
    # the CPU run took the plain versions of K6's two new entries
    assert got["launches"]["K6 dist"] == got["launches"]["K6 stats"] == 0


def test_sharded_codebook_init_and_restart_equal_one_rank(runs):
    got, one, _ = _case(runs, "codebook")
    for step in got["steps"]:
        assert bool(step["initialized"])
        assert int((step["ema_count"] < 1.0).sum()) > 0   # restarts
        assert step["embeddings"].shape == (32, 8)        # whole again


@pytest.mark.parametrize("name", ["stage1", "stage2", "stage2_even_table"])
def test_training_steps_at_model_2_equal_one_rank(runs, name):
    got, one, report = _case(runs, name)
    assert float(report["gradients"].split()[0]) <= ddp_parity.GRAD_TOL
    assert set(got["steps"][0]["grads"]) == set(one["steps"][0]["grads"])
    # a rank holds less than the whole state
    assert got["bytes"] < one["bytes"]


def test_bf16_stage2_step_at_model_2_equals_one_rank(runs):
    """The bf16 denoiser: the MLP's partial products summed in f32 and
    rounded once, held at the bf16 bound of ``tests/test_torch_stage2.py``."""
    rank0, _, one = runs
    got, want = rank0["stage2_bf16"]["steps"][0], one["stage2_bf16"][
        "steps"][0]
    for n, v in want["values"].items():
        assert abs(got["values"][n] - v) <= s2_test.BF16_TOL * max(
            abs(v), 1e-30), n
    largest = max(float(v.abs().max()) for v in want["grads"].values())
    assert set(got["grads"]) == set(want["grads"])
    for n, v in want["grads"].items():
        assert float((got["grads"][n] - v).abs().max()) <= \
            s2_test.BF16_TOL * largest, n


@pytest.mark.parametrize("name", ["sampling", "sampling_megakernel"])
def test_argmax_sampling_at_model_2_equals_one_rank(runs, name):
    got, one, report = _case(runs, name)
    assert report["tokens"] == "equal"
    assert tuple(got["tokens"].shape) == (4, 2, 4, 4)


def test_stage1_step_at_model_2_matches_jax_on_its_1x2_mesh(inputs, runs):
    """The first step against the JAX package's ``_train_step`` jitted on
    its ``(1, 2)`` mesh with ``shard_state``'s placement: the losses, every
    gradient, the BatchNorm running statistics and the codebook's buffers."""
    inp = inputs["stage1"]
    v = inp["variables"]
    tx = ddp_test._record_grads()
    jstate = jax_shard_state(jax_stage1.VQVAEState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], codebook=v["codebook"],
        opt_state=tx.init(v["params"])), inputs["mesh"])
    new, want = jax.jit(functools.partial(
        jax_stage1._train_step, model=inp["model"], tx=tx,
        loss_dict=s1_test.CONFIG["losses"]["loss_dict"],
        resolution=s1_test.KW["resolution"]))(
        jstate, jax_shard_batch({"video": inp["video"]}, inputs["mesh"]),
        inp["key"])
    assert "model" in str(new.codebook["codebook"]["embeddings"].sharding)
    step = _case(runs, "stage1_jax")[0]["steps"][0]
    for name, w in want.items():
        np.testing.assert_allclose(step["values"][name], float(w),
                                   rtol=s1_test.LOSS_RTOL, err_msg=name)
    ddp_test._hold_grads(step["grads"], new.opt_state, s1_test.GRAD_TOL,
                         1e-2)
    after = vqvae_state_dict(*(jax.device_get(t) for t in (
        new.params, new.batch_stats, new.codebook)))
    for name, got in step["buffers"].items():
        if got.dtype == torch.bool:
            assert bool(got) == bool(after[name]), name
        else:
            torch.testing.assert_close(got, after[name],
                                       rtol=s1_test.STATE_TOL,
                                       atol=s1_test.STATE_TOL, msg=name)


def test_stage2_step_at_model_2_matches_jax_on_its_1x2_mesh(inputs, runs):
    """The first step against the JAX package's ``_train_step`` on its
    ``(1, 2)`` mesh (the MLPs, ``to_logits`` and the frozen codebook sharded
    by ``shard_state``), its loss's key pinned to the draws the ranks got."""
    inp = inputs["stage2"]
    tx = ddp_test._record_grads()
    jstate = jax_shard_state(ddp_test._jax_stage2_state(inp, tx),
                             inputs["mesh"])
    batch = jax_shard_batch({"video": inp["video"], "label": inp["labels"]},
                            inputs["mesh"])
    loss = jd3pm.train_loss
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd3pm, "train_loss", lambda rng, *a, **k: loss(
            inp["key"], *a, **k))
        new, want = jax.jit(functools.partial(
            jax_stage2._train_step, autoencoder=inp["ae"],
            generator=inp["gen"], tx=tx, loss_dict={"l_dummy": 1.0},
            resolution=8))(jstate, batch, jax.random.key(0))
    step = _case(runs, "stage2_jax")[0]["steps"][0]
    np.testing.assert_allclose(step["values"]["total"], float(want["total"]),
                               rtol=s2_test.LOSS_RTOL)
    ddp_test._hold_grads(step["grads"], new.opt_state, s2_test.GRAD_TOL,
                         1e-4)
    for name in ("lt_history", "lt_count", "diffusion_acc",
                 "diffusion_keep"):
        np.testing.assert_allclose(
            step["buffers"][name].numpy(),
            np.asarray(new.diffusion["diffusion"][name]),
            rtol=s2_test.BUF_TOL, atol=s2_test.BUF_TOL, err_msg=name)


# ---- (d) four ranks: data=2 x model=2 --------------------------------------
def test_stage2_step_at_data_2_model_2_equals_one_rank(tmp_path):
    spec = {"device": "cpu", "mesh": {"data": 2, "model": 2}, "cases": {
        "stage2": {"config": ddp_test.SMALL2, "b": 4, "steps": 1},
        "codebook_stats": {"n": 96, "k": 24, "d": 8, "seed": 5}}}
    rank0 = run_ranks(ddp_parity.run_cases, 4, "cpu", spec, str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(1, 4)]
    one = ddp_parity.one_rank(spec)
    report = ddp_parity.compare(rank0, one)
    assert float(report["stage2"]["gradients"].split()[0]) <= \
        ddp_parity.GRAD_TOL
    assert report["codebook_stats"]["indices"] == "equal"
    # the Lt counts hold the global batch: 4 rows, one step
    assert float(rank0["stage2"]["steps"][0]["buffers"]["lt_count"]
                 .sum()) == 4.0
    for other in ranks:
        ddp_parity.compare(other, rank0)


# ---- (g) checkpoints between meshes ----------------------------------------
def _flat(state, prefix=""):
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {}


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k, v in fa.items():
        assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k


def test_checkpoints_restore_bitwise_across_meshes_and_resume(tmp_path):
    one_dir, two_dir = tmp_path / "one", tmp_path / "two"
    case = {"kind": "checkpoint", "cfg": _ckpt_cfg(1), "b": 4}
    spec1 = {"device": "cpu", "cases": {"c": dict(case, save=str(one_dir))}}
    one = ddp_parity.one_rank(spec1)["c"]
    _bitwise(one["resumed"], one["straight"])
    spec2 = {"device": "cpu", "mesh": TP, "cases": {"c": dict(
        case, cfg=_ckpt_cfg(2), save=str(two_dir), load=str(one_dir))}}
    two = run_ranks(ddp_parity.run_cases, 2, "cpu", spec2,
                    str(tmp_path))["c"]
    # model=1's file, whole on two shards; a model=2 resume is bitwise
    _bitwise(two["loaded"], torch.load(one_dir / "1" / "state.pt",
                                       weights_only=False))
    _bitwise(two["resumed"], two["straight"])
    saved2 = torch.load(two_dir / "1" / "state.pt", weights_only=False)
    w = saved2["generator"]["diffusion.transformer.block0.mlp_fc.weight"]
    assert w.shape[0] == 4 * 32            # whole, not one shard's rows
    spec3 = {"device": "cpu", "cases": {"c": dict(
        case, save=str(tmp_path / "three"), load=str(two_dir))}}
    _bitwise(ddp_parity.one_rank(spec3)["c"]["loaded"], saved2)


# ---- (h) the entries --------------------------------------------------------
def test_tasks_and_generate_run_at_model_2(tmp_path):
    tp = ["trainer.host_device_count=2", "trainer.mesh.model=2"]
    proc = _run("tasks", "train", *TASK1, *tp, "trainer.max_epochs=1",
                f"paths.output_dir={tmp_path / 's1'}")
    assert proc.returncode == 0, proc.stderr
    proc = _run("tasks", "train", *TASK2, *tp, "trainer.max_epochs=1",
                f"paths.output_dir={tmp_path / 's2'}")
    assert proc.returncode == 0, proc.stderr
    (run,) = [p for p in (tmp_path / "s2").iterdir() if p.is_dir()]
    proc = _run("generate", *TASK2, *tp, f"ckpt_path={run / 'checkpoints'}",
                "+num_samples=4", f"+out_dir={tmp_path / 'gen'}")
    assert proc.returncode == 0, proc.stderr
    assert "generated 4 clips" in proc.stdout
