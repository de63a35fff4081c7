"""Data parallel over two gloo processes on the CPU (ROADMAP item [16]),
held against the JAX package's ``pjit`` steps on a ``data=2`` mesh of its
CPU devices and against one process on the global batch.

The contract: an N-rank step equals the one-rank step on the same global
batch, up to the order of an f32 sum; and, as JAX's steps compute on the
global array, equals the JAX package's step on that mesh. The module
fixture ``inputs`` draws the weights with numpy and has the JAX package
make the draws (the codebook's candidate rows, stage 2's t, pt and
q-sample noise for the global batch); the weights reach the port through
``convert/from_flax.py``. ``runs`` starts the two ranks once
(``run_ranks``; each imports torch and the port, never JAX), runs every
case of ``probes/ddp_parity.py`` on them with those inputs, and runs the
same cases without a group on the whole batch.

Against one rank the tolerances are the probe's: losses 1e-6 relative,
gradients 1e-5 of the step's largest, BatchNorm running statistics 1e-6,
the codebook's EMA sums and embeddings 1e-6 relative, and indices, counts
and argmax tokens exactly. Against JAX they are those of the one-process
parity tests the cases come from (``test_torch_stage1.py``,
``test_torch_stage2.py``, ``test_torch_codebook_train.py``), imported
from them; indices and tokens exactly.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    Codebook as JaxCodebook)
from gif_synthesis_with_discrete_diffusion_tpu.ops.codebook_kernel import (
    nearest_code_stats_reference as jax_stats,
    nearest_code_stats_sharded as jax_stats_sharded)
from gif_synthesis_with_discrete_diffusion_tpu.parallel.mesh import (
    create_mesh as jax_mesh, replicate as jax_replicate,
    shard_batch as jax_shard_batch)
from gif_synthesis_with_discrete_diffusion_tpu.train import (
    stage1 as jax_stage1, stage2 as jax_stage2)
from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.parallel import mesh
from gif_synthesis_with_discrete_diffusion_tpu_torch.parallel.distributed \
    import is_distributed, run_ranks
from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
    ddp_parity)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.loop import (
    mesh_ranks)
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
    compose)
from tests import test_torch_codebook_train as cb_test
from tests import test_torch_slice as slice_test
from tests import test_torch_stage1 as s1_test
from tests import test_torch_stage2 as s2_test

STAGE1 = {"generator": {"embedding_dim": 8, "n_codes": 32, "n_hiddens": 16,
                        "n_res_layers": 1, "downsample": (1, 2, 2),
                        "sequence_length": 2, "resolution": 8},
          "losses": {"loss_dict": {"l_dummy": 1.0}},
          "lr_args": {"gen_lr": 4e-4}}
SMALL2 = {
    "vqvae": {"embedding_dim": 8, "n_codes": 16, "n_hiddens": 16,
              "n_res_layers": 1, "downsample": (1, 2, 2),
              "sequence_length": 2, "resolution": 8},
    "generator": {
        "diffusion_model": {"diffusion_step": 8, "guidance_scale": 2.0,
                            "transformer": {"n_layer": 2, "n_embd": 32,
                                            "n_head": 4,
                                            "condition_dim": 32}},
        "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
}
B = 4   # the global batch of every training case: two rows a rank
# __graft_entry__.dryrun_multichip's configuration, on the CPU
DRYRUN = {
    "seed": 0,
    "trainer": {"max_epochs": 1, "mesh": {}, "platform": "cpu"},
    "model": {
        "generator": {
            "textencoder": {"mode": "label", "n_classes": 2, "dim": 32},
            "diffusion_model": {
                "diffusion_step": 4,
                "transformer": {"n_layer": 2, "n_embd": 32, "n_head": 4,
                                "condition_dim": 32,
                                "dalle": {"spatial_size": [8, 4]}}}},
        "autoencoder": {"embedding_dim": 8, "n_codes": 16, "n_hiddens": 16,
                        "n_res_layers": 1, "downsample": [1, 4, 4],
                        "sequence_length": 2, "resolution": 16,
                        "kernel_mode": "xla"},
        "generator_losses": {"loss_dict": {"l_dummy": 1.0}},
        "lr_args": {"gen_lr": 1e-3}},
}
# the codebook alone: 8 global rows for 32 codes, so its candidates are the
# tiled, noised rows and most codes stay unused: both steps restart them
CB_K, CB_D, CB_Z = 32, 8, (2, 1, 2, 2, 8)


def _record_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients as its state, so that the JAX package's own
    train step hands back its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _codebook_inputs(rng):
    z = [rng.standard_normal(CB_Z).astype(np.float32) for _ in range(2)]
    emb = rng.standard_normal((CB_K, CB_D)).astype(np.float32)
    state = {"embeddings": emb, "ema_count": np.zeros(CB_K, np.float32),
             "ema_sum": emb.copy(), "initialized": np.zeros((), np.bool_)}
    return {"state": state, "z": z, "keys": [5, 6]}


def _stage1_inputs(rng):
    model, variables = s1_test._variables(rng, initialised=False)
    video = rng.integers(0, 256, (B, 4, 8, 8, 3)).astype(np.uint8)
    # each rank's two clips are one clip, the ranks' differ: candidate rows
    # drawn from twins coincide, so some codes restart at the init step
    video[1], video[3] = video[0], video[2]
    key = jax.random.key(7)
    init_rows, restart_rows = s1_test._jax_rows(
        model, variables, jax_preprocess_clip(
            jnp.asarray(video), s1_test.KW["resolution"]), key)
    return {"model": model, "variables": variables, "video": video,
            "key": key, "draws": [{"init_rows": init_rows,
                                   "restart_rows": restart_rows}]}


def _stage2_inputs(rng):
    labels = np.array([0, 3, 4, 1], np.int32)
    gen, gparams, ae, avars = slice_test._flax_weights(
        rng, jnp.asarray(labels[:3]))
    video = rng.integers(0, 256, (B, 2, 8, 8, 3)).astype(np.uint8)
    # importance sampling on (tests/test_torch_stage2.py)
    hist = np.full((slice_test.T,), 1e-4, np.float32)
    hist[[1, 5]] = 50.0
    count = np.full((slice_test.T,), 11.0, np.float32)
    buffers = {"diffusion": {
        "lt_history": hist, "lt_count": count,
        "diffusion_acc": np.zeros(slice_test.T, np.float32),
        "diffusion_keep": np.zeros(slice_test.T, np.float32)}}
    # the key JAX's loss draws from (pinned in the JAX step below): t and
    # pt, then the q-sample uniforms, for the global batch
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    t, pt = jd3pm.sample_time(t_rng, lt, B, slice_test.T)
    noise = jax.random.uniform(
        q_rng, (B, slice_test.K, int(np.prod(slice_test.LATENT))),
        jnp.float32)
    return {"gen": gen, "gparams": gparams, "ae": ae, "avars": avars,
            "buffers": buffers, "labels": labels, "video": video,
            "key": key, "draws": [{k: torch.from_numpy(np.array(v))
                                   for k, v in (("t", t), ("pt", pt),
                                                ("noise", noise))}]}


def _port_weights(inp):
    a = inp["avars"]
    return {"generator": flax_to_state_dict(inp["gparams"],
                                            buffers=inp["buffers"]),
            "vqvae": vqvae_state_dict(a["params"], a["batch_stats"],
                                      a["codebook"])}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    cb, s1, s2 = (_codebook_inputs(rng), _stage1_inputs(rng),
                  _stage2_inputs(rng))
    jmesh = jax_mesh(data=2, model=1, devices=jax.devices()[:2])
    # the codebook's candidate rows, as the JAX module draws them at each
    # step from the global rows (its state before the step is JAX's own)
    flax_cb = JaxCodebook(CB_K, CB_D, kernel_mode="xla")
    state, cb["draws"], cb["want"] = cb["state"], [], []
    for z, key in zip(cb["z"], cb["keys"]):
        key = jax.random.key(key)
        k_init, k_rand = cb_test._jax_rows(flax_cb, state, z, key)
        cb["draws"].append({"init_rows": torch.from_numpy(np.array(k_init)),
                            "restart_rows": torch.from_numpy(
                                np.array(k_rand))})
        want, mutated = jax.jit(lambda st, z, key: flax_cb.apply(
            {"codebook": st}, z, train=True, rngs={"codebook": key},
            mutable=["codebook"]))(state, jax_shard_batch(z, jmesh), key)
        state = jax.device_get(mutated["codebook"])
        cb["want"].append((jax.device_get(want), state))
    v = s1["variables"]
    s2_weights = _port_weights(s2)
    spec = {"device": "cpu", "cases": {
        # seeded weights and draws of the port's own
        "codebook_stats": {"n": 96, "k": 24, "d": 8, "seed": 5},
        # 8 global rows for 32 codes: the tiled, noised candidates; most
        # codes stay unused, so both steps restart them
        "codebook": {"k": 32, "d": 8, "b": 2, "grid": (1, 2, 2),
                     "steps": 2},
        "stage1": {"config": STAGE1, "b": 4, "steps": 2},
        "stage2": {"config": SMALL2, "b": 4, "steps": 2},
        "sampling": {"config": SMALL2, "b": 4, "sampler": "model"},
        "dryrun": {"cfg": DRYRUN, "b": 4},
        # the JAX package's weights and draws, its first step held to it
        "codebook_jax": {"kind": "codebook", "k": CB_K, "d": CB_D,
                         "b": CB_Z[0], "given": {
                             "state": {n: torch.from_numpy(np.array(a))
                                       for n, a in cb["state"].items()},
                             "z": [torch.from_numpy(z) for z in cb["z"]],
                             "draws": cb["draws"]}},
        "stage1_jax": {"kind": "stage1", "config": s1_test.CONFIG, "b": B,
                       "steps": 1, "given": {
                           "vqvae": vqvae_state_dict(
                               v["params"], v["batch_stats"],
                               v["codebook"]),
                           "video": s1["video"], "draws": s1["draws"]}},
        "stage2_jax": {"kind": "stage2", "config": slice_test.CONFIG,
                       "b": B, "steps": 1, "given": {
                           **s2_weights, "draws": s2["draws"], "batch": {
                               "video": s2["video"],
                               "label": s2["labels"]}}},
        "sampling_jax": {"kind": "sampling", "config": slice_test.CONFIG,
                         "b": B, "sampler": "megakernel",
                         "given": {**s2_weights, "labels": s2["labels"]}},
    }}
    return {"codebook": cb, "stage1": s1, "stage2": s2, "spec": spec,
            "mesh": jmesh}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    spec = inputs["spec"]
    rank0 = run_ranks(ddp_parity.run_cases, 2, "cpu", spec, str(out))
    rank1 = torch.load(out / "rank1.pt", weights_only=False)
    assert not is_distributed()
    return rank0, rank1, ddp_parity.one_rank(spec)


def _case(runs, name):
    rank0, rank1, one = runs
    report = ddp_parity.compare({name: rank0[name]}, {name: one[name]})
    # the replicas hold the same results (rank 1 against rank 0)
    ddp_parity.compare({name: rank1[name]}, {name: rank0[name]})
    return rank0[name], one[name], report.get(name, {})


def _jax_stage2_state(inp, tx):
    a = inp["avars"]
    return jax_stage2.Stage2State(
        step=jnp.zeros((), jnp.int32), gen_params=inp["gparams"],
        diffusion=inp["buffers"], ae_params=a["params"],
        ae_batch_stats=a["batch_stats"], ae_codebook=a["codebook"],
        opt_state=tx.init(inp["gparams"]))


def _hold_grads(got, want_tree, tol, floor_share):
    """Every gradient within ``tol`` of its tensor's max-abs, that scale
    floored at ``floor_share`` of the largest gradient (the one-process
    parity tests' rule: a gradient that is zero analytically comes back as
    rounding noise)."""
    want = flax_to_state_dict(jax.device_get(want_tree))
    assert set(want) == set(got)
    floor = floor_share * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        scale = max(float(w.abs().max()), floor)
        torch.testing.assert_close(got[name], w, rtol=0, atol=tol * scale,
                                   msg=name)


def test_nearest_code_stats_sharded_over_two_ranks(inputs, runs):
    got, one, report = _case(runs, "codebook_stats")
    assert report["indices"] == report["n_total"] == "equal"
    # JAX's sharded lookup on its CPU mesh, held the same way, and the port
    # against it on the same rows
    c = inputs["spec"]["cases"]["codebook_stats"]
    g = torch.Generator().manual_seed(c["seed"])
    x = torch.randn((c["n"], c["d"]), generator=g).numpy()
    e = torch.randn((c["k"], c["d"]), generator=g).numpy()
    m = jax_mesh(data=2, model=1, devices=jax.devices()[:2])
    jidx, jn, jsum = jax_stats_sharded(jax_shard_batch(jnp.asarray(x), m),
                                       jnp.asarray(e), m)
    ridx, rn, rsum = jax_stats(jnp.asarray(x), jnp.asarray(e))
    np.testing.assert_array_equal(np.asarray(jidx), np.asarray(ridx))
    np.testing.assert_array_equal(np.asarray(jn), np.asarray(rn))
    np.testing.assert_allclose(np.asarray(jsum), np.asarray(rsum),
                               rtol=ddp_parity.EMA_RTOL, atol=1e-6)
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(got["n_total"].numpy(), np.asarray(jn))
    np.testing.assert_allclose(got["encode_sum"].numpy(), np.asarray(jsum),
                               rtol=ddp_parity.EMA_RTOL, atol=1e-6)


def test_codebook_over_two_ranks_at_init_and_restart(runs):
    got, one, _ = _case(runs, "codebook")
    first, second = got["steps"]
    assert bool(first["initialized"]) and bool(second["initialized"])
    # unused codes (count under 1 after the EMA) were restarted at both steps
    for step in (first, second):
        assert int((step["ema_count"] < 1.0).sum()) > 0
    assert not torch.equal(first["embeddings"], second["embeddings"])


def test_codebook_over_two_ranks_matches_jax_on_the_global_rows(inputs,
                                                                runs):
    """Both steps (the init, then restarts) against the JAX ``Codebook`` on
    the global array sharded over its mesh, with the rows it drew."""
    got = _case(runs, "codebook_jax")[0]["steps"]
    for i, (step, (want, state)) in enumerate(zip(
            got, inputs["codebook"]["want"])):
        np.testing.assert_array_equal(step["encodings"].numpy(),
                                      np.asarray(want["encodings"]))
        np.testing.assert_allclose(step["perplexity"],
                                   float(want["perplexity"]),
                                   rtol=cb_test.TOL)
        restarted = state["ema_count"] < 1.0
        assert 0 < restarted.sum() < CB_K, i
        for name in ("embeddings", "ema_count", "ema_sum"):
            np.testing.assert_allclose(
                step[name].numpy(), np.asarray(state[name]),
                rtol=cb_test.STATE_TOL, atol=cb_test.STATE_TOL,
                err_msg=f"step {i} {name}")
        assert bool(step["initialized"]) == bool(state["initialized"])


def test_stage1_steps_over_two_ranks_equal_one(runs):
    got, one, report = _case(runs, "stage1")
    assert float(report["gradients"].split()[0]) <= ddp_parity.GRAD_TOL
    assert "BatchNorm running statistics" in report
    # the running statistics moved from their init (mean 0, var 1)
    bufs = got["steps"][-1]["buffers"]
    assert float(bufs["encoder.bn_out.running_mean"].abs().max()) > 0


def test_stage1_step_over_two_ranks_matches_jax_train_step(inputs, runs):
    """The first step (the codebook's init and restarts in it) against the
    JAX package's ``train/stage1.py: _train_step`` jitted with the batch
    sharded over its ``data=2`` mesh: the losses, every gradient, the
    BatchNorm running statistics and the codebook's buffers."""
    inp = inputs["stage1"]
    v = inp["variables"]
    tx = _record_grads()
    jstate = jax_replicate(jax_stage1.VQVAEState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], codebook=v["codebook"],
        opt_state=tx.init(v["params"])), inputs["mesh"])
    new, want = jax.jit(functools.partial(
        jax_stage1._train_step, model=inp["model"], tx=tx,
        loss_dict=s1_test.CONFIG["losses"]["loss_dict"],
        resolution=s1_test.KW["resolution"]))(
        jstate, jax_shard_batch({"video": inp["video"]}, inputs["mesh"]),
        inp["key"])
    step = _case(runs, "stage1_jax")[0]["steps"][0]
    assert set(step["values"]) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(step["values"][name], float(w),
                                   rtol=s1_test.LOSS_RTOL, err_msg=name)
    # JAX's parameters stayed as they were: its state holds the gradients
    _hold_grads(step["grads"], new.opt_state, s1_test.GRAD_TOL, 1e-2)
    after = vqvae_state_dict(*(jax.device_get(t) for t in (
        new.params, new.batch_stats, new.codebook)))
    assert 0 < int((after["codebook.ema_count"] < 1.0).sum())
    for name, got in step["buffers"].items():
        if got.dtype == torch.bool:
            assert bool(got) == bool(after[name]), name
        else:
            torch.testing.assert_close(got, after[name],
                                       rtol=s1_test.STATE_TOL,
                                       atol=s1_test.STATE_TOL, msg=name)


def test_stage2_steps_over_two_ranks_equal_one(runs):
    got, one, report = _case(runs, "stage2")
    assert float(report["gradients"].split()[0]) <= ddp_parity.GRAD_TOL
    # the Lt counts hold the global batch's draws: B = 4 a step
    assert float(got["steps"][-1]["buffers"]["lt_count"].sum()) == 8.0
    assert math.isfinite(got["steps"][-1]["values"]["total"])


def test_stage2_step_over_two_ranks_matches_jax_train_step(inputs, runs):
    """The first step against the JAX package's ``train/stage2.py:
    _train_step`` jitted with the batch sharded over its ``data=2`` mesh,
    its loss's key pinned to the one the ranks' draws came from: the loss,
    every gradient, the Lt buffers and the telemetry."""
    inp = inputs["stage2"]
    tx = _record_grads()
    jstate = jax_replicate(_jax_stage2_state(inp, tx), inputs["mesh"])
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
    _hold_grads(step["grads"], new.opt_state, s2_test.GRAD_TOL, 1e-4)
    for name in ("lt_history", "lt_count", "diffusion_acc",
                 "diffusion_keep"):
        np.testing.assert_allclose(
            step["buffers"][name].numpy(),
            np.asarray(new.diffusion["diffusion"][name]),
            rtol=s2_test.BUF_TOL, atol=s2_test.BUF_TOL, err_msg=name)


class _Tokens:
    """A stand-in for the VQ-VAE whose decode returns the token grid, so
    that the JAX sampling step hands back its tokens."""

    def apply(self, variables, tokens, method=None):
        return tokens


def test_sharded_argmax_sampling_equals_one_rank(runs):
    got, one, report = _case(runs, "sampling")
    assert report["tokens"] == "equal"
    assert tuple(got["tokens"].shape) == (4, 2, 4, 4)


def test_sharded_argmax_sampling_matches_jax_sharded_megakernel(inputs,
                                                                runs):
    """The tokens gathered from the two ranks, each sampling its half on
    its own stream, against the JAX package's sampling step on its ``data=2``
    mesh (the megakernel under ``shard_map``, each shard on its folded key,
    in interpret mode, argmax), bit for bit."""
    inp = inputs["stage2"]
    jstate = _jax_stage2_state(inp, optax.adam(1e-3))
    want = jax.jit(functools.partial(
        jax_stage2._sample_step, autoencoder=_Tokens(), generator=inp["gen"],
        resolution=8, latent_shape=slice_test.LATENT, sampler="megakernel",
        mesh=inputs["mesh"], interpret=True, sample_mode=False))(
        jstate, {"video": inp["video"], "label": jnp.asarray(inp["labels"])},
        jax.random.key(0))
    got, _, report = _case(runs, "sampling_jax")
    assert report["tokens"] == "equal"
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))


def test_stage2_dryrun_over_two_ranks(runs):
    rank0, rank1, _ = runs
    for r in (rank0, rank1):
        d = r["dryrun"]
        assert d["rows"] == 2              # each rank's half of B=4
        assert all(math.isfinite(v) for v in d["values"].values())
        assert d["weights_spread"] == 0.0  # the same weights on both ranks
    assert rank0["dryrun"]["values"] == rank1["dryrun"]["values"]


def test_mesh_refusals():
    """No fallback: a batch that does not divide, a mesh.data other than
    the ranks there are, and more ranks than devices raise; mesh.model > 1
    (tensor parallelism, ROADMAP item [16b]) gives a (1, 2) mesh and two
    ranks."""
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_rows(5, mesh.Mesh(data=2, index=0))
    m = mesh.create_mesh(None, 2)
    assert (m.data, m.model) == (1, 2)
    with pytest.raises(ValueError, match="rank"):
        mesh.create_mesh(2)
    assert mesh_ranks({"mesh": {"model": 2}}, "cpu") == 2
    with pytest.raises(ValueError, match="device"):
        mesh_ranks({"host_device_count": 2,
                    "mesh": {"data": 2, "model": 2}}, "cpu")
    with pytest.raises(ValueError, match="host_device_count"):
        mesh_ranks({"host_device_count": 2}, "cuda")
    assert mesh_ranks({"host_device_count": 3, "mesh": {"data": None}},
                      "cpu") == 3
    assert mesh_ranks({"mesh": {"data": None}}, "cpu") == 1
    b = {"video": np.arange(8).reshape(4, 2), "text": list("abcd"),
         "step": np.array(3)}
    got = mesh.shard_batch(b, mesh.Mesh(data=2, index=1))
    assert got["video"].tolist() == [[4, 5], [6, 7]]
    assert got["text"] == ["c", "d"] and int(got["step"]) == 3


TASK = [
    "datamodule=synthetic", "batch_size=4", "datamodule.resolution=16",
    "datamodule.sequence_length=2", "datamodule.num_train=8",
    "datamodule.num_val=4", "datamodule.num_test=4",
    "model.generator.n_codes=16", "model.generator.n_hiddens=16",
    "model.generator.n_res_layers=1", "model.generator.downsample=[1,4,4]",
    "model.generator.embedding_dim=8", "model.do_evaluation=false",
    "seed=0", "trainer.platform=cpu", "trainer.host_device_count=2",
    "logger=csv", "extras.print_config=false", "trainer.max_epochs=1",
]


def test_tasks_train_over_two_cpu_ranks_writes_once_and_resumes(tmp_path):
    """``tasks.train`` with ``host_device_count=2`` starts two gloo ranks:
    one run directory, one CSV and one checkpoint directory written by rank
    0, and a second run resumes from that checkpoint on both ranks."""
    out1, out2 = tmp_path / "a", tmp_path / "b"
    m1 = tasks.train(compose("train", TASK + [f"paths.output_dir={out1}"]))
    assert not is_distributed()
    assert {"total/train", "total/val"} <= set(m1)
    (run,) = [p for p in out1.iterdir() if p.is_dir()]
    assert (run / "config_tree.log").exists()
    assert (run / "metrics.csv").read_text().count("\n") >= 2
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["2"]
    assert not list(run.glob("exception*.log"))
    m2 = tasks.train(compose("train", TASK + [
        f"paths.output_dir={out2}", "trainer.max_epochs=2",
        f"ckpt_path={run / 'checkpoints'}"]))
    (run2,) = [p for p in out2.iterdir() if p.is_dir()]
    assert sorted(p.name for p in (run2 / "checkpoints").iterdir()) == ["4"]
    assert math.isfinite(m2["total/train"])


STAGE2_TASK = [
    "model=discrete_diffusion", "datamodule=synthetic", "batch_size=4",
    "datamodule.resolution=16", "datamodule.sequence_length=2",
    "datamodule.num_train=8", "datamodule.num_val=4", "datamodule.num_test=4",
    "model.autoencoder.embedding_dim=8", "model.autoencoder.n_codes=16",
    "model.autoencoder.n_hiddens=16", "model.autoencoder.n_res_layers=1",
    "model.autoencoder.downsample=[1,4,4]",
    "model.generator.diffusion_model.diffusion_step=4",
    "model.generator.diffusion_model.transformer.n_layer=1",
    "model.generator.diffusion_model.transformer.n_embd=16",
    "model.generator.diffusion_model.transformer.n_head=4",
    "model.generator.diffusion_model.transformer.condition_dim=32",
    "model.generator.diffusion_model.transformer.dalle.spatial_size=[8,4]",
    "model/textencoder=label", "model.generator.textencoder.dim=32",
    "model.generator.textencoder.n_classes=2", "seed=0",
    "trainer.platform=cpu", "trainer.host_device_count=2", "logger=csv",
    "extras.print_config=false", "trainer.max_epochs=1",
]


def test_stage2_fvd_renders_and_generate_over_two_cpu_ranks(tmp_path,
                                                            capfd):
    """Stage 2 over two ranks with FVD (sampling split over the ranks, the
    clips gathered, the distance on rank 0 and returned by both) and the
    three renders, then the generate entry over two ranks: each samples two
    of the four clips, rank 0 writes all four."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import generate
    m = tasks.train(compose("train", STAGE2_TASK + [
        "model.do_evaluation=true", f"paths.output_dir={tmp_path / 's2'}"]))
    assert math.isfinite(m["Metrics/fvd-val"])
    (run,) = [p for p in (tmp_path / "s2").iterdir() if p.is_dir()]
    assert sorted(p.name for p in (run / "checkpoints_fvd").iterdir()) == [
        "2"]
    assert generate.main(STAGE2_TASK + [
        "model.do_evaluation=false", f"ckpt_path={run / 'checkpoints'}",
        "+num_samples=4", f"+out_dir={tmp_path / 'gen'}"]) == 0
    # printed by rank 0's process, once
    assert capfd.readouterr().out.count("generated 4 clips") == 1
