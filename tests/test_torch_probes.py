"""The PyTorch port's probe kernels' plain versions vs the JAX probe
kernels (CPU), and the probes' host-side logic.

``_chain_kernel`` and ``_pair_kernel`` are imported from
``scripts/depth_pack_probe.py`` and run through ``pl.pallas_call(...,
interpret=True)`` on small shapes at ``iters`` <= 4, where sum(x) is far
from zero. ``scripts/compile_cache_probe.py`` keeps its kernel inside a
string (lines 59-61), so ``_p1_kern`` below restates those three lines.
"""
import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from depth_pack_probe import _chain_kernel, _pair_kernel  # noqa: E402

from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    cuda_build, probe_kernels as pk)
from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
    build_cache_probe, depth_pack_probe)

# sum(x): the two f32 sums run in other orders, so a product can land on
# the other side of a bf16 rounding boundary (one ulp = 2^-8 of the
# element): within 2^-8 of the plain sum of |x|
SUM_TOL = 2.0 ** -8
# the checksum against the rule written out in numpy (f64 sums of the same
# exact products), relative to its max-abs
CHECK_TOL = 1e-5


def _p1_kern(a_ref, o_ref):      # scripts/compile_cache_probe.py:59-61
    o_ref[...] = jnp.dot(a_ref[...], a_ref[...],
                         preferred_element_type=jnp.float32) * 2.0


def _operands(m, k, n, seed, ones=False):
    rng = np.random.default_rng(seed)
    x = np.ones((m, k)) if ones else rng.standard_normal((m, k))
    ws = [rng.standard_normal((k, n)) / k for _ in range(2)]
    jx, j1, j2 = (jnp.asarray(a, jnp.bfloat16) for a in (x, *ws))
    tx, t1, t2 = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (jx, j1, j2))
    return (jx, j1, j2), (tx, t1, t2)


def _numpy_chain(x, w, iters):
    """The rule written out: (final x, checksum) with bf16 roundings through
    torch and f64 sums."""
    x = x.double()
    check = np.zeros(w.shape[1] // pk.CHECKSUM_GROUP)
    k = x.shape[1]
    for _ in range(iters):
        s = x @ w.double()
        check += s.reshape(s.shape[0], -1, pk.CHECKSUM_GROUP).sum(
            dim=(0, 2)).numpy()
        x = (s[:, :k].float() * 0.01).to(torch.bfloat16).double()
    return x, check


@pytest.mark.parametrize("n", [16, 64, 256])
def test_probe_matmul_reference_matches_the_jax_kernel(n):
    a = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    want = pl.pallas_call(
        _p1_kern, out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        interpret=True)(jnp.asarray(a))
    got = pk.probe_matmul(torch.from_numpy(a))       # CPU: the plain version
    # f32 sums of n terms in two libraries' orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("m,k,n,iters,ones", [
    (32, 16, 48, 1, False), (32, 16, 48, 4, False), (64, 32, 256, 3, False),
    (256, 64, 512, 2, True), (32, 16, 16, 2, False), (32, 16, 48, 0, False)])
def test_chain_reference_matches_the_jax_kernel(m, k, n, iters, ones):
    (jx, jw, _), (tx, tw, _) = _operands(m, k, n, m + n + iters, ones)
    want = pl.pallas_call(
        functools.partial(_chain_kernel, iters=iters, k=k),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=True)(jx, jw)
    total, check, x_final = pk.chain_matmul(tx, tw, iters, return_x=True)
    assert tuple(total.shape) == (1,) and tuple(check.shape) == (n // 16,)
    l1 = float(x_final.float().abs().sum())
    assert l1 > 0 and float(total) != 0.0
    assert abs(float(total) - float(want[0, 0])) <= SUM_TOL * l1
    want_x, want_check = _numpy_chain(tx, tw, iters)
    assert abs(float(total) - float(want_x.sum())) <= SUM_TOL * l1
    np.testing.assert_allclose(
        check.numpy(), want_check, rtol=0,
        atol=CHECK_TOL * max(np.abs(want_check).max(), 1e-30))
    # without return_x: the same two outputs
    again = pk.chain_reference(tx, tw, iters)
    assert len(again) == 2 and torch.equal(again[0], total)


@pytest.mark.parametrize("m,k,n,iters", [
    (32, 16, 48, 1), (64, 32, 256, 3), (32, 16, 48, 4)])
def test_pair_reference_matches_the_jax_kernel(m, k, n, iters):
    (jx, j1, j2), (tx, t1, t2) = _operands(m, k, n, 7 * m + iters)
    want = pl.pallas_call(
        functools.partial(_pair_kernel, iters=iters, k=k),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=True)(jx, j1, j2)
    total, check, xs = pk.pair_matmul(tx, t1, t2, iters, return_x=True)
    assert tuple(check.shape) == (2, n // 16) and tuple(xs.shape) == (2, m, k)
    l1 = float(xs.float().abs().sum())
    assert l1 > 0
    assert abs(float(total) - float(want[0, 0])) <= SUM_TOL * l1
    # the pair is two chains from the same x
    for c, w in enumerate((t1, t2)):
        t, ch, x = pk.chain_reference(tx, w, iters, return_x=True)
        assert torch.equal(ch, check[c]) and torch.equal(x, xs[c])
    assert float(total) == float(
        pk.chain_reference(tx, t1, iters)[0] + pk.chain_reference(
            tx, t2, iters)[0])


def test_chain_sum_dies_after_a_few_dozen_iterations():
    """Why the kernels are compared at iters <= 4: each iteration scales by
    0.01, so x underflows to 0 in bf16 long before the probe's 2000."""
    _, (tx, tw, _) = _operands(32, 16, 48, 0, ones=True)
    assert float(pk.chain_reference(tx, tw, 4)[0]) != 0.0
    assert float(pk.chain_reference(tx, tw, 60)[0]) == 0.0


def test_probe_inputs_are_the_scripts():
    x, w1, w2 = depth_pack_probe.probe_inputs(256, 64, 128)
    rng = np.random.default_rng(0)        # scripts/depth_pack_probe.py:123-125
    np.testing.assert_array_equal(
        w1, (rng.standard_normal((64, 128)) / 64).astype(np.float32))
    np.testing.assert_array_equal(
        w2, (rng.standard_normal((64, 128)) / 64).astype(np.float32))
    assert x.shape == (256, 64) and (x == 1).all()


def test_depth_probe_row_arithmetic():
    t = {"full": 4e-6, "no_products": 3e-6, "barrier_only": 1e-6}
    row = depth_pack_probe._row(256, 64, 16384, t)
    flops = 2.0 * 256 * 64 * 16384
    assert row["us"] == pytest.approx(4.0)
    assert row["tflops"] == pytest.approx(flops / 4e-6 / 1e12)
    assert row["products_alone_tflops"] == pytest.approx(flops / 1e-6 / 1e12)
    assert row["exchange_share"] == pytest.approx(0.75)
    assert row["barrier_share"] == pytest.approx(0.25)
    pair = depth_pack_probe._row(256, 64, 16384, t, products=2)
    assert pair["tflops"] == pytest.approx(2 * row["tflops"])
    t["no_products"] = 5e-6           # noise: the difference is not resolved
    assert depth_pack_probe._row(256, 64, 16, t)[
        "products_alone_tflops"] is None


def test_probes_need_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        depth_pack_probe.measure()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cache_probe.probe()


_GOOD = dict(ok=True, hung=False, p1_right=True, k1_right=True, p1_sum=1.0,
             k1_token_sum=7, nvcc_build_s=3.1, k1_nvcc_build_s=2.4)


@pytest.mark.parametrize("change_b,reused,word", [
    (dict(nvcc_build_s=0.0, k1_nvcc_build_s=0.0), True, "REUSED"),
    (dict(k1_nvcc_build_s=0.0), False, "rebuilt the probe kernels"),
    (dict(nvcc_build_s=0.0), False, "rebuilt the sampler kernel"),
    (dict(), False, "rebuilt the probe kernels and the sampler kernel"),
    (dict(nvcc_build_s=0.0, k1_nvcc_build_s=0.0, k1_right=False), False,
     "WRONG VALUES"),
    (dict(nvcc_build_s=0.0, k1_nvcc_build_s=0.0, k1_token_sum=8), False,
     "WRONG VALUES"),
    (dict(ok=False, hung=True, tail="Thread 0x..."), False, "HANG: phase B"),
    (dict(ok=False), False, "probe error"),
])
def test_build_cache_verdict(change_b, reused, word):
    got, sentence = build_cache_probe.verdict(_GOOD, dict(_GOOD, **change_b))
    assert got is reused and word in sentence


def test_build_cache_child_reports_a_failure_and_a_hang(monkeypatch):
    """A child that fails comes back with its tail; one that stalls is
    killed at the time limit and comes back as hung."""
    monkeypatch.setattr(build_cache_probe, "_CHILD",
                        "import sys; print('boom'); sys.exit(3)")
    res = build_cache_probe.run_child("b", 60.0, 50)
    assert res["ok"] is False and res["hung"] is False
    assert "boom" in res["tail"]
    monkeypatch.setattr(build_cache_probe, "_CHILD",
                        "import time; time.sleep(60)")
    res = build_cache_probe.run_child("b", 1.0, 50)
    assert res["ok"] is False and res["hung"] is True


def test_build_cache_child_imports_only_the_port():
    src = build_cache_probe._CHILD
    compile(src, "<child>", "exec")
    assert "jax" not in src and "flax" not in src and "triton" not in src
    assert "gif_synthesis_with_discrete_diffusion_tpu_torch.ops" in src
    assert "gif_synthesis_with_discrete_diffusion_tpu." not in src


def test_cuda_build_takes_a_build_directory(tmp_path, monkeypatch):
    """``load(source, build_dir)`` builds into the directory it is given
    (default: the package's ``_build``), once per content and flags."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo fake > "$2"\necho "ptxas info: 0 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(nvcc))
    seen = []
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: seen.append(path) or type(
                            "Lib", (), {})())
    out = tmp_path / "fresh"
    lib = cuda_build.load("probe_kernels.cu", out)
    assert lib.build_seconds > 0 and "registers" in lib.build_log
    assert Path(seen[-1]).parent == out and Path(seen[-1]).exists()
    again = cuda_build.load("probe_kernels.cu", str(out))
    assert again.build_seconds == 0.0 and seen[-1] == seen[-2]


def test_cuda_build_links_a_library_of_several_units(tmp_path, monkeypatch):
    """``load(source, units=...)`` compiles every source as a translation
    unit of its own (``-c``, one nvcc each) and links the objects into one
    library, whose name hashes every source: K5's two units
    (``ops/attention.py: _bwd_library``)."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo fake > "$2"\necho "ptxas info: 0 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(nvcc))
    seen = []
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: seen.append(path) or type(
                            "Lib", (), {})())
    lib = cuda_build.load("fused_mha_bwd.cu", tmp_path,
                          units=("fused_mha_bwd_stream.cu",))
    lines = calls.read_text().splitlines()
    compiles = [x for x in lines if " -c " in x]
    links = [x for x in lines if " -c " not in x]
    assert len(compiles) == 2 and len(links) == 1
    assert all("-shared" not in x for x in compiles) and "-shared" in links[0]
    assert {x.split()[-1].rsplit("/", 1)[-1] for x in compiles} == {
        "fused_mha_bwd.cu", "fused_mha_bwd_stream.cu"}
    objects = [x.split()[x.split().index("-o") + 1] for x in compiles]
    assert all(o in links[0] for o in objects)
    assert not any(Path(o).exists() for o in objects)
    assert lib.build_log.count("registers") == 3
    alone = cuda_build.load("fused_mha_bwd.cu", tmp_path)
    assert Path(seen[-1]).name != Path(seen[-2]).name
    assert alone.build_seconds > 0


def test_wrappers_refuse_what_is_neither_cpu_nor_cuda():
    x = torch.ones((32, 16), dtype=torch.bfloat16, device="meta")
    w = torch.ones((16, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        pk.chain_matmul(x, w, 1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        pk.probe_matmul(torch.ones((4, 4), device="meta"))


def test_exp_probe_needs_a_card():
    """The exponential-throughput probe measures the card and nothing else:
    without one it raises instead of timing the CPU."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        exp_probe)
    assert set(exp_probe.MODES) == {"ex2_f32", "ex2_f16x2", "poly_fma",
                                    "half_sfu_half_poly"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            exp_probe.probe()


def test_sampler_codebook_variants_edit_the_shipped_sources():
    """Each variant of the in-turns probe is a set of text replacements
    whose old text occurs once in its kernel's source, so it still builds
    after the shipped source changes; without a card the probe raises."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        sampler_codebook_variants as scv)
    for name, (kernel, edits) in scv.VARIANTS.items():
        text = (cuda_build.CSRC / scv.SOURCES[kernel][0]).read_text()
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            scv.compare(None, ("k1_blocks3",), rounds=1)


def test_chip_smoke_names_each_kernels_registers(monkeypatch):
    """Phase 1 prints nvcc's registers and spills kernel by kernel, each
    name passed once through the toolkit's demangler (here a stand-in)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    seen = []
    monkeypatch.setattr(chip_smoke, "_demangled", lambda names: (
        seen.append(names) or [n.upper() for n in names]))
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118"
           "sample_step_kernelILi4ELb1ELb1EEEvNS_6ParamsE' for 'sm_90a'\n"
           "    24 bytes stack frame, 24 bytes spill stores, 20 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z19probe_matmul_"
           "kernelPKfPfi' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n")
    names = ["_ZN12_GLOBAL__N_118sample_step_kernelILi4ELb1ELb1EEEvNS_"
             "6ParamsE", "_Z19probe_matmul_kernelPKfPfi"]
    assert chip_smoke._ptxas_by_kernel(log) == [
        f"{names[0].upper()} 64 registers, 24 B spilled",
        f"{names[1].upper()} 40 registers, 0 B spilled"]
    assert seen == [names]


def test_chip_smoke_times_the_parent_only_when_asked(monkeypatch, capsys):
    """Phases 2 and 6 time K1 and K6 against another checkout only under
    ``--parent ROOT``, and print nothing of a parent otherwise."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        sampler_codebook_variants as scv)
    calls = []
    reading = {"card": "a card, 700 W", "ms": {
        "change": [{"K1": 1.0, "K6": 2.0}], "parent": [{"K1": 3.0,
                                                        "K6": 4.0}]}}
    monkeypatch.setattr(scv, "compare", lambda parent, **kw: (
        calls.append(parent) or reading))
    chip_smoke._parent_turns.cache_clear()
    try:
        chip_smoke._print_parent_turns("phase 2", "K1", None)
        chip_smoke._print_parent_turns("phase 6", "K6", None)
        assert calls == [] and capsys.readouterr().out == ""
        chip_smoke._print_parent_turns("phase 2", "K1", "old")
        chip_smoke._print_parent_turns("phase 6", "K6", "old")
    finally:
        chip_smoke._parent_turns.cache_clear()
    out = capsys.readouterr().out.splitlines()
    assert calls == ["old"]
    assert out == [
        "phase 2: K1 in turns with old (a card, 700 W): this checkout "
        "1.0000 ms, old 3.0000 ms",
        "phase 6: K6 in turns with old (a card, 700 W): this checkout "
        "2.0000 ms, old 4.0000 ms"]


# the depth / packing probe's six one-chain shapes and its pair
_PROBE_SHAPES = [(256, 64, 2048, 1), (256, 128, 2048, 1), (256, 256, 2048, 1),
                 (256, 512, 2048, 1), (256, 64, 16384, 1),
                 (256, 128, 32768, 1), (256, 64, 16384, 2)]


@pytest.mark.parametrize("m,k,n,chains", _PROBE_SHAPES)
def test_chain_design_fits_every_probe_shape(m, k, n, chains):
    """Every probe shape has a design whose shared memory fits a block on an
    H100 (132 SMs); every chain at k <= 128 keeps x in every block (the QK
    and packed shapes and the pair at the QK shape among them), the deeper
    chains exchange x through L2."""
    d = pk.chain_design(m, k, n, chains)
    assert 0 < d.smem <= pk.SHARED_BYTES <= 227 * 1024
    assert d.slab % pk.CHECKSUM_GROUP == 0 and d.blocks <= 132
    assert (d.blocks - 1) * d.slab < n <= d.blocks * d.slab
    assert d.design == ("local" if k <= 128 else "exchange")
    assert k % d.kc == 0
    if d.design == "local":
        # each chain's x, head and slab, rows padded by 8 bf16, and partials
        assert d.smem == chains * (
            2 * (m * (k + 8) + k * (k + 8) + k * (d.slab + 8))
            + d.slab // 16 * 256 * 4)
    if (m, k, n, chains) == (256, 64, 16384, 1):             # the QK shape
        assert d == pk.ChainDesign("local", 128, 128, 64, 71680)
    if (m, k, n, chains) == (256, 128, 32768, 1):            # packed
        assert d == pk.ChainDesign("local", 256, 128, 128, 188416)
    if (m, k, n, chains) == (256, 64, 16384, 2):             # the pair
        assert d == pk.ChainDesign("local", 128, 128, 64, 143360)


def test_chain_design_falls_back_and_refuses():
    # the local copy of x and the head does not fit at k = 256 (270 KB)
    assert 2 * (256 * 264 + 256 * 264) > pk.SHARED_BYTES
    assert pk.chain_design(256, 256, 2048).kc == 256
    # a slab wider than fits beside x: x staged in halves
    d = pk.chain_design(256, 256, 2048, sms=12)
    assert d.design == "exchange" and d.kc < 256 and d.smem <= pk.SHARED_BYTES
    # slabs wider than 256 columns (n above 132 x 256): the exchange
    assert pk.chain_design(256, 64, 65536).design == "exchange"
    for bad in ((48, 64, 2048), (256, 24, 2048), (256, 64, 2040),
                (256, 384, 2048), (256, 128, 64)):
        with pytest.raises(ValueError):
            pk.chain_design(*bad)
    with pytest.raises(ValueError):
        pk.chain_design(256, 64, 2048, chains=3)


@pytest.mark.parametrize("m,k,n", [(256, 128, 32768), (256, 256, 2048),
                                   (256, 512, 2048)])
def test_pair_keeps_the_exchange_where_two_copies_do_not_fit(m, k, n):
    """The pair takes the local design only where both chains' copies fit:
    at the packed shape one copy fits (188 416 B) and two do not; at
    k = 256 and 512 not even one does."""
    one, two = pk.chain_design(m, k, n), pk.chain_design(m, k, n, chains=2)
    assert two.design == "exchange" and two.smem <= pk.SHARED_BYTES
    assert one.design == ("local" if k <= 128 else "exchange")
    if one.design == "local":
        assert one.smem <= pk.SHARED_BYTES - 1024 < 2 * one.smem


def test_chain_design_states_the_sources_constants():
    """``chain_design`` restates ``plan_chain`` of the CUDA source: the
    constants it reads there are the source's."""
    import re
    text = (cuda_build.CSRC / "probe_kernels.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(const["kPad"]) == pk._PAD
    assert int(const["kThreads"]) == pk._THREADS
    assert int(const["kLocalMaxK"]) == pk._LOCAL_MAX_K
    assert int(const["kLocalSubs"]) * int(const["kSub"]) == \
        pk._LOCAL_MAX_SLAB
    assert int(const["kMaxSmem"]) == pk.SHARED_BYTES
    assert int(const["kMaxChunk"]) == pk._MAX_CHUNK
    assert int(const["kGroup"]) == pk.CHECKSUM_GROUP
    assert "slab <= kLocalSubs * kSub &&\n      nc * local <= kLocalSmem" in text
    assert "kLocalSmem = kMaxSmem - kThreads * 4;" in text
    # the local kernel: 8 warps a chain of 32 rows each, and the checksum
    # groups of a slab of at most 256 columns
    assert int(const["kLocalRows"]) * 8 == int(const["kMaxRows"]) == \
        pk._MAX_ROWS
    assert "kLocalGroups = kLocalSubs * kSub / kGroup;" in text


def test_probe_kernel_variants_edit_the_shipped_source():
    """Each variant of the P1 / P2 / P3 in-turns probe is a set of text
    replacements whose old text occurs once in ``csrc/probe_kernels.cu``
    (among them the three designs of two chains in an SM that lost to the
    shipped one, and one chain on the pair's sub-tiles); without a card
    the probe raises."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        probe_kernel_variants as pkv)
    text = (cuda_build.CSRC / pkv.SOURCE).read_text()
    for name, edits in pkv.VARIANTS.items():
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
        assert pkv.variant_text(name, text) != text
    assert set(pkv.CHAINS) >= {"P2"} and pkv.CHAINS["P2"] == (256, 64, 16384)
    assert pkv.PAIR == ("P3", (256, 64, 16384))
    assert {"p3_two_chains_a_warp", "p3_chains_in_turn", "p3_rows64",
            "p3_x_in_registers", "p2_pair_subs"} <= set(pkv.VARIANTS)
    assert pkv.ITERS == depth_pack_probe.ITERS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pkv.compare(None, ("p1_stages2",), rounds=1)


def test_chip_smoke_times_p1_and_p2_against_the_parent(monkeypatch, capsys):
    """Phases 11 and 12 read P1 and P2 in turns with another checkout from
    the probe kernels' own in-turns probe, once for both."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        probe_kernel_variants as pkv)
    calls = []
    reading = {"card": "a card, 700 W", "ms": {
        "change": [{"P1": 0.003, "P2": 4.0, "P3": 7.0}],
        "parent": [{"P1": 0.008, "P2": 15.0, "P3": 24.5}]}}
    monkeypatch.setattr(pkv, "compare", lambda parent, **kw: (
        calls.append(parent) or reading))
    chip_smoke._parent_turns.cache_clear()
    try:
        chip_smoke._print_parent_turns("phase 11", "P1", None)
        assert calls == [] and capsys.readouterr().out == ""
        chip_smoke._print_parent_turns("phase 11", "P1", "old")
        chip_smoke._print_parent_turns("phase 12", "P2", "old")
        chip_smoke._print_parent_turns("phase 12", "P3", "old")
    finally:
        chip_smoke._parent_turns.cache_clear()
    assert calls == ["old"]
    assert capsys.readouterr().out.splitlines() == [
        "phase 11: P1 in turns with old (a card, 700 W): this checkout "
        "0.0030 ms, old 0.0080 ms",
        "phase 12: P2 in turns with old (a card, 700 W): this checkout "
        "4.0000 ms, old 15.0000 ms",
        "phase 12: P3 in turns with old (a card, 700 W): this checkout "
        "7.0000 ms, old 24.5000 ms"]


@pytest.mark.parametrize("stores,ok", [(0, True), (8, False)])
def test_chip_smoke_holds_the_pair_to_no_spill(monkeypatch, stores, ok):
    """Phase 12 reads the ptxas line of the pair's instantiation at the
    probe's depth among the probe kernels' lines (names demangled or not)
    and fails where it spills."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def entry(name, regs, spill):
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, {spill} bytes spill loads\nptxas info    : Used "
                f"{regs} registers, used 1 barriers\n")
    log = (entry("_ZN12_GLOBAL__N_118chain_local_kernelILi64ELi1EEEvNS_11"
                 "LocalParamsE", 200, 0)
           + entry("_ZN12_GLOBAL__N_118chain_local_kernelILi64ELi2EEEvNS_11"
                   "LocalParamsE", 128, stores)
           + entry("_ZN12_GLOBAL__N_118chain_local_kernelILi16ELi2EEEvNS_11"
                   "LocalParamsE", 96, 0))
    monkeypatch.setattr(chip_smoke, "_demangled", lambda names: names)
    monkeypatch.setattr(pk, "_library", lambda *a: SimpleNamespace(
        build_log=log))
    if ok:
        assert chip_smoke._pair_ptxas(64).endswith(
            "chain_local_kernelILi64ELi2EEEvNS_11LocalParamsE 128 registers, "
            "0 B spilled")
    else:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke._pair_ptxas(64)
    assert chip_smoke._chain_kernel_name(
        pk.ChainDesign("local", 128, 128, 64, 143360), 64, 2) == \
        "local: chain_local_kernel<64, 2>"
    assert chip_smoke._chain_kernel_name(
        pk.ChainDesign("exchange", 256, 128, 128, 208896), 128, 2) == \
        "exchange: chain_kernel<2>"
