"""The port's YAML reader and config composition vs PyYAML and the JAX
package's ``compose`` (CPU).

Every YAML file of the config tree reads to exactly what ``yaml.safe_load``
gives, YAML 1.1 quirks included (``1e-4`` is a string, ``5.0e-4`` a
float); ``compose`` equals the JAX package's for every job script's
override line and for the override cases of ``tests/test_configs.py``,
also in a process where ``yaml`` cannot be imported; ``to_yaml`` reads back
to the composed dict through both readers.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from gif_synthesis_with_discrete_diffusion_tpu.utils import config as jcfg
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import config
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import yaml_lite
from tests.test_job_scripts import _JOBS, _TPU_DIR, _overrides

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(jcfg.default_config_root().rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def test_the_tree_has_32_files():
    assert len(CONFIGS) == 32
    assert config.default_config_root() == jcfg.default_config_root()


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[str(p.relative_to(CONFIGS[0].parents[1]))
                              for p in CONFIGS])
def test_reader_equals_pyyaml_on_every_config_file(path):
    text = path.read_text()
    assert _same(yaml_lite.safe_load(text), yaml.safe_load(text))


# scalars and nodes the override values and the files may hold
SCALARS = [
    "1e-4", "5.0e-4", "1.0e5", "1.0e+5", "-1.5e-3", "1.5E+3", "0.", "1.",
    "685.230_15e+03", "190:20:30.15", ".inf", "-.Inf", ".NaN", "-.5", ".5",
    "010", "09", "00", "0x1F", "-0x1A", "0b101", "1_000", "1:30", "0", "-1",
    "+1", "yes", "Off", "ON", "true", "True", "FALSE", "~", "", "null",
    "Null", "2001-12-14", "2001-1-2", "2001-12-14t21:59:43.10-05:00",
    "2001-12-14 21:59:43.10", "2001-12-14T21:59:43Z", "'quoted'",
    "'it''s'", '"a\\tb"', '"\\u00e9\\x41"', "foo bar", "a:b",
    "http://x.y/z", "/path/to/x", "${paths.x}/foo", "1e-5:1e-2:log",
    "a #b", "-", "float32",
]
NODES = [
    "[1, [2, 3], {a: b}]", "{}", "[]", "a: b", "[1,8,8]", "[-1, -2.5]",
    "[a, b: c]", "{a: 1, b: [x, y], c: {d: e}}", "x: [1, 2]\ny: {}",
    "- a\n- b", "a:\n- 1\n- 2", "a:\n  b: 1\n  c:\n    - x: 1\n      y: 2"
    "\n    - z\n", "[1,\n 2]", '"a b" : 1', "key: [1, 2] #c",
    "a: 'x # y'", "a:   ", "- - 1\n  - 2\n- 3",
    "# only a comment\n", "a:\n  - b: 1\n  - {c: 2}\n",
]


@pytest.mark.parametrize("text", SCALARS + NODES)
def test_reader_equals_pyyaml_on_scalars_and_nodes(text):
    assert _same(yaml_lite.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a: b: c", "[1, 2", "a: -", "a: - b"])
def test_reader_raises_where_pyyaml_raises(text):
    """What PyYAML refuses, the reader refuses: an override value then
    stays text on both sides."""
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.safe_load(text)


@pytest.mark.parametrize("text", ["*x", "&a b", "!!str 1", "|\n a",
                                  "--- a"])
def test_reader_refuses_what_it_does_not_read(text):
    """Aliases, anchors, tags, block scalars and documents, which no config
    of the tree uses, raise."""
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.safe_load(text)


# the override cases of tests/test_configs.py and tests/test_eval_task.py
_TINY2 = [
    "model=discrete_diffusion", "datamodule=synthetic", "batch_size=4",
    "datamodule.resolution=16", "datamodule.sequence_length=2",
    "model.autoencoder.embedding_dim=8", "model.autoencoder.n_codes=16",
    "model.autoencoder.n_hiddens=16", "model.autoencoder.n_res_layers=1",
    "model.autoencoder.downsample=[1,4,4]",
    "model.autoencoder.kernel_mode=xla",
    "model.generator.diffusion_model.diffusion_step=4",
    "model.generator.diffusion_model.transformer.n_layer=1",
    "model.generator.diffusion_model.transformer.n_embd=16",
    "model.generator.diffusion_model.transformer.n_head=4",
    "model.generator.diffusion_model.transformer.condition_dim=32",
    "model.generator.diffusion_model.transformer.dalle.spatial_size=[8,4]",
    "model.generator.textencoder.dim=32",
]
CASES = [
    ("train", []), ("eval", []), ("train", ["model=discrete_diffusion"]),
    ("train", ["debug=fdr"]),
    ("train", ["datamodule=synthetic", "batch_size=7",
               "trainer.max_epochs=3"]),
    ("train", ["+custom.flag=true", "~ckpt_path"]),
    ("train", ["model=discrete_diffusion", "model/textencoder=label",
               "model.generator.textencoder.n_classes=3"]),
    ("train", ["model=discrete_diffusion", "model/textencoder=frame"]),
    ("train", _TINY2 + ["model/textencoder=clip_text_embedding",
                        "model.generator.textencoder.mode=text",
                        "+model.generator.textencoder.width=16",
                        "model.generator.textencoder.allow_hash_tokenizer="
                        "true"]),
    ("train", _TINY2 + ["model/textencoder=label"]),
    ("train", _TINY2 + ["model/textencoder=frame"]),
    *[("train", [f"debug={p}", "datamodule=synthetic"])
      for p in ("default", "fdr", "limit", "overfit", "profiler")],
    *[("train", [f"logger={lg}"])
      for lg in ("csv", "tensorboard", "wandb", "mlflow", "neptune",
                 "comet", "many_loggers")],
    ("train", ["experiment=ucf_stage2", "hparams_search=lr_random"]),
    ("eval", ["model=videogpt_vq_vae", "datamodule=synthetic",
              "ckpt_path=/tmp/run/checkpoints", "seed=0"]),
    ("train", ["trainer.platform=cpu", "model.lr_args.gen_lr=1e-5",
               "tags=[a, 'b c']", "+x={a: 1, b: [2, 3]}", "+y=", "+z=null",
               "+w='1e-4'", "+v=a: b: c"]),
]


@pytest.mark.parametrize("name,overrides", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_compose_equals_jax(name, overrides):
    want = jcfg.compose(name, overrides)
    got = config.compose(name, overrides)
    assert _same(got, want)
    for reread in (yaml_lite.safe_load, yaml.safe_load):
        assert _same(reread(config.to_yaml(got)), got)


@pytest.mark.parametrize("job", _JOBS)
def test_compose_equals_jax_on_the_job_scripts(job):
    ovr = _overrides(_TPU_DIR / job)
    got = config.compose("train", ovr)
    assert _same(got, jcfg.compose("train", ovr))
    assert _same(yaml_lite.safe_load(config.to_yaml(got)), got)
    # YAML 1.1, as PyYAML reads it: no dot, no float
    assert got["model"]["lr_args"]["gen_lr"] in ("4e-4", "1e-4")


def test_env_interpolation_equals_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path / "data"))
    got = config.compose("train", ["datamodule=msrvtt"])
    assert _same(got, jcfg.compose("train", ["datamodule=msrvtt"]))
    assert got["paths"]["log_dir"] == f"{tmp_path}/logs"
    # the JAX package's quirk, kept: the ${...} nested in the env default is
    # substituted once and the outer ${env:...} left as text, DATASETS_DIR
    # set or not (ROADMAP queue 3, F9)
    quirk = f"${{env:DATASETS_DIR,{tmp_path}/data}}"
    assert got["paths"]["datasets"] == quirk
    assert got["datamodule"]["data_folder"] == quirk + "/MSRVTT"
    monkeypatch.delenv("DATASETS_DIR")
    got = config.compose("train", [])
    assert _same(got, jcfg.compose("train", []))
    assert got["paths"]["datasets"] == quirk


@pytest.mark.parametrize("overrides", [["nonexistent.key=1"],
                                       ["model=missing_model"], ["noequals"]])
def test_bad_overrides_raise_as_in_jax(overrides):
    with pytest.raises(jcfg.ConfigError):
        jcfg.compose("train", overrides)
    with pytest.raises(config.ConfigError):
        config.compose("train", overrides)


def test_instantiate_and_asdict_equal_jax():
    node = {"_target_": "collections.OrderedDict", "a": 1,
            "b": {"_target_": "fractions.Fraction", "numerator": 3,
                  "denominator": 4}}
    assert config.instantiate(node) == jcfg.instantiate(node)
    assert config.instantiate(node, c=2) == jcfg.instantiate(node, c=2)
    assert config.asdict(config.instantiate(node)) == jcfg.asdict(
        jcfg.instantiate(node))


_NO_YAML = """
import json, sys
sys.modules["yaml"] = None
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import config
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import yaml_lite
cases = json.loads(sys.argv[1])
out = []
for name, ovr in cases:
    cfg = config.compose(name, ovr)
    assert yaml_lite.safe_load(config.to_yaml(cfg)) == cfg
    out.append(cfg)
assert "yaml" not in {m for m, v in sys.modules.items() if v is not None}
print(json.dumps(out))
"""


def test_compose_without_yaml_equals_jax():
    """The card's case: ``yaml`` cannot be imported."""
    cases = [("train", _overrides(_TPU_DIR / job)) for job in _JOBS] + [
        (n, o) for n, o in CASES[:6]]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, "-c", _NO_YAML, json.dumps(cases)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    want = [json.loads(json.dumps(jcfg.compose(n, o))) for n, o in cases]
    assert got == want
