"""The PyTorch port as a package: every module of it imports without jax,
flax, optax, orbax or the JAX package (and without yaml, cv2, imageio and
tensorboard, which it imports only where it reads a config file, decodes a
video, writes a GIF or logs to TensorBoard), and its chip smoke script
refuses to run without a CUDA device."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "gif_synthesis_with_discrete_diffusion_tpu_torch"

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for blocked in sys.argv[1:]:
    sys.modules[blocked] = None
import {PKG} as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k, v in sys.modules.items() if v is not None
                and k.split(".")[0] in (
    "jax", "flax", "optax", "orbax", "gif_synthesis_with_discrete_diffusion_tpu"))
missing = sorted({{pkg.__name__ + m for m in (
    ".train.stage1", ".data.synthetic", ".ops.probe_kernels",
    ".probes.depth_pack_probe", ".probes.build_cache_probe",
    ".utils.config", ".utils.yaml_lite", ".utils.logging",
    ".utils.checkpoint", ".utils.renderer", ".data.video_dataset",
    ".data.prefetch", ".parallel.distributed", ".train.loop", ".tasks",
    ".train.stage2", ".eval.evaluator", ".generate", ".parallel.mesh",
    ".sweep", ".probes.ddp_parity")}} - set(names))
print(len(names), leaked, missing)
sys.exit(1 if leaked or missing or len(names) < 20 else 0)
"""


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    return env


def test_port_imports_without_jax_or_flax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_without_yaml_cv2_imageio_orbax_or_tensorboard():
    """As where none of these packages is installed."""
    blocked = ["yaml", "cv2", "imageio", "orbax", "tensorboard", "jax",
               "flax", "optax"]
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, *blocked],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_port_carries_no_triton_kernel():
    """Every kernel of the port is CUDA C++ under ``csrc/``, built by nvcc:
    no module of the package, and not chip_smoke.py, imports Triton."""
    sources = [*(ROOT / PKG).rglob("*.py"), ROOT / "chip_smoke.py"]
    found = [str(p.relative_to(ROOT)) for p in sources
             if "import triton" in p.read_text()
             or "from triton" in p.read_text()]
    assert not found, found
