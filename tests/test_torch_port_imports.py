"""The port (dvc_tpu_torch) and chip_smoke.py import neither jax/flax nor
anything of dvc_tpu: checked at run time in a fresh interpreter and at the
source level over every file."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dvc_tpu_torch"

MODULES = [
    "dvc_tpu_torch", "dvc_tpu_torch.config", "dvc_tpu_torch.utils.wavio",
    "dvc_tpu_torch.utils.device", "dvc_tpu_torch.utils.convert",
    "dvc_tpu_torch.ops.stft", "dvc_tpu_torch.ops.mel", "dvc_tpu_torch.ops.chunk",
    "dvc_tpu_torch.models.layers", "dvc_tpu_torch.models.disentangled_vae",
    "dvc_tpu_torch.models.wavenet", "dvc_tpu_torch.kernels._build",
    "dvc_tpu_torch.kernels.wavenet_step", "dvc_tpu_torch.convert.vocode",
    "dvc_tpu_torch.convert.conversion", "dvc_tpu_torch.train.checkpoint",
    "dvc_tpu_torch.serve", "dvc_tpu_torch.cli.run", "dvc_tpu_torch.tools._common",
    "dvc_tpu_torch.tools.bench_taps", "dvc_tpu_torch.tools.bench_body",
    "dvc_tpu_torch.tools.bench_body2", "dvc_tpu_torch.tools.ablate_body",
]

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dvc_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_is_listed():
    on_disk = {".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in PKG.rglob("*.py")}
    on_disk = {m[: -len(".__init__")] if m.endswith(".__init__") else m for m in on_disk}
    assert on_disk - set(MODULES) <= {
        "dvc_tpu_torch.utils", "dvc_tpu_torch.ops", "dvc_tpu_torch.models",
        "dvc_tpu_torch.kernels", "dvc_tpu_torch.convert", "dvc_tpu_torch.train",
        "dvc_tpu_torch.cli", "dvc_tpu_torch.tools"}


def test_import_pulls_in_no_jax_subprocess():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import importlib\nfor m in {MODULES!r}: importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        f"bad = [m for m in new if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "bad += [m for m in ('jax', 'flax') if m in sys.modules]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports_of(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_static_scan_of_sources():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = {str(p.relative_to(REPO)): [n for n in _imports_of(p) if _forbidden(n)]
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
