"""The port (dvc_tpu_torch) and chip_smoke.py import neither jax/flax nor
anything of dvc_tpu: checked at run time in a fresh interpreter and at the
source level over every file.  The port's native engines are its own
builds: a process that loads all three maps no shared object of
dvc_tpu/native."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
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
    "dvc_tpu_torch.ops.audio", "dvc_tpu_torch.data.dataset",
    "dvc_tpu_torch.models.layers", "dvc_tpu_torch.models.disentangled_vae",
    "dvc_tpu_torch.models.wavenet", "dvc_tpu_torch.kernels._build",
    "dvc_tpu_torch.kernels.wavenet_step", "dvc_tpu_torch.convert.vocode",
    "dvc_tpu_torch.convert.conversion", "dvc_tpu_torch.convert.griffinlim",
    "dvc_tpu_torch.train.checkpoint", "dvc_tpu_torch.train.losses",
    "dvc_tpu_torch.train.trainer",
    "dvc_tpu_torch.serve", "dvc_tpu_torch.cli.run", "dvc_tpu_torch.tools._common",
    "dvc_tpu_torch.tools.bench_taps", "dvc_tpu_torch.tools.bench_body",
    "dvc_tpu_torch.tools.bench_body2", "dvc_tpu_torch.tools.ablate_body",
    "dvc_tpu_torch.tools.bench_sync",
    "dvc_tpu_torch.utils.msgpack", "dvc_tpu_torch.native", "dvc_tpu_torch.native._build",
    "dvc_tpu_torch.native.flac", "dvc_tpu_torch.native.world",
    "dvc_tpu_torch.data.preprocess", "dvc_tpu_torch.ops.world", "dvc_tpu_torch.eval",
    "dvc_tpu_torch.eval.mcd", "dvc_tpu_torch.models.istft_vocoder",
    "dvc_tpu_torch.train.vocoder_trainer", "dvc_tpu_torch.train.istft_vocoder_trainer",
    "dvc_tpu_torch.utils.plotting", "dvc_tpu_torch.models.feature_selection",
    "dvc_tpu_torch.train.feature_selection_trainer", "dvc_tpu_torch.train.adversarial",
    "dvc_tpu_torch.models.long_context", "dvc_tpu_torch.eval.eer",
    "dvc_tpu_torch.data.speaker_dataset", "dvc_tpu_torch.models.speaker_encoder",
    "dvc_tpu_torch.train.speaker_trainer", "dvc_tpu_torch.models.speaker_inference",
    "dvc_tpu_torch.utils.visualizations", "dvc_tpu_torch.models.autovc",
    "dvc_tpu_torch.train.autovc_trainer", "dvc_tpu_torch.ops.harvest",
    "dvc_tpu_torch.data.world_preprocess", "dvc_tpu_torch.convert.world_conversion",
    "dvc_tpu_torch.parallel", "dvc_tpu_torch.parallel.mesh", "dvc_tpu_torch.parallel.multihost",
    "dvc_tpu_torch.parallel.sequence", "dvc_tpu_torch.parallel.collectives",
    "dvc_tpu_torch.parallel.tensor", "dvc_tpu_torch.native.zstd", "dvc_tpu_torch.utils.ocdbt",
    "dvc_tpu_torch.utils.orbax", "dvc_tpu_torch.ops.d4c", "dvc_tpu_torch.ops.pitch",
    "dvc_tpu_torch.ops.group", "dvc_tpu_torch.utils.profiling", "dvc_tpu_torch.eval.parity",
]

FORBIDDEN_SO = os.sep + os.path.join("dvc_tpu", "native") + os.sep

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dvc_tpu", "tensorstore", "zstandard")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_is_listed():
    on_disk = {".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in PKG.rglob("*.py")}
    on_disk = {m[: -len(".__init__")] if m.endswith(".__init__") else m for m in on_disk}
    assert on_disk - set(MODULES) <= {
        "dvc_tpu_torch.utils", "dvc_tpu_torch.ops", "dvc_tpu_torch.models",
        "dvc_tpu_torch.kernels", "dvc_tpu_torch.convert", "dvc_tpu_torch.train",
        "dvc_tpu_torch.cli", "dvc_tpu_torch.tools", "dvc_tpu_torch.data"}
    assert set(MODULES) <= on_disk | {"dvc_tpu_torch"}


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
    # the rank bodies of the parallel tests run in processes of their own
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tests" / "torch_parallel_ranks.py"]
    bad = {str(p.relative_to(REPO)): [n for n in _imports_of(p) if _forbidden(n)]
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_native_engines_are_the_ports_own():
    """Load the DSP, FLAC and WORLD engines through the port and read the
    process's memory map: each library comes from build/native/, built from
    dvc_tpu_torch/native, and no file under dvc_tpu/native is mapped."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dvc_tpu_torch import native\n"
        "from dvc_tpu_torch.native import _build, flac, world\n"
        "native.dtw_path(np.zeros((2, 2)))\n"
        "world.harvest(np.zeros(1600, np.float32), 16000)\n"
        "_build.load('dvc_flac', flac._declare)\n"
        "maps = [ln.split()[-1] for ln in open('/proc/self/maps') if '.so' in ln]\n"
        f"bad = [m for m in maps if {FORBIDDEN_SO!r} in m]\n"
        "ours = sorted({m for m in maps if 'libdvc_' in m})\n"
        "print('BAD', bad, 'OURS', ours)\n"
        "ok = not bad and len(ours) == 3 and all(str(_build.BUILD_DIR) in m for m in ours)\n"
        "sys.exit(0 if ok else 1)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
