"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, nothing is built at import, and the entry
points run on the card unless the caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "from repro_torch.kernels import _cuda\n"
        "assert not bad, bad\n"
        "assert not _cuda._LIBS, 'a kernel was built at import'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_static_imports_name_no_jax(path):
    p = ROOT / path
    files = [p] if p.is_file() else sorted(p.rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, (f, bad)


def test_entry_points_default_to_the_card():
    cfg = get_config("granite-3-8b", smoke=True)
    from repro_torch.models.lm import Model
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.resolve_device(None)
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
          "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "on cpu" in out and out.count(": ok") == 2
