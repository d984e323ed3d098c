"""The PyTorch port stands alone: every ``repro_torch.*`` module imports
with ``jax`` and ``repro`` made unimportable, and no source file of the
port imports either (modelled on ``tests/test_imports.py``)."""
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PORT = pathlib.Path(SRC) / "repro_torch"
#: the scripts that drive the port on the card
CHIP_SCRIPTS = [PORT.parents[1] / "chip_smoke.py", PORT.parents[1] / "chip_profile.py"]


def iter_port_modules():
    sys.path.insert(0, SRC)
    try:
        import repro_torch

        names = ["repro_torch"]
        for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch."):
            names.append(m.name)
        return sorted(names)
    finally:
        sys.path.remove(SRC)


def test_every_port_module_imports_without_jax_or_repro():
    names = iter_port_modules()
    for expected in ("repro_torch.kernels.ops", "repro_torch.kernels.flash_attention",
                     "repro_torch.kernels.rmsnorm", "repro_torch.kernels.masked_accum",
                     "repro_torch.models.convert", "repro_torch.serve.scheduler",
                     "repro_torch.configs.qwen2_5_3b", "repro_torch.core.dropcompute",
                     "repro_torch.core.engine", "repro_torch.core.threshold",
                     "repro_torch.data.synthetic", "repro_torch.optim.optimizers",
                     "repro_torch.train.trainer", "repro_torch.train.resilience.controller",
                     "repro_torch.launch.train"):
        assert expected in names, names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        + "".join(f"importlib.import_module({n!r})\n" for n in names)
        + f"print('OK', {len(names)})"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"OK {len(names)}" in out.stdout


@pytest.mark.parametrize("pattern", [r"^\s*import\s+jax\b", r"^\s*from\s+jax\b",
                                     r"^\s*from\s+repro\b", r"^\s*import\s+repro\b"])
def test_no_port_source_imports_jax_or_repro(pattern):
    rx = re.compile(pattern, re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + CHIP_SCRIPTS
    assert all(f.exists() for f in files)
    hits = [str(f) for f in files if rx.search(f.read_text())]
    assert not hits, hits


def test_kernel_modules_import_triton_lazily():
    """Importing the kernel modules must not need triton or nvcc (the CPU
    test machines have neither): both are reached only on first launch."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.masked_accum\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "print('LAZY')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LAZY" in out.stdout
