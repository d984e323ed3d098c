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
#: the scripts that drive the port on the card, and the port's examples
CHIP_SCRIPTS = [PORT.parents[1] / "chip_smoke.py", PORT.parents[1] / "chip_profile.py"]
EXAMPLES = [PORT.parents[1] / "examples" / "serve_http_torch.py",
            PORT.parents[1] / "examples" / "serve_torch.py"]


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
                     "repro_torch.launch.train", "repro_torch.kernels.ssd_chunk",
                     "repro_torch.models.ssm", "repro_torch.models.recurrent",
                     "repro_torch.configs.mamba2_130m", "repro_torch.configs.mamba2_tiny",
                     "repro_torch.core.local_sgd", "repro_torch.train.checkpoint",
                     "repro_torch.dist", "repro_torch.dist.api", "repro_torch.dist.mesh",
                     "repro_torch.dist.procs", "repro_torch.launch.steps",
                     "repro_torch.configs.bert_large", "repro_torch.configs.bert_1_5b",
                     "repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_2b",
                     "repro_torch.configs.hybrid_tiny", "repro_torch.serve.frontend",
                     "repro_torch.configs.internlm2_1_8b", "repro_torch.configs.starcoder2_7b",
                     "repro_torch.configs.gemma3_27b"):
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
    files = sorted(PORT.rglob("*.py")) + CHIP_SCRIPTS + EXAMPLES
    assert all(f.exists() for f in files)
    hits = [str(f) for f in files if rx.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.name)
def test_port_examples_import_without_jax_or_repro(example):
    """The port's examples load (module level: the port's serving stack,
    and for the HTTP example its front-end) with ``jax`` and ``repro`` made
    unimportable."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(example)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "print('OK', mod.ContinuousBatcher.__module__)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK repro_torch.serve.scheduler" in out.stdout


def test_kernel_modules_import_triton_lazily():
    """Importing the kernel modules must not need triton or nvcc (the CPU
    test machines have neither): both are reached only on first launch."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.masked_accum\n"
        "import repro_torch.kernels.ssd_chunk, repro_torch.models.ssm\n"
        "import repro_torch.train, repro_torch.launch.train, repro_torch.dist\n"
        "print('LAZY')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LAZY" in out.stdout
