"""The port stands alone: no JAX, no reference package, no CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = SRC.parent / "examples"
PORT_EXAMPLES = ("quickstart", "multiclass_dcsvm", "svr_dcsvm",
                 "oneclass_dcsvm", "end_to_end_dcsvm", "distributed_dcsvm")

_PROBE = """
import importlib.util
import sys
from pathlib import Path
import numpy as np
from repro_torch.core import DCSVMConfig, Kernel, fit, predict_exact, accuracy
from repro_torch.data import gaussian_mixture
import repro_torch.convert, repro_torch.launch.serve_svm, repro_torch.launch.train_svm
import repro_torch.configs, repro_torch.models.lm, repro_torch.launch.serve
import repro_torch.launch.engine, repro_torch.launch.registry
import repro_torch.baselines, repro_torch.ckpt
from repro_torch.launch import serve
for path in sorted(Path(sys.argv[1]).glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
X, y = gaussian_mixture(np.random.default_rng(0), 200, d=4, modes_per_class=2)
cfg = DCSVMConfig(kernel=Kernel("rbf", gamma=4.0), C=2.0, levels=1, m=50)
model = fit(cfg, X, y, device="cpu")
assert accuracy(y, predict_exact(model, X)) > 0.8
ltpu = repro_torch.baselines.train_ltpu(X, y, Kernel("rbf", gamma=4.0),
                                        num_units=16, device="cpu")
assert accuracy(y, ltpu.predict(X)) > 0.8
lm_cfg = repro_torch.configs.get_config("qwen1.5-0.5b", reduced=True)
params = serve.init_params(lm_cfg, 0, "cpu")
prompts = serve.make_prompts(lm_cfg, 2, 8, 1, "cpu")
tok, logits, cache = serve.prefill(lm_cfg, params, prompts, 12)
assert tok.shape == (2, 1) and logits.shape == (2, 1, lm_cfg.vocab)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
assert not bad, bad
print("ok")
"""


def test_port_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    assert sorted(p.stem for p in EXAMPLES.glob("*_torch.py")) == sorted(
        f"{e}_torch" for e in PORT_EXAMPLES)
    out = subprocess.run([sys.executable, "-c", _PROBE, str(EXAMPLES)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# the reference's ``repro.core`` names under another name in the port, and
# the ones whose module is not ported yet (none: A17 adds no core name)
RENAMED = {"resolve_use_pallas": "resolve_use_kernels"}
LEFT_FOR_A17: frozenset = frozenset()


def test_core_exports_the_reference_names():
    """``repro_torch.core`` exports every name that the reference's
    ``repro/core/__init__.py`` binds (read from its source: importing it
    would import JAX)."""
    import repro_torch.core as core

    tree = ast.parse((SRC / "repro" / "core" / "__init__.py").read_text())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(names) == 75
    missing = {n for n in names if RENAMED.get(n, n) not in core.__all__}
    assert missing == LEFT_FOR_A17, sorted(missing)
    assert all(hasattr(core, n) for n in core.__all__)


def test_no_module_imports_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files += sorted(EXAMPLES.glob("*_torch.py"))
    files.append(SRC.parent / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {name}"


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.core import DCSVMConfig, fit
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        fit(DCSVMConfig(), torch.zeros(8, 2), torch.ones(8))   # default: cuda
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced"])                               # default: cuda


def test_wrapper_on_a_cuda_request_raises_without_a_built_kernel(
        monkeypatch, tmp_path):
    """A request the wrappers treat as CUDA goes to the kernel or raises:
    with no library built (no nvcc here) it raises and counts no launch."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the kernels build there")
    from repro_torch.core.kernels import Kernel
    from repro_torch.kernels import build, ops
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda-toolkit"))
    before = dict(ops.LAUNCHES)
    X = torch.rand(16, 3)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kernel_matrix(X, X, Kernel("rbf"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kernel_matvec(X, X, torch.ones(16), Kernel("rbf"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.cd_column_update(X, torch.ones(16), X[:4], torch.ones(4),
                             Kernel("rbf"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kmeans_assign(X, X[:4], torch.ones(4, 2), torch.ones(2), 1.0)
    q = torch.rand(1, 8, 2, 64)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert ops.LAUNCHES == before
