"""The port stands alone: it imports neither ``jax`` nor anything of the JAX
package ``repro`` nor ``networkx`` (which the card's machine lacks), and its
entry points never fall back from CUDA to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return [".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in sorted(PORT.rglob("*.py"))]


def test_every_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['networkx'] = None\n"
            f"for m in {_module_names()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "networkx"), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {n}"


def test_cuda_request_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("llama3_2_1b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)                      # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg, device="cuda")
    api = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(api, api.init(0), device="cuda")


def test_kernel_wrapper_never_runs_plain_version_on_a_cuda_tensor():
    """The CPU path is chosen by the tensor's device alone; a tensor on a
    device that is neither the CPU nor CUDA is refused."""
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
