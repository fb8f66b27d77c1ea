"""Boundaries of the PyTorch port: it never imports JAX or the reference
package, and its entry points run on the GPU unless asked for the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _require_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")


def test_entry_points_default_to_cuda_and_raise_without_a_gpu():
    _require_cpu_only_host()
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine

    cfg = configs.get_config("phi3-medium-14b").reduced(compute_dtype="float32")
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_paged_cache(cfg, 2, 16, 4, 8)
    Engine(cfg, params, max_len=16, device="cpu")


def test_serve_cli_defaults_to_cuda():
    _require_cpu_only_host()
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--n-requests", "1", "--continuous",
                    "--paged", "--chunked-prefill"])
