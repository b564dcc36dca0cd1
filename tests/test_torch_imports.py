"""The port stands alone: importing ``repro_torch`` (every module of it)
pulls in neither JAX nor the ``repro`` package, and its entry points refuse
to fall back to the CPU when asked for a card that is not there."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _port_modules() -> list[str]:
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_imports_neither_jax_nor_repro():
    mods = _port_modules()
    for m in ("serving.core", "launch.serve", "core.ecc", "core.hybrid_gemv",
              "core.hw", "core.tiling", "quant.int4", "quant.int8",
              "kernels.ecc_decode.ops", "kernels.w4a16_gemv.ops",
              "examples.quickstart", "examples.ecc_resilience"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported {out.stdout.strip()}"


def test_chip_smoke_imports_neither_jax_nor_repro():
    import ast

    root = os.path.dirname(SRC)
    tree = ast.parse(open(os.path.join(root, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert "jax" not in top and "repro" not in top, sorted(top)


@pytest.mark.parametrize("entry", ["init_params", "EngineCore",
                                   "ServingClient", "serve", "quickstart",
                                   "ecc_resilience"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M

    cfg = get_arch("llama2-7b").reduced()
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "init_params":
            M.init_params(cfg)
        elif entry == "EngineCore":
            from repro_torch.serving.core import EngineCore
            EngineCore(cfg, params)
        elif entry == "ServingClient":
            from repro_torch.serving.client import ServingClient
            ServingClient(cfg, params)
        elif entry == "serve":
            from repro_torch.launch.serve import main
            main(["--requests", "1"])
        elif entry == "quickstart":
            from repro_torch.examples.quickstart import main
            main(["--reduced", "1"])
        else:
            from repro_torch.examples.ecc_resilience import main
            main([])


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card, and alone in a directory without the repository,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root = os.path.dirname(SRC)
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(root, "chip_smoke.py")).read())
    for cwd, script in ((root, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_unported_options_raise():
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.serving.core import EngineCore, Request
    from repro_torch.serving.router import Router
    from repro_torch.serving.scheduler import SamplingParams, make_scheduler

    cfg = get_arch("smollm-360m").reduced()
    params = M.init_params(cfg, device="cpu")
    for kw in (dict(mode="wave"), dict(kv_tier="flash"),
               dict(prefix_cache=True), dict(overlap=True),
               dict(kv_dtype="int8"),
               dict(scheduler=make_scheduler("fcfs", chunk_tokens=8))):
        with pytest.raises(NotImplementedError):
            EngineCore(cfg, params, device="cpu", **kw)
    eng = EngineCore(cfg, params, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.add_request(Request(rid=0, prompt=[1, 2],
                                sampling=SamplingParams(temperature=0.7)))
    with pytest.raises(NotImplementedError):
        eng.snapshot_slot(0)
    with pytest.raises(NotImplementedError):
        Router([eng], migrate=True)
