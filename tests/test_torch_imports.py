"""The port stands alone: importing ``repro_torch`` (every module of it)
pulls in neither JAX, the ``repro`` package nor ``ml_dtypes`` (the card's
machine has none of them), and its entry points refuse to fall back to the
CPU when asked for a card that is not there."""

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


@pytest.mark.parametrize("sanitize", ["", "1"], ids=["plain", "sanitize"])
def test_port_imports_neither_jax_nor_repro(sanitize):
    """Every module imported (the fleet worker's ``main`` among them);
    with ``REPRO_SANITIZE=1`` an allocator and the wire registry load the
    sanitizer rails, which still bring in no JAX, ``repro`` or
    ``ml_dtypes``."""
    mods = _port_modules()
    for m in ("serving.core", "launch.serve", "core.ecc", "core.hybrid_gemv",
              "core.hw", "core.tiling", "quant.int4", "quant.int8",
              "kernels.ecc_decode.ops", "kernels.w4a16_gemv.ops",
              "examples.quickstart", "examples.ecc_resilience",
              "models.ssm", "kernels.ssd_scan.ops", "kernels.ssd_scan.ref",
              "configs.zamba2_7b", "configs.mamba2_130m", "serving.graphs",
              "serving.threefry", "serving.sampler", "serving.kv_cache",
              "serving.fleet", "serving.fleet.wire", "serving.router",
              "serving.client", "serving.fleet.transport",
              "serving.fleet.worker", "serving.fleet.router",
              "distributed", "distributed.checkpoint", "_sanitize",
              "configs.whisper_small", "kernels.flash_attention.ops",
              "kernels.flash_attention.ref", "kernels.decode_attention.ops",
              "models.blocks", "models.model", "models.moe",
              "configs.qwen2_moe_a2_7b", "kernels.grouped_gemm.ops",
              "kernels.grouped_gemm.ref", "configs.chatglm3_6b",
              "configs.internlm2_20b", "kernels.diag_b1_bits",
              "configs.deepseek_v2_lite_16b",
              "kernels.mla_decode_attention.ops",
              "kernels.mla_decode_attention.ref",
              "configs.command_r_plus_104b", "serving.engine",
              "examples.serve_hybrid", "core.schedule", "core.planner",
              "sim", "sim.engine", "sim.llm_perf", "sim.energy",
              "sim.baselines"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.serving.fleet.worker import main\n"
        "from repro_torch.serving.kv_cache import TieredPageAllocator\n"
        "from repro_torch.serving.fleet import wire\n"
        "from repro_torch import _sanitize\n"
        "a = TieredPageAllocator(4)\n"
        "wire._registry()\n"
        "armed = hasattr(a.hot, '_shadow')\n"
        "assert armed == _sanitize.enabled(), armed\n"
        "assert armed == ('tools.analysis.sanitize' in sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": SRC, "REPRO_SANITIZE": sanitize}
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
                                   "ecc_resilience", "fleet_client",
                                   "FleetRouter", "serve_fleet",
                                   "serve_socket_fleet", "worker",
                                   "ServingEngine", "serve_hybrid"])
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
        elif entry == "fleet_client":
            from repro_torch.serving.client import ServingClient
            ServingClient(cfg, params, workers=2)
        elif entry == "FleetRouter":
            from repro_torch.serving.fleet.router import FleetRouter
            FleetRouter.build_loopback(cfg, params, workers=2, spares=1)
        elif entry == "serve_fleet":
            from repro_torch.launch.serve import main
            main(["--requests", "1", "--workers", "2", "--spares", "1"])
        elif entry == "serve_socket_fleet":
            from repro_torch.launch.serve import main
            main(["--requests", "1", "--workers", "2", "--transport",
                  "socket"])
        elif entry == "worker":
            from repro_torch.serving.fleet.worker import main
            main(["--port", "0"])
        elif entry == "ServingEngine":
            from repro_torch.serving.engine import ServingEngine
            ServingEngine(cfg, params)
        elif entry == "serve_hybrid":
            from repro_torch.examples.serve_hybrid import main
            main([])
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
    # wave mode is ported: it serves, as the JAX engine does; an unknown
    # mode is refused
    eng = EngineCore(cfg, params, device="cpu", mode="wave")
    eng.add_request(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.run()
    assert eng.mode == "wave" and eng.stats.completed == 1
    with pytest.raises(ValueError):
        EngineCore(cfg, params, device="cpu", mode="lockstep")
    # the flash KV tier and the prefix cache are ported; an unknown tier
    # is refused as the JAX engine refuses it
    eng = EngineCore(cfg, params, device="cpu", kv_tier="flash",
                     flash_pages=4, prefix_cache=True)
    assert eng.allocator.flash_available == 4 and eng._px is not None
    with pytest.raises(ValueError):
        EngineCore(cfg, params, device="cpu", kv_tier="ssd")
    # int8 KV pools and chunk budgets are ported; an unknown pool dtype is
    # refused as the JAX engine refuses it
    eng = EngineCore(cfg, params, device="cpu", kv_dtype="int8",
                     scheduler=make_scheduler("fcfs", chunk_tokens=8))
    assert eng.kv_dtype == "int8" and eng.scheduler.chunk_tokens == 8
    with pytest.raises(ValueError):
        EngineCore(cfg, params, device="cpu", kv_dtype="fp8")
    # the overlapped loop and stochastic sampling are ported
    eng = EngineCore(cfg, params, device="cpu", overlap=True)
    eng.add_request(Request(rid=0, prompt=[1, 2],
                            sampling=SamplingParams(temperature=0.7)))
    # migration is ported: a queued request has no slot to snapshot
    with pytest.raises(KeyError):
        eng.snapshot_slot(0)
    assert Router([eng], migrate=True).migrate
    # fleet workers are ported: a client with workers= builds a loopback
    # fleet router (it raised before), and the driver serves --workers,
    # in wave mode too
    from repro_torch.launch.serve import main
    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.fleet.router import FleetRouter

    client = ServingClient(cfg, params, workers=2, spares=1, device="cpu")
    assert isinstance(client.router, FleetRouter)
    assert len(client.router.workers) == 2 and client.router.spares_left == 1
    client.router.close()
    main(["--mode", "wave", "--workers", "2", "--requests", "2",
          "--max-new", "2", "--device", "cpu"])
