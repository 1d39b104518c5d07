"""shadow_tpu_torch stands alone: no JAX, no shadow_tpu, no CPU fallback.

- importing the package, and loading chip_smoke.py, in a fresh
  interpreter puts neither `jax` nor `shadow_tpu` in sys.modules;
- no source file of the package, nor chip_smoke.py, imports them;
- the entry points default to CUDA and, with no card, raise instead of
  running on the CPU; so do a mesh's ranks, whose backend is chosen and
  never tried (a rank started by `parallel.mesh.spawn` imports no JAX
  either).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.models import phold as tphold

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "shadow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "shadow_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib.util\n"
        "import shadow_tpu_torch.convert, shadow_tpu_torch.models.phold\n"
        "import shadow_tpu_torch.sim, shadow_tpu_torch.transport.stack\n"
        "import shadow_tpu_torch.models.phold_net\n"
        "import shadow_tpu_torch.models.tor, shadow_tpu_torch.models.bitcoin\n"
        "import shadow_tpu_torch.runtime.pressure\n"
        "import shadow_tpu_torch.faults\n"
        "import shadow_tpu_torch.obs.trace, shadow_tpu_torch.obs.stats\n"
        "import shadow_tpu_torch.obs.profiler\n"
        "import shadow_tpu_torch.runtime.invariants\n"
        "import shadow_tpu_torch.tools.export_trace\n"
        "import shadow_tpu_torch.tools.critical_path\n"
        "import shadow_tpu_torch.transport.cbrt\n"
        "import shadow_tpu_torch.cli, shadow_tpu_torch.utils.checkpoint\n"
        "import shadow_tpu_torch.utils.tracker\n"
        "import shadow_tpu_torch.utils.logger\n"
        "import shadow_tpu_torch.runtime.harvest\n"
        "import shadow_tpu_torch.runtime.supervisor\n"
        "import shadow_tpu_torch.obs.metrics, shadow_tpu_torch.obs.server\n"
        "import shadow_tpu_torch.tools.strip_log\n"
        "import shadow_tpu_torch.utils.pcap\n"
        "import shadow_tpu_torch.runtime.adaptive\n"
        "import shadow_tpu_torch.tools.parse_shadow\n"
        "import shadow_tpu_torch.tools.plot_shadow\n"
        "import shadow_tpu_torch.tools.check_openmetrics\n"
        "import shadow_tpu_torch.tools.diff_runs\n"
        "import shadow_tpu_torch.tools.convert_config\n"
        "import shadow_tpu_torch.tools.generate_config\n"
        "import shadow_tpu_torch.tools.generate_topology\n"
        "import shadow_tpu_torch.parallel.mesh\n"
        "import shadow_tpu_torch.parallel.partition\n"
        "import shadow_tpu_torch.runtime.fleet\n"
        "import shadow_tpu_torch.serve, shadow_tpu_torch.serve.http\n"
        "import shadow_tpu_torch.serve.service\n"
        "import shadow_tpu_torch.serve.packer, shadow_tpu_torch.serve.cache\n"
        "import shadow_tpu_torch.serve.chaos\n"
        "import shadow_tpu_torch.obs.servetrace\n"
        "import shadow_tpu_torch.tools.serve_client\n"
        "import shadow_tpu_torch.tools.serve_report\n"
        "import shadow_tpu_torch.proc, shadow_tpu_torch.proc.native\n"
        "import shadow_tpu_torch.proc.model, shadow_tpu_torch.proc.tier\n"
        "spec = importlib.util.spec_from_file_location("
        "'chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_imports_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: {name}"


def test_spawned_ranks_import_no_jax():
    """A rank started by `parallel.mesh.spawn` (a fresh interpreter)
    imports the sharded port and the JAX-free harness, and no JAX."""
    from shadow_tpu_torch.parallel import mesh as pmesh
    import torch_shard_harness as harness

    bad = pmesh.spawn(harness.modules_rank, 2, backend="gloo",
                      device="cpu", args=(FORBIDDEN,),
                      timeout_s=harness.SPAWN_TIMEOUT_S)
    assert bad == []


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tphold.build(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.resolve_device(None)
    cfg = tconfig.parse_config(texamples.phold_example(8, 1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.build_simulation(cfg)
    assert tengine.resolve_device("cpu") == torch.device("cpu")
    tsim.build_simulation(cfg, device="cpu")
    # the command line too: without `device=` it runs on CUDA or raises
    from shadow_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--test", "--stoptime", "1"])
    # the serving plane too: the service, its oracle and `serve`
    from shadow_tpu_torch.serve import SimService, solo_reference

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solo_reference({"model": "phold", "params": {"hosts": 4},
                        "stop_s": 0.1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--port", "0"])
    # a mesh too: its ranks run on CUDA unless told the CPU, and the
    # backend is chosen, never tried: NCCL is refused for CPU ranks
    from shadow_tpu_torch.parallel import mesh as pmesh

    assert pmesh.default_backend("cuda") == "nccl"
    assert pmesh.default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.rank_device(0, None, "nccl")
    import torch_shard_harness as harness

    with pytest.raises(ValueError, match="NCCL runs CUDA ranks only"):
        pmesh.spawn(print, 1, backend="nccl", device="cpu",
                    timeout_s=harness.SPAWN_TIMEOUT_S)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory (and here, with no card) the script exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
