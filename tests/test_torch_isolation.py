"""The PyTorch port stands alone: nothing in ``sonata_tpu_torch/`` or in
``chip_smoke.py`` (nor the port's tools: ``tools/torch_kernel_ab.py`` and
``tools/torch_stream_timeline.py``, which run beside it on the card, and
``tools/torch_port_copy.py``) imports jax or the JAX package.

jax is checked by an AST scan, not through ``sys.modules``: a host may
import jax at interpreter start-up on its own.  The JAX package is checked
both ways.
"""

import ast
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sonata_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "torch_kernel_ab.py",
        REPO / "tools" / "torch_stream_timeline.py",
        REPO / "tools" / "torch_port_copy.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "sonata_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_sonata_tpu_import(path):
    bad = [(line, name) for line, name in _imported_modules(path)
           if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_package():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for needed in ("sonata_tpu_torch/models/vits.py",
                   "sonata_tpu_torch/models/piper.py",
                   "sonata_tpu_torch/ops/gate.py",
                   "sonata_tpu_torch/synth/synthesizer.py",
                   "sonata_tpu_torch/text/tashkeel.py",
                   "sonata_tpu_torch/models/tashkeel_cbhg.py",
                   "sonata_tpu_torch/models/import_onnx.py",
                   "sonata_tpu_torch/text/rule_g2p_de.py",
                   "sonata_tpu_torch/serving/scope.py",
                   "sonata_tpu_torch/synth/batching.py",
                   "sonata_tpu_torch/synth/scheduler.py",
                   "sonata_tpu_torch/synth/output.py",
                   "sonata_tpu_torch/native/build.py",
                   "sonata_tpu_torch/utils/dispatch_policy.py",
                   "sonata_tpu_torch/serving/replicas.py",
                   "sonata_tpu_torch/serving/__init__.py",
                   "sonata_tpu_torch/frontends/grpc_server.py",
                   "sonata_tpu_torch/frontends/cli.py",
                   "sonata_tpu_torch/frontends/capi_bridge.py",
                   "sonata_tpu_torch/pysonata.py",
                   "chip_smoke.py"):
        assert needed in files
    assert _forbidden("jax.numpy") and _forbidden("sonata_tpu.models")
    assert not _forbidden("sonata_tpu_torch.models")


def test_importing_the_port_leaves_the_jax_package_unloaded():
    """Neither the JAX package nor jax enters ``sys.modules`` through an
    import of the port (modules the interpreter held before it, as a host
    that imports jax at start-up would, do not count)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import sonata_tpu_torch, sonata_tpu_torch.models, "
        "sonata_tpu_torch.synth, sonata_tpu_torch.text, "
        "sonata_tpu_torch.ops, sonata_tpu_torch.models.decode_opts, "
        "sonata_tpu_torch.text.tashkeel, "
        "sonata_tpu_torch.models.tashkeel_cbhg, "
        "sonata_tpu_torch.models.import_onnx, sonata_tpu_torch.serving, "
        "sonata_tpu_torch.synth.batching, sonata_tpu_torch.synth.scheduler, "
        "sonata_tpu_torch.synth.output, sonata_tpu_torch.native, "
        "sonata_tpu_torch.utils.dispatch_policy, "
        "sonata_tpu_torch.utils.profiling, "
        "sonata_tpu_torch.frontends.grpc_server, "
        "sonata_tpu_torch.frontends.cli, "
        "sonata_tpu_torch.frontends.capi_bridge, "
        "sonata_tpu_torch.pysonata, sonata_tpu_torch.serving.replicas\n"
        "bad = [m for m in set(sys.modules) - before "
        "if m in ('sonata_tpu', 'jax') "
        "or m.startswith(('sonata_tpu.', 'jax.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_sources_ship_with_the_package():
    from sonata_tpu_torch.ops import _build

    for name in _build.SOURCES:
        assert (PORT / "csrc" / name).is_file()
    text = (REPO / "pyproject.toml").read_text(encoding="utf-8")
    assert '"sonata_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh", ' \
        '"data/*.npz"]' in text
    assert '"sonata_tpu_torch.native" = ["src/*.cpp", "include/*.h"]' \
        in text
    for rel in ("src/sonata_dsp.cpp", "src/sonata_capi.cpp",
                "include/libsonata_tpu.h"):
        assert (PORT / "native" / rel).is_file()
    for script, target in (
            ("sonata-tpu-torch", "sonata_tpu_torch.frontends.cli:main"),
            ("sonata-tpu-torch-grpc",
             "sonata_tpu_torch.frontends.grpc_server:main")):
        assert f'{script} = "{target}"' in text


def _copy_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_copy", REPO / "tools" / "torch_port_copy.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("rel", _copy_tool().COPIES)
def test_scripted_copy_equals_its_original(rel):
    """A copied jax-free module is its JAX original with the
    ``sonata_tpu.`` names re-pointed (``tools/torch_port_copy.py``), and
    nothing else: neither side drifted since the copy was made."""
    tool = _copy_tool()
    original = (REPO / "sonata_tpu" / rel).read_text(encoding="utf-8")
    copy = (PORT / rel).read_text(encoding="utf-8")
    assert copy == tool.port_text(original)
    # a dotted name of the JAX package (``libsonata_tpu.h`` is a file)
    assert not re.search(r"\bsonata_tpu\.", copy)


def test_copy_tool_repoints_names_only():
    tool = _copy_tool()
    text = ("from sonata_tpu.serving import tracing\n"
            "x = 'sonata_tpu_torch.synth'  # sonata_tpu_x stays\n")
    assert tool.port_text(text) == (
        "from sonata_tpu_torch.serving import tracing\n"
        "x = 'sonata_tpu_torch.synth'  # sonata_tpu_x stays\n")
