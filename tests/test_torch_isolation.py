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
                   "sonata_tpu_torch/parallel/mesh.py",
                   "sonata_tpu_torch/parallel/ring.py",
                   "sonata_tpu_torch/parallel/checkpoint.py",
                   "sonata_tpu_torch/models/seq_parallel.py",
                   "sonata_tpu_torch/frontends/mesh_server.py",
                   "sonata_tpu_torch/serving/fleetcache.py",
                   "sonata_tpu_torch/serving/fleetscope.py",
                   "sonata_tpu_torch/testing.py",
                   "sonata_tpu_torch/models/tashkeel_train.py",
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
        "sonata_tpu_torch.pysonata, sonata_tpu_torch.serving.replicas, "
        "sonata_tpu_torch.parallel, sonata_tpu_torch.models.seq_parallel, "
        "sonata_tpu_torch.frontends.mesh_server, "
        "sonata_tpu_torch.serving.fleetcache, "
        "sonata_tpu_torch.serving.fleetscope, sonata_tpu_torch.testing, "
        "sonata_tpu_torch.models.tashkeel_train\n"
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
    assert '"sonata_tpu_torch.frontends" = ["proto/*.proto"]' in text
    assert (PORT / "frontends" / "proto" / "sonata_grpc.proto").is_file()
    for rel in ("src/sonata_dsp.cpp", "src/sonata_capi.cpp",
                "include/libsonata_tpu.h"):
        assert (PORT / "native" / rel).is_file()
    for script, target in (
            ("sonata-tpu-torch", "sonata_tpu_torch.frontends.cli:main"),
            ("sonata-tpu-torch-grpc",
             "sonata_tpu_torch.frontends.grpc_server:main"),
            ("sonata-tpu-torch-mesh",
             "sonata_tpu_torch.frontends.mesh_server:main")):
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


#: files of the JAX package the port has no counterpart for, each with
#: its reason
NOT_PORTED = {
    "utils/jax_cache.py": "JAX's persistent compilation cache and AOT "
                          "executable store: the port runs eagerly and "
                          "compiles nothing ahead of time",
}


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port is complete: each file of ``sonata_tpu/`` (sources, the
    proto, the native sources and the bundled data; not build products)
    has a file at the same path under ``sonata_tpu_torch/``, apart from
    :data:`NOT_PORTED`."""
    jax_pkg = REPO / "sonata_tpu"
    files = sorted(
        str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts
        and p.suffix in (".py", ".proto", ".cpp", ".h", ".npz"))
    assert "parallel/mesh.py" in files and len(files) > 100
    missing = [f for f in files
               if f not in NOT_PORTED and not (PORT / f).is_file()]
    assert not missing, f"no counterpart in sonata_tpu_torch/: {missing}"
    for f in NOT_PORTED:
        assert (jax_pkg / f).is_file(), f"{f} left the JAX package"
        assert not (PORT / f).exists(), f"{f} is ported now"


#: public names of the JAX package the port's counterpart module does not
#: define, each with its reason or the port's counterpart
_INITS = "the port draws random trees with weights.random_tree"
NOT_PORTED_NAMES = {
    "ops/gate.py::fused_gate_pallas": "the Pallas kernel: csrc/gate.cu, "
                                      "launched by ops/gate.py::fused_gate",
    "models/modules.py::init_layer_norm": _INITS,
    "models/modules.py::init_rel_attention": _INITS,
    "models/modules.py::init_ffn": _INITS,
    "models/modules.py::init_transformer": _INITS + " (_Init.transformer)",
    "models/modules.py::init_wn": _INITS,
    "models/modules.py::init_dds_conv": _INITS + " (_Init.dds_conv)",
    "models/vits.py::init_text_encoder": _INITS,
    "models/vits.py::init_duration_predictor": _INITS,
    "models/vits.py::init_flow": _INITS,
    "models/vits.py::init_generator": _INITS,
    "models/vits.py::init_vits": _INITS,
    "models/modules.py::conv_transpose1d_subpixel": (
        "an MXU lowering of the transposed conv, on purpose: the port "
        "calls cuDNN's conv_transpose1d"),
    "utils/dispatch_policy.py::should_donate": (
        "XLA buffer donation; torch has no donation"),
    "models/tashkeel_cbhg.py::apply_cbhg": (
        "the CBHG forward is TashkeelCBHGTagger.forward"),
    "models/modules.py::Params": "a JAX pytree alias; the port's "
                                 "parameters are nn.Modules",
    "models/vits.py::Params": "a JAX pytree alias",
    "models/seq_parallel.py::Params": "a JAX pytree alias",
    "native/build.py::native_dir": (
        "the JAX package's in-tree build directory; the port builds under "
        "build/sonata_tpu_torch (ops/_build.py::BUILD_ROOT)"),
}


def _public_names(path: Path) -> list:
    """Top-level public functions, classes and assigned names of a module,
    and each public method of its classes as ``Class.method``."""
    out = []
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{n.name}" for n in node.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not n.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [t.id for t in targets if isinstance(t, ast.Name)
                    and not t.id.startswith("_")]
    return out


def _defined_names(path: Path) -> set:
    """Every name a module binds at top level (imports included) and each
    method of its classes as ``Class.method``."""
    names = set()
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{n.name}" for n in node.body
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in node.names}
    return names


def test_every_public_name_has_a_counterpart():
    """The port is complete by name: every public function, class, method
    and module-level name of each ``sonata_tpu/`` module exists under the
    same name in its counterpart under ``sonata_tpu_torch/``, apart from
    :data:`NOT_PORTED_NAMES` (whose entries must still be missing, and
    still be in the JAX package)."""
    jax_pkg = REPO / "sonata_tpu"
    missing, seen = [], set()
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = str(path.relative_to(jax_pkg))
        if rel in NOT_PORTED:
            continue
        defined = _defined_names(PORT / rel)
        for name in _public_names(path):
            key = f"{rel}::{name}"
            if key in NOT_PORTED_NAMES:
                seen.add(key)
                assert name not in defined, f"{key} is ported now"
            elif name not in defined:
                missing.append(key)
    assert not missing, f"no counterpart in sonata_tpu_torch/: {missing}"
    assert seen == set(NOT_PORTED_NAMES), \
        f"gone from the JAX package: {set(NOT_PORTED_NAMES) - seen}"
