"""The unit scenarios of a JAX-package test module, run against the port.

The router tier's modules (``frontends/mesh_server.py``,
``serving/fleetcache.py``, ``serving/fleetscope.py`` and the serving
modules they stand on) are scripted copies: the JAX original with its
``sonata_tpu.`` names re-pointed by ``tools/torch_port_copy.py``.  Their
tests are ported the same way: :func:`exec_ported` takes the original test
module's source up to its integration section (whose servers load voices
on the default device), re-points it with the copy tool's
:func:`port_text`, and executes it into the calling test module, so every
scenario runs unchanged against the port's modules and is collected there
under its own name.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def _copy_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_copy", REPO / "tools" / "torch_port_copy.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def ported_source(name: str) -> str:
    """Test module ``name`` re-pointed at the port, cut before the comment
    block whose title starts ``# integration``."""
    lines = (TESTS / name).read_text(encoding="utf-8").splitlines(True)
    for i, line in enumerate(lines):
        if line.startswith("# integration"):
            lines = lines[:max(i - 1, 0)]
            break
    text = _copy_tool().port_text("".join(lines))
    assert "sonata_tpu." not in text.replace("sonata_tpu_torch.", "")
    return text


def exec_ported(name: str, namespace: dict) -> None:
    """Execute the ported unit part of ``name`` into ``namespace`` (a test
    module's globals)."""
    code = compile(ported_source(name), str(TESTS / name), "exec")
    exec(code, namespace)  # noqa: S102 - the repo's own test source
