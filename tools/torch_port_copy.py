#!/usr/bin/env python3
"""Copy the JAX package's jax-free modules into the PyTorch port.

The port (``sonata_tpu_torch``) imports nothing of ``sonata_tpu``, so a
module it needs that does not use JAX is copied, not imported.  A copy is
the original with two mechanical edits, and nothing else:

- every dotted name ``sonata_tpu.x`` becomes ``sonata_tpu_torch.x``;
- the JAX package's change-history tags (the numbers of the pull requests
  and issues that wrote a passage) leave the comments, since the history
  they name is not the port's.

Run from the repository root to (re)write every copy::

    python3 tools/torch_port_copy.py

``tests/test_torch_isolation.py`` holds each copy equal to
:func:`port_text` of its original, so a copy edited by hand, or an
original changed without a new copy, fails there.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: each path names the original under ``sonata_tpu/`` and the copy under
#: ``sonata_tpu_torch/``
COPIES = tuple(
    [f"serving/{name}.py" for name in ("admission", "deadlines",
                                       "degradation", "faults", "scope",
                                       "sketches", "tracing")]
    + ["synth/batching.py", "synth/scheduler.py",
       "native/src/sonata_dsp.cpp"])

#: (pattern, replacement), applied in order after the re-pointing
_SCRUBS = (
    (r"PR-\d+ gave the serving stack counters and PR-\d+ gave it",
     "The serving stack had counters and"),
    (r"the PR-\d+ ", "the "),
    (r"\bPR-\d+ ", ""),
    (r" \(ISSUE \d+\)", ""),
    (r", ISSUE \d+\)", ")"),
)


def port_text(text: str) -> str:
    """The copy of a module whose source is ``text``."""
    text = re.sub(r"\bsonata_tpu\.", "sonata_tpu_torch.", text)
    for pattern, replacement in _SCRUBS:
        text = re.sub(pattern, replacement, text)
    return text


def main() -> int:
    for rel in COPIES:
        out = REPO / "sonata_tpu_torch" / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(port_text(
            (REPO / "sonata_tpu" / rel).read_text(encoding="utf-8")),
            encoding="utf-8")
        print(f"sonata_tpu/{rel} -> sonata_tpu_torch/{rel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
