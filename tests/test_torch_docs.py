"""Docs-freshness checks for the port, the counterpart of
``tests/test_docs.py``: every backticked ``src/repro_torch/...``,
``tests/test_torch_*.py`` or ``chip_smoke.py`` path in the README's port
section and in the verify skill exists on disk, and both say how to run
positcheck and the examples.
"""
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_PATH_RE = re.compile(r"`((?:src/repro_torch/[\w./-]*[\w-])|(?:tests/test_torch_\w+\.py)"
                      r"|chip_smoke\.py)")
PORT_HEADING = "## PyTorch / H100 port"


def _readme_port_section() -> str:
    text = (REPO / "README.md").read_text()
    start = text.index(PORT_HEADING)
    end = text.find("\n## ", start + len(PORT_HEADING))
    return text[start:] if end < 0 else text[start:end]


DOCS = {"README port section": _readme_port_section,
        "verify skill": lambda: (REPO / ".claude" / "skills" / "verify" / "SKILL.md").read_text()}


@pytest.mark.parametrize("doc", list(DOCS))
def test_every_port_path_named_exists(doc):
    paths = sorted(set(_PATH_RE.findall(DOCS[doc]())))
    assert any(p.startswith("src/repro_torch/") for p in paths), "parser broken?"
    missing = [p for p in paths if not (REPO / p).exists()]
    assert not missing, f"{doc} names paths that do not exist: {missing}"


@pytest.mark.parametrize("doc", list(DOCS))
def test_doc_says_how_to_run_positcheck_and_the_examples(doc):
    text = " ".join(DOCS[doc]().split())        # commands wrap across lines
    assert "python -m repro_torch.analysis" in text and "--list-rules" in text
    for name in ("quickstart", "posit_convolution", "serve_posit_kv",
                 "gradient_compression", "train_lm", "elastic_restart"):
        assert name in text, name
    assert "repro_torch.examples" in text and "--phase examples" in text
