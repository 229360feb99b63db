"""The port stands alone: it imports neither jax nor the JAX package, and
its verbatim copies of the JAX package's host modules stay in step with
their originals."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "zigflac_tpu_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)
# host modules the port copies (the JAX package's __init__ imports jax, so
# the machine with the card cannot import them from there)
COPIES = ["crc.py", "metadata.py", "metaedit.py", "native.py", "ogg.py", "wav.py",
          "utils/config.py", "utils/sndfile.py"]


def test_every_module_is_checked():
    """The checks below cover every module of the port, the LPC module, the
    decoder's modules, the multi-device modules and the metadata editor
    included."""
    assert {"zigflac_tpu_torch.ops.lpc", "zigflac_tpu_torch.ops.analyze",
            "zigflac_tpu_torch.ops.deposit", "zigflac_tpu_torch.decoder",
            "zigflac_tpu_torch.ops.synth", "zigflac_tpu_torch.parallel.mesh",
            "zigflac_tpu_torch.parallel.distributed",
            "zigflac_tpu_torch.metaedit"} <= set(PORT_MODULES)


def test_port_imports_without_jax():
    """In a fresh interpreter where jax cannot be imported, every module of
    the port imports, and none of them pulls in the JAX package."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(m == 'zigflac_tpu' or m.startswith('zigflac_tpu.') for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_no_absolute_import_of_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "zigflac_tpu"), f"{path}: imports {name}"


def _code_lines(text: str):
    """The module docstring's summary line, and every line after the
    docstring but the import lines."""
    lines = text.splitlines()
    doc = ast.parse(text).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return lines[0], [ln for ln in lines[doc.end_lineno:]
                      if not ln.lstrip().startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", COPIES)
def test_host_copies_stay_in_step(rel):
    """Every line of code and comment is the original's; the module
    docstring keeps its summary line and may word the rest for the port."""
    original = (ROOT / "zigflac_tpu" / rel).read_text()
    copy = (PORT / rel).read_text()
    assert _code_lines(copy) == _code_lines(original)
