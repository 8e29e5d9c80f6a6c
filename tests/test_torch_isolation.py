"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no file of it (nor chip_smoke.py) imports either."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "instructany2pix_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "instructany2pix_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return [
        "instructany2pix_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"
    ]


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "import instructany2pix_tpu_torch\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_file_imports_jax():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20
