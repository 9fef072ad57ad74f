"""The PyTorch port imports neither JAX, flax, pandas nor the JAX package.

Run in a fresh interpreter, so that what the test process already imported
does not count.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import mygenerativerecommenders_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_modules_import_no_jax_flax_pandas_or_jax_package():
    modules = _port_modules()
    assert len(modules) > 20  # every subpackage was walked
    script = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'pandas', 'mygenerativerecommenders_tpu'))\n"
        "print(repr(bad))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_real_data_modules_are_walked_and_the_port_holds_no_urllib():
    """The real-data slice's modules are among those imported above, and no
    source of the port can fetch anything: nothing downloads."""
    modules = set(_port_modules())
    for name in ("data.preprocessor", "data.dataset", "native", "cli.prepare_data",
                 "cli.predict", "cli.convert_ckpt"):
        assert f"{port.__name__}.{name}" in modules, name
    pkg = Path(port.__file__).parent
    sources = [p for p in pkg.rglob("*") if p.suffix in (".py", ".cpp", ".cu", ".cuh")]
    assert len(sources) > 20
    holding = [str(p.relative_to(pkg)) for p in sources if "urllib" in p.read_text()]
    assert holding == []
    assert not list((pkg / "native").glob("*.so"))  # built at first use, into _build/
