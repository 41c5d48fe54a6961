"""The port stands alone: every ``repro_torch`` module and ``chip_smoke.py``
import with ``jax`` and ``repro`` unavailable, and no source of theirs
names either package in an import."""
import ast
import pathlib
import subprocess
import sys

from conftest import subprocess_env

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
_FORBIDDEN = ("jax", "jaxlib", "repro")

_WALK = """
import importlib, importlib.abc, importlib.util, pathlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
root = pathlib.Path(sys.argv[1])
names = set()
for p in sorted(root.rglob("*.py")):
    parts = ("repro_torch",) + p.relative_to(root).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    names.add(".".join(parts))
failed = []
for name in sorted(names):
    try:
        importlib.import_module(name)
    except Exception as e:  # noqa: BLE001 -- report every broken module
        failed.append(f"{name}: {type(e).__name__}: {e}")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
try:
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
except Exception as e:  # noqa: BLE001
    failed.append(f"chip_smoke.py: {type(e).__name__}: {e}")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(f"IMPORTED {len(names)}")
print("NAMES " + " ".join(sorted(names)))
if failed or leaked:
    print("\\n".join(failed + [f"leaked: {m}" for m in leaked]))
    sys.exit(1)
"""


def test_port_imports_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _WALK, str(PORT),
                           str(SMOKE)], capture_output=True, text=True,
                          timeout=300, env=subprocess_env())
    assert proc.returncode == 0, (
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    assert int(proc.stdout.split("IMPORTED")[1].split()[0]) >= 25
    names = set(proc.stdout.split("NAMES")[1].split())
    # the tiering, resilience and observability modules are in the walk
    assert {"repro_torch.serving.faults", "repro_torch.serving.resilience",
            "repro_torch.serving.memory.tiered",
            "repro_torch.serving.memory.prefix_store",
            "repro_torch.obs.trace", "repro_torch.obs.recompile",
            "repro_torch.obs.schema"} <= names
    # and the training path's
    assert {"repro_torch.data.pipeline", "repro_torch.train.optimizer",
            "repro_torch.train.train_loop", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.core.tree"} <= names


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in _FORBIDDEN]
    assert not bad, "\n".join(bad)
